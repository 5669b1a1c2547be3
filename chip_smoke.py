#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynamicpdb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-cards   # data parallel over every card (NCCL)

Phases, each printing its own lines:
  0. setup: the card's name and power limit (nvidia-smi), device checks;
  1. build: every kernel source under dynamicpdb_tpu_torch/csrc, one nvcc
     each, all started together, with ptxas's registers and spills; the
     machine code of the GeoFormer kernels, the IPA forward and the three
     IPA backward kernels must hold tensor-core instructions (cuobjdump
     -sass);
  2. kernels: the IPA forward and its three backward kernels against their
     plain PyTorch versions on the card, at the release widths and N = 5,
     16, 203, 256 and 611, at the tiny width, and with the first key tile
     all pad (the backward with cotangents zero on pad rows and with
     cotangents everywhere), the autograd Function against dense autograd,
     with errors, tolerances and times; then the same at three cases past
     the tensor-core kernels' widths ("wide": C 384, Pq 12, Pv 18, Dz 64,
     4 heads; "wide-dz": Dz 64; "wide-model": phase 4b's widths and
     window, C 384, Pq 12, Dz 64, N 256), which must run the wide route's
     CUDA-core kernels (their launch counters move, the tensor-core ones do
     not);
  3. serve: the release-width model with seeded random weights is saved,
     loaded by serve_cli and driven over HTTP (healthz + 4 rollouts), with
     the kernel launch counts of that run checked against the model's
     structure; then the same path at a small width on the card and on the
     CPU, which must agree;
  3c. batched rollout: sampling/reverse.batched_rollout over two windows
     (256 and 200 residues padded to 256) at release width, 2 frames, full
     sampler and fast_x0, each trajectory against rollout on its window,
     the IPA forward launches checked;
  3d. Picard: sampling/picard.picard_reverse_sample on a 256-residue
     window at release width, num_t 10, tol 0, 9 sweeps, against
     reverse_sample on the same noise (the last sweep's chain and the
     prediction), its (9 x 9 + 1) forwards' IPA launches checked, both
     timed;
  4. train: one loss and backward at a small width with randomised weights
     on the card and on the CPU (every gradient must agree, every IPA
     projection's must be nonzero); then train_cli at release width
     (configs/release.yaml, B=8, remat, bfloat16) for 3 steps on two
     synthetic trajectories, fed by the prefetcher (data/prefetch.py):
     every batch the steps received on the card must equal the plain
     iterator's on the host, in order, no prefetcher thread may outlive
     train_cli, each steady step's wait for its batch is printed; the
     launch counts of that run checked, and serve_cli answering one
     request from the checkpoint it wrote;
  4b. wide: one IPA block at c_z 256, c_hidden 384, no_qk_points 12 with
     randomised weights, gradients on the card against the CPU; then that
     model at release depth trained 3 steps (B = 2) by train_cli and served
     by serve_cli, every IPA launch on the wide route;
  6. eval (run after phase 4, on its checkpoint): eval_cli over the two
     proteins (every metric finite, the IPA launches per protein checked),
     eval_cli --extension 4 --save-dcd (the DCD read back), and evaluate
     one protein at a time, plain and with classifier-free guidance and
     aux_traj, for the seconds per protein;
  6b. eval card vs CPU: a small model with seeded random weights (guidance
     on, EMA kept) trained one step on the CPU on trajectories whose
     residues rotate, eval_cli --ema on both devices (rows must agree),
     and --ref-ckpt on a reference-format file of the same EMA weights
     (rows must equal --ema's);
  5. extract: a seeded random OmegaFold at release width and depth (795M
     parameters) saved to a temporary checkpoint (3.2 GB) and run by the
     extraction CLI on two sequences (256 and 203 residues, padded to
     multiples of 32, 10 cycles, 15 pseudo-MSA rows), every npz checked
     against the DFOLD contract and the launch counts of both GeoFormer
     attention kernels checked; then the same CLI at release width and a
     reduced depth on the card and on the CPU, which must agree and select
     the same cycle, and in bfloat16 on the card against float32;
  7. fold: fold_cli with phase 5's checkpoint on two sequences (256 and
     203 residues, padded to multiples of 32, 3 cycles): PDB files that
     read back with the sequences, B-factors = pLDDT x 100, sidecars, the
     launch counts of both GeoFormer kernels, seconds per sequence and per
     cycle; then fold_cli.fold at release width and a reduced depth on the
     card and on the CPU: pos14, pLDDT, confidences and the selected cycle
     must agree.
  8. data parallel (run after phase 6, on phase 4's manifest and against
     its one process at B = 8): 8a, tools/dp_step.py on two ranks started
     by torch.distributed.run, joined with gloo and sharing cuda:0 (NCCL
     refuses two ranks on one card), B = 4 each, ZeRO on, 3 steps: both
     ranks' parameters equal, their parameters, gathered AMSGrad moments,
     losses and grad norms within the stated bounds of one process's, each
     rank's IPA launches those of its 4 windows (32 forward and 16 of each
     backward kernel a step); 8b, the same with ZeRO off, whose parameters
     must equal 8a's bit for bit; 8c, train_cli under the launcher at world
     1 on NCCL with experiment.mesh_shape=(1,) for 2 steps, whose
     checkpoint must equal a run without a launcher bit for bit; 8d, two
     ranks on a (1, 2) ('data', 'model') mesh at B = 8, bit-equal to phase
     4 and within the bounds of 8a; each rank's step and all-reduce
     seconds, peak memory and the memory its parameters and optimizer
     state hold between steps printed.
Phase 2 also holds both GeoFormer attention kernels against their plain
versions (release, ragged and long ragged L, float32 and bfloat16) and
times them beside their bounds and torch's SDPA on the same attention
core. Every kernel report carries two bounds: bound_ms with every
operation on the CUDA cores in float32, tc_bound_ms with the products on
the TF32 tensor cores in three passes (bounds()).
The line before the last is the kernel report (launches: the tensor-core
IPA kernels' from the release training run, the wide ones' from the wide
training run, the GeoFormer kernels' from the extraction run; the IPA
forward's report adds those of serving, batched rollout, Picard and eval,
the GeoFormer kernels' those of fold_cli; errors and times at the same
shapes),
the last line {"ok": true, "device": {...}}. Any failed check exits
nonzero; with no CUDA device, or without the package beside it, the script
exits 1 and prints no result.
"""
from __future__ import annotations

import faulthandler
import glob
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RELEASE_OVERRIDES = [
    # configs/release.yaml at the serving shapes; the dataclass defaults
    # carry the rest of it (c_s 256, c_z 128, c_hidden 256, 8 heads, 8/12
    # points, 4 blocks, frame_time 2, num_t 10, max_len 256)
    "model.compute_dtype=bfloat16",
    f"diffuser.so3.cache_dir={os.path.join(ROOT, '.cache', 'igso3')}",
]
# small width for the card-against-CPU check and the CPU rehearsal
SMALL_OVERRIDES = [
    "model.node_embed_size=16", "model.edge_embed_size=8",
    "model.node_repr_dim=32", "model.edge_repr_dim=16",
    "model.ipa.c_s=16", "model.ipa.c_z=8", "model.ipa.c_hidden=8",
    "model.ipa.no_heads=2", "model.ipa.no_qk_points=2",
    "model.ipa.no_v_points=3", "model.ipa.num_blocks=2",
    "diffuser.so3.num_omega=100", "diffuser.so3.num_sigma=50",
    "diffuser.so3.series_L=100",
    f"diffuser.so3.cache_dir={os.path.join(ROOT, '.cache', 'igso3')}",
]

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 on the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
TC_PASSES = 3  # 3xTF32: the passes a product needs to keep float32 accuracy


def bounds(ops: float, ew_ops: float, nbytes: float) -> dict:
    """The least time (ms) the card could take for the work: the float32
    bound (every operation on the CUDA cores) and the tensor-core bound (the
    products, ops - ew_ops, in TC_PASSES TF32 passes on the tensor cores,
    the elementwise operations on the CUDA cores), each the larger of its
    arithmetic time and bytes / the memory rate, with what bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_f32 = ops / PEAK_F32_FLOPS * 1e3
    t_tc = ((ops - ew_ops) * TC_PASSES / PEAK_TF32_FLOPS
            + ew_ops / PEAK_F32_FLOPS) * 1e3
    return {
        "bound_ms": max(t_f32, t_bytes),
        "bound_by": "operations" if t_f32 >= t_bytes else "bytes",
        "tc_bound_ms": max(t_tc, t_bytes),
        "tc_bound_by": "operations" if t_tc >= t_bytes else "bytes",
    }


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_mma_counts(nvcc: str, library: str) -> dict:
    """{kernel function: tensor-core instructions (HMMA or HGMMA)} in the
    machine code of ``library``, as cuobjdump -sass prints it."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def ipa_inputs(torch, device, *, F=2, N=256, H=8, C=256, Pq=8, Pv=12, Dz=32,
               masked=56, lead_masked=0, seed=0):
    """Seeded IPA inputs; the last ``masked`` and the first ``lead_masked``
    residues are pad (mask 0)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    mask = torch.ones((F, N), device=device)
    if masked:
        mask[:, N - masked:] = 0.0
    mask[:, :lead_masked] = 0.0
    args = (rnd(F, N, H, C), rnd(F, N, H, C), rnd(F, N, H, C),
            rnd(F, N, H, Pq, 3, scale=2.0), rnd(F, N, H, Pq, 3, scale=2.0),
            rnd(F, N, H, Pv, 3, scale=2.0), rnd(N, N, H), rnd(N, N, Dz), mask,
            0.05 + 0.1 * torch.rand((H,), generator=g, device=device))
    return args, math.sqrt(1.0 / (3 * C))


def ipa_cost(F, N, H, C, Pq, Pv, Dz):
    """(operations, bytes, elementwise operations) the forward must do and
    move: the five contractions (2 per multiply-add) plus ~12 elementwise
    operations per logit; each input read once, each output written once,
    float32."""
    ops = F * H * N * N * (2 * C + 2 * 3 * Pq + 2 * C + 2 * 3 * Pv + 2 * Dz + 12)
    n_in = 3 * F * N * H * C + 2 * F * N * H * Pq * 3 + F * N * H * Pv * 3 \
        + N * N * H + N * N * Dz + F * N + H
    n_out = F * N * H * C + F * N * H * Pv * 3 + F * N * H * Dz + F * H * N
    return ops, 4 * (n_in + n_out), F * H * N * N * 12


def ipa_bwd_cost(F, N, H, C, Pq, Pv, Dz):
    """{kernel: (operations, bytes, elementwise operations)} of the three
    backward kernels: each recomputes the tile (the forward's logit terms,
    ~12 elementwise operations, then ds = g_o.v + g_opt.vp + g_pair.pz and
    dl, 2 per multiply-add, and 2 elementwise) and adds its own sums and
    elementwise steps; each reads the 15 backward inputs once and writes its
    outputs once, float32."""
    P3q, P3v = 3 * Pq, 3 * Pv
    recompute = (2 * C + 2 * P3q + 12) + (2 * C + 2 * P3v + 2 * Dz) + 2
    per_elem = {
        "ipa_attention_bwd_dq": recompute + 2 * C + 2 * P3q + 4,
        "ipa_attention_bwd_dkv": recompute + 2 * C + 2 * P3q + 1 + 2 * C
        + 2 * P3v,
        "ipa_attention_bwd_pair": recompute + 2 * Dz + 1,
    }
    n_in = 4 * F * N * H * C + 2 * F * N * H * P3q + 2 * F * N * H * P3v \
        + N * N * H + N * N * Dz + F * N + H + 2 * F * H * N + F * N * H * Dz
    n_out = {
        "ipa_attention_bwd_dq": F * N * H * C + F * N * H * P3q + F * H * N,
        "ipa_attention_bwd_dkv": 2 * F * N * H * C + F * N * H * P3q
        + F * N * H * P3v,
        "ipa_attention_bwd_pair": N * N * H + N * N * Dz,
    }
    ew = {"ipa_attention_bwd_dq": 14 + 4, "ipa_attention_bwd_dkv": 14 + 1,
          "ipa_attention_bwd_pair": 14 + 1}
    return {k: (F * H * N * N * per_elem[k], 4 * (n_in + n_out[k]),
                F * H * N * N * ew[k]) for k in per_elem}


BWD_GRADS = ("dq", "dk", "dv", "dqp", "dkp", "dvp", "dbias", "dpz", "dhw")
# Float32 on both sides with the same saved lse and D, sums over up to N*C
# terms taken in another order: the JAX package's gradient bar (2e-4,
# tests/test_pallas_ipa.py) relative to each gradient's largest magnitude.
BWD_RTOL = 2e-4
# A pad query row's logits sit near -inf = -1e5, where float32 steps by
# 2^-7, so its a_ij = exp(l - lse) differs between two implementations by
# up to 2 x 2^-7 relative (as in the forward's ipa_errors). With nonzero
# cotangents on pad rows that error reaches every gradient that sums over
# query rows (dk, dv, dkp, dvp, dbias, dpz, dhw) and the pad rows' own dq
# and dqp: on top of BWD_RTOL, each gradient may be off by 2 x 2^-7 of the
# sum of the absolute values of its pad-row terms (ipa_bwd_pad_scale).
BWD_PAD_RTOL = 2 * 2.0 ** -7


def ipa_bwd_inputs(torch, args, c_qk, *, zero_pad: bool, seed: int):
    """Forward (the kernel on the card), seeded random cotangents for o,
    o_pt and o_pair (zeroed on pad query rows when ``zero_pad``), and the
    15 inputs of the backward kernels."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    out = ipa_mod.ipa_attention_fwd(*args, c_qk)
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    mask = args[8]
    cots = []
    for o in out[:3]:
        c = torch.randn(o.shape, generator=g, device=o.device)
        if zero_pad:
            c = c * mask.reshape(mask.shape + (1,) * (c.dim() - 2))
        cots.append(c)
    return ipa_mod.backward_inputs(tuple(args) + tuple(out), *cots), cots


def ipa_bwd_grads(torch, inputs, c_qk, plain: bool) -> dict:
    """The nine gradients from the three backward kernels (or their plain
    versions), dhw reduced over frames and rows as the Function does."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    kw = dict(c_qk=c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5)
    if plain:
        fns = (ipa_mod.ipa_bwd_dq_plain, ipa_mod.ipa_bwd_dkv_plain,
               ipa_mod.ipa_bwd_pair_plain)
    else:
        fns = (ipa_mod.ipa_attention_bwd_dq, ipa_mod.ipa_attention_bwd_dkv,
               ipa_mod.ipa_attention_bwd_pair)
    dq, dqp, dhw_rows = fns[0](*inputs, **kw)
    dk, dkp, dv, dvp = fns[1](*inputs, **kw)
    dbias, dpz = fns[2](*inputs, **kw)
    return dict(dq=dq, dk=dk, dv=dv, dqp=dqp, dkp=dkp, dvp=dvp, dbias=dbias,
                dpz=dpz, dhw=torch.sum(dhw_rows, dim=(0, 2)))


def ipa_bwd_pad_scale(torch, inputs, c_qk) -> dict:
    """Per gradient, the largest sum of the absolute values of its pad-row
    terms: the plain backward's sums with every operand taken absolute and
    a, dl restricted to pad query rows."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    kw = dict(c_qk=c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5)
    a, dl, dist = ipa_mod._recompute(*inputs, **kw)
    q, k, _, qp, kp, _, _, _, mask, hw, _, _, g_o, g_opt, g_pair = \
        [t.abs() for t in inputs]
    pad = (1.0 - mask)[:, None, :, None]  # [F, 1, N, 1] over query rows
    a, dl, dist = a.abs() * pad, dl.abs() * pad, dist.abs()
    rowsum = dl.sum(-1).transpose(1, 2)[..., None]
    colsum = dl.sum(-2).transpose(1, 2)[..., None]
    return dict(
        dq=c_qk * torch.einsum("fhij,fjhc->fihc", dl, k).max(),
        dk=c_qk * torch.einsum("fhij,fihc->fjhc", dl, q).max(),
        dv=torch.einsum("fhij,fihc->fjhc", a, g_o).max(),
        dqp=(hw[:, None] * (rowsum * qp + torch.einsum(
            "fhij,fjhx->fihx", dl, kp))).max(),
        dkp=(hw[:, None] * (colsum * kp + torch.einsum(
            "fhij,fihx->fjhx", dl, qp))).max(),
        dvp=torch.einsum("fhij,fihx->fjhx", a, g_opt).max(),
        dbias=math.sqrt(1.0 / 3) * dl.sum(0).max(),
        dpz=torch.einsum("fhij,fihd->ijd", a, g_pair).max(),
        dhw=torch.sum(0.5 * dist * dl, dim=(0, 2, 3)).max(),
    )


def ipa_bwd_errors(got: dict, want: dict, pad_scale: dict | None) -> dict:
    """{gradient: (max_abs_err, tol)}: BWD_RTOL of the gradient's largest
    magnitude, plus BWD_PAD_RTOL of ``pad_scale`` when the pad rows carry
    cotangents (None: they do not)."""
    out = {}
    for name in BWD_GRADS:
        err = float((got[name] - want[name]).abs().max())
        tol = BWD_RTOL * max(1.0, float(want[name].abs().max()))
        if pad_scale is not None:
            tol += BWD_PAD_RTOL * float(pad_scale[name])
        out[name] = (err, tol)
    return out


# launcher -> its output shapes from (F, N, H, C, P3q, P3v, Dz), as the
# wrappers allocate them; kept here so that ipa_kernel_ms also times
# another checkout's package (tools/bench_ipa.py --package)
IPA_BWD_OUT_SHAPES = {
    "ipa_attention_bwd_dq": lambda F, N, H, C, P3q, P3v, Dz: (
        (F, N, H, C), (F, N, H, P3q), (F, H, N)),
    "ipa_attention_bwd_dkv": lambda F, N, H, C, P3q, P3v, Dz: (
        (F, N, H, C), (F, N, H, P3q), (F, N, H, C), (F, N, H, P3v)),
    "ipa_attention_bwd_pair": lambda F, N, H, C, P3q, P3v, Dz: (
        (N, N, H), (N, N, Dz)),
}


def ipa_kernel_ms(torch, mod, kind: str, operands, c_qk: float,
                  reps: int) -> float:
    """The time of IPA kernel ``kind`` (``ipa_attention_fwd`` or
    ``ipa_attention_wide_fwd`` on the forward's 10 inputs, or a backward
    launcher of either library on the 15 backward inputs) alone: outputs
    allocated once, then ``reps`` launches straight through the library of
    ``mod`` (no checks, no counter moves)."""
    q = operands[0]
    F, N, H, C = q.shape
    Dz = operands[7].shape[-1]
    base = kind.replace("_wide", "")
    if base == "ipa_attention_fwd":
        Pq, Pv = operands[3].shape[-2], operands[5].shape[-2]
        shapes = ((F, N, H, C), (F, N, H, Pv, 3), (F, N, H, Dz), (F, H, N))
        lib = mod._lib(kind)
    else:
        Pq, Pv = operands[3].shape[-1] // 3, operands[5].shape[-1] // 3
        shapes = IPA_BWD_OUT_SHAPES[base](F, N, H, C, 3 * Pq, 3 * Pv, Dz)
        lib = mod._lib(kind[:kind.rindex("_")])
    outs = [torch.empty(s, dtype=torch.float32, device=q.device)
            for s in shapes]
    ptrs = [t.data_ptr() for t in tuple(operands) + tuple(outs)]
    fn = getattr(lib, kind)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (*ptrs, F, N, H, C, Pq, Pv, Dz, c_qk, math.sqrt(1.0 / 3), 1e5,
            q.device.index or 0, stream)
    check(fn(*args) == 0, f"{kind}: launch refused")
    return time_ms(torch, lambda: fn(*args), reps)


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


IPA_ATOL = 1e-4  # real rows: float32 both sides, sums in another order
IPA_LSE_RTOL = 2e-7  # masked-row lse sits near -1e5: 2.5 float32 ulps there


def ipa_errors(got, want, args) -> dict:
    """Max abs error of the kernel's (o, o_pt, o_pair) against the plain
    version, separately on real and pad query rows, each with its tolerance.

    Real rows: 1e-4. A pad row (mask_i = 0) has every logit near
    -inf = -1e5, where float32 rounds to 2^-7 = 0.0078: each logit carries
    up to half of that in either version, so the softmax weights may differ
    by 2 x 0.0078 relative and the output by that much of the largest value
    it averages."""
    mask = args[8]
    real = mask.bool()[..., None, None]  # against [F, N, H, ...]
    out = {}
    for name, g, w, val in zip(("o", "o_pt", "o_pair"), got[:3], want[:3],
                               (args[2], args[5], args[7])):
        diff = (g - w).abs().reshape(g.shape[:3] + (-1,))
        pad_tol = 2 * 2.0 ** -7 * float(val.abs().max())
        out[name] = dict(
            real=float(diff.masked_fill(~real, 0).max()),
            pad=float(diff.masked_fill(real, 0).max()),
            tol_real=IPA_ATOL, tol_pad=pad_tol)
    lse_bad = (got[3] - want[3]).abs() > IPA_ATOL + IPA_LSE_RTOL * want[3].abs()
    out["lse"] = dict(max=float((got[3] - want[3]).abs().max()),
                      ok=not bool(lse_bad.any()))
    return out


# the IPA kernels' cases of phase 2, at the release widths unless stated:
# N = 5 and 16 sit inside one 32-row block and one 16-key step, 203 and 611
# end in ragged ones; "tiny" is a small width (C = 8: one 8-channel tile a
# warp); "first-tile-pad" masks the first 40 residues, so that every row's
# first key steps are all pad and its running max starts near -1e5 before
# the online softmax rescales it away. The last three are past the
# tensor-core kernels' widths (ipa_attention.TILE_LIMITS) and run the wide
# route's CUDA-core kernels: "wide" at every width past its limit at once
# (C = 384, Pq*3 = 36, Pv*3 = 54, Dz = 64; 4 heads, 203 residues ending in
# a ragged tile), "wide-dz" at the release widths with Dz = 64, and
# "wide-model" at the widths and window of phase 4b's model (WIDE_MODEL:
# the release model with c_z 256, c_hidden 384, no_qk_points 12, so 8
# heads, Pv 12, Dz 64, on a 256-residue window with 56 pad rows), whose
# errors and times go into the wide kernels' reports beside the launches
# of that phase
WIDE_CASE = dict(N=203, H=4, C=384, Pq=12, Pv=18, Dz=64, masked=11)
WIDE_MODEL_CASE = dict(N=256, masked=56, C=384, Pq=12, Dz=64)
IPA_CASES = (("release", dict(N=256, masked=56)),
             ("ragged", dict(N=203, masked=11)),
             ("N5", dict(N=5, masked=1)),
             ("N16", dict(N=16, masked=3)),
             ("long", dict(N=611, masked=13)),
             ("tiny", dict(N=37, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=5)),
             ("first-tile-pad", dict(N=203, masked=5, lead_masked=40)),
             ("wide", WIDE_CASE),
             ("wide-dz", dict(N=256, masked=56, Dz=64)),
             ("wide-model", WIDE_MODEL_CASE))
# the cases each IPA kernel is also timed at. The kernels line reports the
# tensor-core kernels at "release" and the wide ones at "wide-model" (the
# shapes phases 4 and 4b launch them at); the times at "wide" are printed
TIMED_CASES = (("release", {}), ("wide-model", WIDE_MODEL_CASE),
               ("wide", WIDE_CASE))
REPORTED_CASES = ("release", "wide-model")
# the IPA wrappers' launch counters: kernel -> (tensor-core route, wide)
IPA_COUNTERS = {
    "ipa_attention_fwd": ("launches", "wide_launches"),
    "ipa_attention_bwd_dq": ("bwd_dq_launches", "wide_bwd_dq_launches"),
    "ipa_attention_bwd_dkv": ("bwd_dkv_launches", "wide_bwd_dkv_launches"),
    "ipa_attention_bwd_pair": ("bwd_pair_launches", "wide_bwd_pair_launches"),
}


def ipa_counts(ipa_mod) -> dict:
    """{kernel: (tensor-core launches, wide launches)} of this process."""
    return {k: tuple(getattr(ipa_mod, n) for n in names)
            for k, names in IPA_COUNTERS.items()}


def reset_ipa_counts(ipa_mod):
    for names in IPA_COUNTERS.values():
        for n in names:
            setattr(ipa_mod, n, 0)


def ipa_route(ipa_mod, shape: dict) -> str:
    """The route (tc or wide) of ``shape``'s widths (release unless
    stated); the four kernels share it at every case here."""
    w = dict(dict(C=256, Pq=8, Pv=12, Dz=32), **shape)
    routes = {ipa_mod.kernel_route(k, w["C"], 3 * w["Pq"], 3 * w["Pv"],
                                   w["Dz"]) for k in IPA_COUNTERS}
    check(len(routes) == 1, f"IPA kernels on several routes at {w}: {routes}")
    return routes.pop()


def check_launched(ipa_mod, before: dict, kernels, route: str, label: str):
    """Each of ``kernels`` launched once since ``before`` on ``route``, and
    never on the other."""
    after = ipa_counts(ipa_mod)
    for k in kernels:
        tc, wide = (a - b for a, b in zip(after[k], before[k]))
        want = (1, 0) if route == "tc" else (0, 1)
        check((tc, wide) == want, f"{k} {label}: {tc} tensor-core and {wide} "
              f"wide launches, expected {want}")


def kernel_phase(torch, device, card: str) -> list[dict]:
    """The forward kernel against its plain version at every case of
    IPA_CASES, on the route its widths select; the reports of the
    tensor-core kernel (release case) and the wide kernel (wide-model
    case), after timing it at every case of TIMED_CASES."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    reports = {}
    for label, shape in IPA_CASES:
        args, c_qk = ipa_inputs(torch, device, seed=len(label), **shape)
        route = ipa_route(ipa_mod, shape)
        before = ipa_counts(ipa_mod)
        got = ipa_mod.ipa_attention_fwd(*args, c_qk)
        torch.cuda.synchronize()
        check_launched(ipa_mod, before, ("ipa_attention_fwd",), route, label)
        want = ipa_mod.ipa_attention_plain(*args, c_qk)
        errs = ipa_errors(got, want, args)
        kname = ("ipa_attention_fwd" if route == "tc"
                 else "ipa_attention_wide_fwd")
        for name in ("o", "o_pt", "o_pair"):
            e = errs[name]
            print(f"kernel {kname} {label}: {name} max_abs_err "
                  f"real rows {e['real']:.3e} (tol {e['tol_real']:.0e}), pad "
                  f"rows {e['pad']:.3e} (tol {e['tol_pad']:.3e})")
            check(e["real"] <= e["tol_real"] and e["pad"] <= e["tol_pad"],
                  f"{kname} {label} {name} out of tolerance: {e}")
        print(f"kernel {kname} {label}: lse max_abs_err "
              f"{errs['lse']['max']:.3e} (tol {IPA_ATOL:.0e} + "
              f"{IPA_LSE_RTOL:.0e}*|lse|)")
        check(errs["lse"]["ok"], f"{kname} {label} lse out of tolerance")
        if label in dict(TIMED_CASES):
            reports[label] = fwd_report(torch, ipa_mod, kname, label, args,
                                        c_qk, errs, card)
    return [reports[label] for label in REPORTED_CASES]


def fwd_report(torch, ipa_mod, kname: str, label: str, args, c_qk, errs,
               card: str) -> dict:
    """``kname``'s report at ``label``'s inputs: times through the wrapper
    and alone, the plain version's time, the bounds."""
    F, N, H, C = args[0].shape
    Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
    ms = time_ms(torch, lambda: ipa_mod.ipa_attention_fwd(*args, c_qk), 50)
    kernel_ms = ipa_kernel_ms(torch, ipa_mod, kname, args, c_qk, 50)
    plain_ms = time_ms(torch, lambda: ipa_mod.ipa_attention_plain(*args, c_qk),
                       20)
    ops, nbytes, ew_ops = ipa_cost(F, N, H, C, Pq, Pv, Dz)
    streams = [errs[n] for n in ("o", "o_pt", "o_pair")]
    report = {
        "name": kname,
        "route": "cuda",
        "source": f"dynamicpdb_tpu_torch/csrc/{kname}.cu",
        "replaces": "dynamicpdb_tpu/ops/pallas/ipa_attention.py:39",
        "case": f"{label}: F={F} N={N} H={H} C={C} Pq={Pq} Pv={Pv} Dz={Dz}",
        "launches": None,  # filled from a run of the path
        "max_abs_err": max(max(e["real"], e["pad"]) for e in streams),
        "max_abs_err_real_rows": max(e["real"] for e in streams),
        "max_abs_err_pad_rows": max(e["pad"] for e in streams),
        "max_abs_err_lse": errs["lse"]["max"],
        "ms": ms,
        "ms_kernel": kernel_ms,  # the kernel alone, no host work
        "plain_ms": plain_ms,
        **bounds(ops, ew_ops, nbytes),
        "library_ms": None,  # no single PyTorch call has the pair stream
    }
    print(f"kernel {kname} {label}: {ms:.4f} ms through "
          f"the wrapper, {kernel_ms:.4f} ms alone, plain "
          f"{plain_ms:.4f} ms, bound {report['bound_ms']:.4f} ms "
          f"({report['bound_by']}: {ops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB), tensor-core bound "
          f"{report['tc_bound_ms']:.4f} ms, warm L2 [{card}]")
    return report


BWD_KERNELS = {  # kernel -> (replaced TPU kernel, its gradients)
    "ipa_attention_bwd_dq": ("dynamicpdb_tpu/ops/pallas/ipa_attention.py:259",
                             ("dq", "dqp", "dhw")),
    "ipa_attention_bwd_dkv": ("dynamicpdb_tpu/ops/pallas/ipa_attention.py:297",
                              ("dk", "dkp", "dv", "dvp")),
    "ipa_attention_bwd_pair": ("dynamicpdb_tpu/ops/pallas/ipa_attention.py:338",
                               ("dbias", "dpz")),
}


def bwd_kernel_phase(torch, device, card: str) -> list[dict]:
    """The three backward kernels against their plain versions at every
    case of IPA_CASES, on the route its widths select, with cotangents
    zeroed on pad rows and with cotangents everywhere, and there the
    autograd Function's backward against autograd of the plain forward on
    the card; then each kernel's time (through its wrapper and alone)
    against its plain version at every case of TIMED_CASES. Returns the
    reports of the tensor-core kernels (release case), then of the wide
    ones (wide-model case)."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    reports = {}
    for label, shape in IPA_CASES:
        args, c_qk = ipa_inputs(torch, device, seed=10 + len(label), **shape)
        route = ipa_route(ipa_mod, shape)
        for zero_pad in (True, False):
            case = "pad cotangents 0" if zero_pad else "pad cotangents random"
            inputs, cots = ipa_bwd_inputs(torch, args, c_qk,
                                          zero_pad=zero_pad, seed=3)
            before = ipa_counts(ipa_mod)
            got = ipa_bwd_grads(torch, inputs, c_qk, plain=False)
            torch.cuda.synchronize()
            check_launched(ipa_mod, before, BWD_KERNELS, route,
                           f"{label}, {case}")
            want = ipa_bwd_grads(torch, inputs, c_qk, plain=True)
            pad_scale = None if zero_pad else ipa_bwd_pad_scale(torch, inputs,
                                                                c_qk)
            errs = ipa_bwd_errors(got, want, pad_scale)
            for name, (err, tol) in errs.items():
                print(f"kernel backward {label} ({route}), {case}: {name} "
                      f"max_abs_err {err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"backward {label} {case}: {name} "
                      f"{err} > {tol}")
            if label in dict(TIMED_CASES):
                for kname, (_, grads) in BWD_KERNELS.items():
                    key = "max_abs_err" if zero_pad else "max_abs_err_pad_cotangents"
                    reports.setdefault((label, kname), {})[key] = max(
                        errs[g][0] for g in grads)

            # the Function end to end: kernels against dense autograd
            leaves = [a.clone().requires_grad_(i != 8)
                      for i, a in enumerate(args)]
            diff = [a for a in leaves if a.requires_grad]

            def loss(outs):
                return sum((o * c).sum() for o, c in zip(outs[:3], cots))

            g_fn = torch.autograd.grad(loss(ipa_mod.ipa_attention(*leaves, c_qk)),
                                       diff)
            g_dense = torch.autograd.grad(
                loss(ipa_mod.ipa_attention_plain(*leaves, c_qk)), diff)
            names = ("dq", "dk", "dv", "dqp", "dkp", "dvp", "dbias", "dpz",
                     "dhw")
            for name, a, b in zip(names, g_fn, g_dense):
                err = float((a - b).abs().max())
                tol = BWD_RTOL * max(1.0, float(b.abs().max()))
                if pad_scale is not None:
                    tol += BWD_PAD_RTOL * float(pad_scale[name])
                print(f"function backward {label}, {case}: {name} vs dense "
                      f"autograd max_abs_err {err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"Function backward {label} {case}: {name} "
                      f"{err} > {tol}")

    kw = dict(c_b=math.sqrt(1.0 / 3), inf=1e5)
    out = []
    for label, shape in TIMED_CASES:
        prefix = ("ipa_attention_" if ipa_route(ipa_mod, shape) == "tc"
                  else "ipa_attention_wide_")
        args, c_qk = ipa_inputs(torch, device, seed=20, **shape)
        inputs, _ = ipa_bwd_inputs(torch, args, c_qk, zero_pad=False, seed=4)
        F, N, H, C = args[0].shape
        Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
        costs = ipa_bwd_cost(F, N, H, C, Pq, Pv, Dz)
        for kname, (replaces, _) in BWD_KERNELS.items():
            name = kname.replace("ipa_attention_", prefix)
            kernel = getattr(ipa_mod, kname)
            plain = getattr(ipa_mod, kname.replace("ipa_attention_bwd",
                                                   "ipa_bwd") + "_plain")
            ms = time_ms(torch, lambda: kernel(*inputs, c_qk=c_qk, **kw), 50)
            kernel_ms = ipa_kernel_ms(torch, ipa_mod, name, inputs, c_qk, 50)
            plain_ms = time_ms(torch, lambda: plain(*inputs, c_qk=c_qk, **kw),
                               20)
            ops, nbytes, ew_ops = costs[kname]
            rep = {
                "name": name, "route": "cuda",
                "source": f"dynamicpdb_tpu_torch/csrc/{prefix}bwd.cu",
                "replaces": replaces,
                "case": f"{label}: F={F} N={N} H={H} C={C} Pq={Pq} Pv={Pv} "
                        f"Dz={Dz}",
                "launches": None, **reports[(label, kname)],
                "ms": ms, "ms_kernel": kernel_ms, "plain_ms": plain_ms,
                **bounds(ops, ew_ops, nbytes),
                "library_ms": None,  # no single PyTorch call computes it
            }
            print(f"kernel {name} {label}: {ms:.4f} ms through the wrapper, "
                  f"{kernel_ms:.4f} ms alone, plain {plain_ms:.4f} ms, "
                  f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}: "
                  f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
                  f"tensor-core bound {rep['tc_bound_ms']:.4f} ms, warm L2 "
                  f"[{card}]")
            if label in REPORTED_CASES:
                out.append(rep)
    return out


# ---------------------------------------------------------------------------
# phase 2b: the GeoFormer attention kernels against their plain versions
# ---------------------------------------------------------------------------
# release shapes: kernel 5 (GeometricAttention) B = L = 256, n_axis 2, H 4,
# d 128; kernel 6 (AttentionWEdgeBias) M 16, L 256, d 256, H 8; c 32 both
GEOM_SHAPES = {
    "geom_attention": dict(B=None, R=2, H=4, d=128),  # B = L
    "node_attention": dict(B=16, R=1, H=8, d=256),
}
GEOM_C = 32
# float32 on both sides, sums over d and L terms in another order: 1e-4 on
# unit-scale outputs (the IPA kernel's bar). bfloat16 inputs: both compute
# in float32 from the same bf16 values and round the result to bf16, which
# may then differ by one bf16 step (2^-8 relative): 2^-7 |want| on top.
GEOM_ATOL = 1e-4
GEOM_BF16_RTOL = 2.0 ** -7


def geom_inputs(torch, device, kind: str, L: int, dtype, seed: int,
                pad: int = 0, *, B: int | None = None, masked_prefix: int = 0,
                wdtype=None):
    """Seeded inputs of kernel ``kind`` at its release widths and length L:
    x ~ N(0, 1) (a normalised activation) in ``dtype``, weights ~ N(0, 1/d)
    and biases ~ N(0, 0.1^2) in ``wdtype`` (default: ``dtype``), the
    attention bias ~ N(0, 1) with the last ``pad`` keys at -1e9 (pad_safe
    padding); node_attention's key mask drops ~12% of the keys of every row
    but the first (the pseudo-MSA's mask rate), and row 1 also its first
    ``masked_prefix`` keys. ``B`` overrides the release batch (B = L for
    geom_attention)."""
    shp = GEOM_SHAPES[kind]
    B = B or shp["B"] or L
    R, H, d, c = shp["R"], shp["H"], shp["d"], GEOM_C
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    x = rnd(B, R, L, d).to(dtype)
    w = dict(qg_w=rnd(d, R, H, 2 * c, scale=d ** -0.5),
             qg_b=rnd(R, H, 1, 2 * c, scale=0.1),
             kv_w=rnd(d, R, H, 2 * c, scale=d ** -0.5),
             kv_b=rnd(R, H, 1, 2 * c, scale=0.1))
    bias = rnd(R, H, L, L)
    if pad:
        bias[..., L - pad:] = -1e9
    kmask = None
    if kind == "node_attention":
        kmask = (torch.rand((B, L), generator=g, device=device) > 0.12).float()
        kmask[0] = 1.0
        kmask[1, :masked_prefix] = 0.0
        x, bias = x[:, 0], bias[0]
    w = {k: v.to(wdtype or dtype) for k, v in w.items()}
    return dict(x=x, bias=bias, kmask=kmask, **w)


def geom_call(mod, kind: str, inp: dict, plain: bool):
    """The kernel (or its plain version) on ``inp``."""
    c, scale = GEOM_C, GEOM_C ** -0.5
    args = [inp["x"], inp["qg_w"], inp["qg_b"], inp["kv_w"], inp["kv_b"],
            inp["bias"]]
    if kind == "node_attention":
        fn = mod.node_attention_plain if plain else mod.fused_gated_node_attention
        return fn(*args, inp["kmask"], c=c, scale=scale)
    fn = mod.geom_attention_plain if plain else mod.fused_gated_geom_attention_t
    return fn(*args, c=c, scale=scale)


def geom_error(got, want) -> tuple[float, float]:
    """(max_abs_err, how far past its tolerance: <= 0 passes)."""
    import torch

    w = want.float()
    err = (got.float() - w).abs()
    rtol = GEOM_BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    return float(err.max()), float((err - rtol * w.abs() - GEOM_ATOL).max())


def geom_cost(kind: str, L: int, bytes_per_elem: int = 4):
    """(operations, bytes, elementwise operations) of one launch: the q|gate
    and k|v projections and the two L x L x c contractions (2 per
    multiply-add), ~4 elementwise operations per logit and ~4 per output; x
    read once, the bias, key mask and weights once, the output written
    once."""
    shp = GEOM_SHAPES[kind]
    B = shp["B"] or L
    R, H, d, c = shp["R"], shp["H"], shp["d"], GEOM_C
    G = R * H
    ew_ops = B * G * (4 * L * L + 4 * L * c)
    ops = B * G * (2 * L * d * 4 * c + 4 * L * L * c) + ew_ops
    nbytes = (bytes_per_elem * (B * R * L * d + B * G * L * c)
              + 4 * (G * L * L + 2 * G * d * 2 * c + 2 * G * 2 * c))
    if kind == "node_attention":
        nbytes += 4 * B * L
    return ops, nbytes, ew_ops


GEOM_REPLACES = {
    "geom_attention": "dynamicpdb_tpu/ops/pallas/geom_attention.py:50",
    "node_attention": "dynamicpdb_tpu/ops/pallas/geom_attention.py:76",
}


def geom_kernel_ms(torch, mod, kind: str, inp: dict, reps: int) -> float:
    """The time of kernel ``kind`` alone: its operands prepared once by the
    wrapper's kernel_inputs, then ``reps`` launches (no counter moves). The
    wrapper's own per-call work (checks, views, casts of bf16 weights) runs
    on the host and is timed apart, through the public function."""
    x, bias = inp["x"], inp["bias"]
    if kind == "node_attention":
        x, bias = x[:, None], bias[None]
    B, R, L, d = x.shape
    H = inp["qg_w"].shape[2]
    ops = mod.kernel_inputs(kind, x, inp["qg_w"], inp["qg_b"], inp["kv_w"],
                            inp["kv_b"], bias, inp["kmask"], GEOM_C)
    out = torch.empty((B, R * H, L, GEOM_C), dtype=x.dtype, device=x.device)
    lib, stream = mod._lib(), torch.cuda.current_stream().cuda_stream
    return time_ms(torch, lambda: mod.launch(
        lib, kind, ops, out, B, R, H, L, d, GEOM_C, GEOM_C ** -0.5,
        x.device.index, stream), reps)


def sdpa_core_ms(torch, mod, kind: str, inp: dict) -> float:
    """The time of torch's scaled_dot_product_attention on the q, k, v and
    bias (+ key mask) of these inputs: the attention core only, without the
    projections and the gate the kernel fuses."""
    c = GEOM_C
    x = inp["x"].float()
    if kind == "node_attention":
        x = x[:, None]
    qg = torch.einsum("brld,drhe->brhle", x, inp["qg_w"].float()) + inp["qg_b"].float()
    kv = torch.einsum("brld,drhe->brhle", x, inp["kv_w"].float()) + inp["kv_b"].float()
    B, R, H, L = qg.shape[:4]
    q, k, v = (t.reshape(B, R * H, L, c).contiguous()
               for t in (qg[..., :c], kv[..., :c], kv[..., c:]))
    mask = inp["bias"].float().reshape(1, -1, L, L)
    if kind == "node_attention":
        mask = mask + (inp["kmask"][:, None, None, :] - 1.0) * 1e9
    mask = mask.expand(B, R * H, L, L)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask), 20)


# the checks of phase 2b: (label, L, pad, batch rows, masked prefix). The
# long ragged L spans three query chunks of 256 rows and five key chunks of
# 128 (past what stays resident), each with a ragged last one; its batch is
# cut for geom_attention so that the plain version's [B, 8, L, L] logits
# stay small. Row 1 of node_attention's mask drops its first 64 keys: the
# first two 32-key steps of that row are all masked.
GEOM_CASES = (("release", 256, 0, None, 0), ("ragged", 203, 11, None, 0),
              ("long", 611, 13, 32, 64))


def geom_kernel_phase(torch, device, card: str) -> list[dict]:
    """Both GeoFormer attention kernels against their plain versions on the
    card at the release shapes, at a ragged L = 203 and at a long ragged L
    = 611, in float32 and bfloat16; then each kernel's time at the release
    shapes (float32, the extraction's default, and bfloat16; through its
    wrapper, ``ms`` as in every kernel report, and alone, ``ms_kernel``)
    against its plain version, the SDPA core and its bounds."""
    from dynamicpdb_tpu_torch.ops import geom_attention as mod

    reports = {}
    for kind in GEOM_SHAPES:
        worst = 0.0
        for label, L, pad, B, prefix in GEOM_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                inp = geom_inputs(torch, device, kind, L, dtype,
                                  seed=L + (dtype == torch.bfloat16), pad=pad,
                                  B=B if kind == "geom_attention" else None,
                                  masked_prefix=prefix)
                got = geom_call(mod, kind, inp, plain=False)
                torch.cuda.synchronize()
                want = geom_call(mod, kind, inp, plain=True)
                check(got.dtype == dtype and got.shape == want.shape,
                      f"{kind}: {got.dtype} {tuple(got.shape)}, want "
                      f"{dtype} {tuple(want.shape)}")
                err, over = geom_error(got, want)
                tol = ("1e-4" if dtype == torch.float32
                       else "1e-4 + 2^-7 |want|")
                print(f"kernel {kind} {label} L={L} {str(dtype)[6:]}: "
                      f"max_abs_err {err:.3e} (tol {tol}; scale "
                      f"{float(want.float().abs().max()):.3f})")
                check(over <= 0, f"{kind} {label} {dtype}: max_abs_err "
                      f"{err} out of tolerance")
                if dtype == torch.float32:
                    worst = max(worst, err)
                del inp, got, want
        inp = geom_inputs(torch, device, kind, 256, torch.float32, seed=7)
        kernel_ms = geom_kernel_ms(torch, mod, kind, inp, 20)
        ms = time_ms(torch, lambda: geom_call(mod, kind, inp, plain=False), 20)
        plain_ms = time_ms(torch, lambda: geom_call(mod, kind, inp, plain=True), 5)
        sdpa_ms = sdpa_core_ms(torch, mod, kind, inp)
        inp16 = geom_inputs(torch, device, kind, 256, torch.bfloat16, seed=7)
        kernel_ms16 = geom_kernel_ms(torch, mod, kind, inp16, 20)
        ms16 = time_ms(torch, lambda: geom_call(mod, kind, inp16, plain=False),
                       20)
        ops, nbytes, ew_ops = geom_cost(kind, 256)
        reports[kind] = {
            "name": kind, "route": "cuda",
            "source": "dynamicpdb_tpu_torch/csrc/geom_attention.cu",
            "replaces": GEOM_REPLACES[kind], "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bounds(ops, ew_ops, nbytes),
            # torch's SDPA on the same q, k, v and bias: the attention core
            # only, without the projections and the gate the kernel fuses
            "library_ms": sdpa_ms,
            "library": "scaled_dot_product_attention (attention core only)",
            "ms_kernel": kernel_ms,  # the kernel alone, no host work
            "ms_bfloat16": ms16,  # bf16 x and weights: one projection pass
            "ms_kernel_bfloat16": kernel_ms16,
        }
        rep = reports[kind]
        print(f"kernel {kind} release float32: {ms:.4f} ms through the "
              f"wrapper, {kernel_ms:.4f} ms alone, plain "
              f"{plain_ms:.4f} ms, SDPA core only {sdpa_ms:.4f} ms, bound "
              f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}: "
              f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), tensor-core "
              f"bound {rep['tc_bound_ms']:.4f} ms ({rep['tc_bound_by']}); "
              f"bfloat16 {ms16:.4f} ms ({kernel_ms16:.4f} alone); warm L2 "
              f"[{card}]")
    return list(reports.values())


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------
def _post(base: str, raw: dict, query: str, timeout: float = 600):
    buf = io.BytesIO()
    np.savez(buf, **raw)
    req = urllib.request.Request(f"{base}/rollout?{query}", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        with np.load(io.BytesIO(resp.read())) as z:
            return {k: z[k] for k in z.files}


def serve_phase(device: str, overrides: list[str], *, lengths, pad_to: int,
                n_steps: int, num_t: int, seed: int = 0, label: str = "serve",
                tag: str = "") -> dict:
    """Seeded random weights -> torch.save -> serve_cli (as its CLI builds
    it) -> HTTP on an ephemeral port: healthz, one full rollout per entry
    of ``lengths``, then the second window again with fast_x0=1. Checks
    shapes, finiteness, the fast_x0 identity and the kernel launch counts
    (zero on the CPU, where the plain version runs). Returns the outputs
    and timings."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch import serve_cli
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.weights import randomize_

    cfg = config_lib.apply_overrides(config_lib.Config(), overrides)
    on_card = torch.device(device).type == "cuda"
    per_forward = cfg.model.ipa.num_blocks if on_card else 0

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        model = randomize_(DFoldScoreNetwork(cfg.model, device=device), seed)
        torch.save(model.state_dict(), ckpt)
        del model
        args = serve_cli.parse_args(
            ["--ckpt", ckpt, "--port", "0", "--pad-to", str(pad_to),
             "--device", device, *overrides])
        service = serve_cli.service_from_args(args)
    tables = service.diffuser.so3d.tables
    check(tables.cache_hit, f"IGSO3 table {tables.cache_file} was rebuilt, "
          "not read from the cache")
    server = serve_cli.make_server(service, args.host, args.port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{args.host}:{server.server_address[1]}"
    results = []
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["status"] == "ok" and health["pad_to"] == pad_to,
              f"healthz answered {health}")
        print(f"{label}: healthz {health}")

        windows = [make_window(n_res=n, frame_time=cfg.data.frame_time,
                               node_dim=cfg.model.node_repr_dim,
                               edge_dim=cfg.model.edge_repr_dim, seed=seed + i)
                   for i, n in enumerate(lengths)]
        # every window in full, then the second again with fast_x0
        requests = [(w, 0) for w in windows] + [(windows[1], 1)]
        ipa_mod.launches = 0  # the main path's count starts here
        for i, (window, fast) in enumerate(requests):
            n = int(window["aatype"].shape[0])
            raw = {k: window[k] for k in serve_cli.RAW_KEYS}
            before = ipa_mod.launches
            t0 = time.perf_counter()
            out = _post(base, raw, f"n_steps={n_steps}&num_t={num_t}"
                        f"&fast_x0={fast}&seed={seed}")
            dt = time.perf_counter() - t0
            launched = ipa_mod.launches - before
            expect = per_forward * n_steps * (1 if fast else num_t)
            check(out["atom_traj"].shape == (n_steps, n, 37, 3)
                  and out["rigid_traj"].shape == (n_steps, n, 7),
                  f"request {i}: shapes {out['atom_traj'].shape} "
                  f"{out['rigid_traj'].shape}")
            check(bool(np.isfinite(out["atom_traj"]).all()
                       and np.isfinite(out["rigid_traj"]).all()),
                  f"request {i}: non-finite output")
            check(launched == expect, f"request {i}: {launched} kernel "
                  f"launches, expected {expect}")
            results.append(dict(n=n, fast_x0=fast, seconds=dt,
                                launches=launched, out=out))
            print(f"{label}: request {i} n_res={n} pad_to={pad_to} "
                  f"n_steps={n_steps} num_t={num_t} fast_x0={fast}: "
                  f"{dt:.3f} s, {n_steps / dt:.2f} frames/s, "
                  f"{launched} kernel launches{tag}")
        launches = ipa_mod.launches

        # the x0-predictor's frames do not depend on the reverse trajectory:
        # fast_x0 must reproduce the full sampler (same forwards, same
        # inputs); 1e-4 of the coordinates' scale covers reduction-order
        # differences between the two runs' kernels
        full, fast = results[1]["out"], results[-1]["out"]
        for key in ("atom_traj", "rigid_traj"):
            err = float(np.abs(full[key] - fast[key]).max())
            tol = 1e-4 * max(1.0, float(np.abs(full[key]).max()))
            print(f"{label}: fast_x0 vs full {key} max_abs_err {err:.3e} "
                  f"tol {tol:.3e}")
            check(err <= tol, f"fast_x0 {key} differs by {err} > {tol}")

        try:
            _post(base, {"aatype": np.zeros(3, np.int32)}, "n_steps=1")
            check(False, "a window without its keys was accepted")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"missing keys answered {e.code}, not 400")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    return dict(results=results, launches=launches)


# ---------------------------------------------------------------------------
# phases 3c and 3d: batched rollout and the Picard sampler
# ---------------------------------------------------------------------------
# one computation against the same computation arranged another way on the
# same device (a batch against its windows one by one, fast_x0 against the
# full sampler, Picard's fixed point against the sequential chain): the
# same kernels on the same inputs, held to 1e-4 of the coordinates' scale,
# phase 3's bar for fast_x0 against the full sampler
SAME_PATH_RTOL = 1e-4


def sampling_setup(device: str, overrides: list[str], lengths, pad_to: int,
                   seed: int):
    """A model with seeded random weights at ``overrides``, its diffuser,
    and one featurized window per entry of ``lengths`` (synthetic, padded
    to ``pad_to``, reference noise from a seeded generator), on
    ``device``."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.data.dataset import pad_window
    from dynamicpdb_tpu_torch.data.featurize import (
        eval_init_window,
        featurize_window,
    )
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.serve_cli import RAW_KEYS
    from dynamicpdb_tpu_torch.weights import randomize_

    cfg = config_lib.apply_overrides(config_lib.Config(), overrides)
    model = randomize_(DFoldScoreNetwork(cfg.model, device=device),
                       seed).eval()
    diffuser = SE3Diffuser(cfg.diffuser, device=device)
    tables = diffuser.so3d.tables
    check(tables.cache_hit, f"IGSO3 table {tables.cache_file} was rebuilt, "
          "not read from the cache")
    feats = []
    with torch.inference_mode():
        for i, n in enumerate(lengths):
            w = make_window(n_res=n, frame_time=cfg.data.frame_time,
                            node_dim=cfg.model.node_repr_dim,
                            edge_dim=cfg.model.edge_repr_dim, seed=seed + i,
                            rot_wiggle=0.1)
            raw = pad_window({k: w[k] for k in RAW_KEYS}, pad_to)
            g = torch.Generator(device=device).manual_seed(seed + i)
            feats.append(eval_init_window(featurize_window(
                {k: torch.as_tensor(v, device=device) for k, v in raw.items()}),
                diffuser, generator=g))
    return cfg, model, diffuser, feats


def _sync(torch, device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def same_path_error(torch, got, want) -> tuple[float, float]:
    """(max abs error, tolerance: SAME_PATH_RTOL of want's scale)."""
    err = float((got.float() - want.float()).abs().max())
    return err, SAME_PATH_RTOL * max(1.0, float(want.abs().max()))


def batched_rollout_phase(device: str, overrides: list[str], *, lengths,
                          pad_to: int, n_steps: int, num_t: int,
                          seed: int = 0, tag: str = "") -> dict:
    """batched_rollout over B = len(lengths) windows stacked on axis 0,
    with the full sampler and with fast_x0: shapes, finiteness, the IPA
    forward launches (blocks x forwards per frame x frames x windows on the
    card, none on the CPU), each window's trajectory against rollout on
    that window with its generator, and fast_x0 against the full
    sampler."""
    import torch

    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.sampling.reverse import (
        batched_rollout,
        rollout,
        window_generators,
    )

    cfg, model, diffuser, feats = sampling_setup(device, overrides, lengths,
                                                 pad_to, seed)
    noise_scale = cfg.experiment.noise_scale
    batch = {k: torch.stack([f[k] for f in feats]) for k in feats[0]}
    B = len(lengths)
    per_forward = cfg.model.ipa.num_blocks if device == "cuda" else 0
    out = {}
    for fast in (False, True):
        reset_ipa_counts(ipa_mod)  # the path starts
        t0 = time.perf_counter()
        atoms, rigids = batched_rollout(
            model, diffuser, batch, n_steps=n_steps, num_t=num_t,
            noise_scale=noise_scale, fast_x0=fast, seed=seed)
        _sync(torch, device)
        dt = time.perf_counter() - t0
        launched = ipa_counts(ipa_mod)["ipa_attention_fwd"]
        expect = B * n_steps * (1 if fast else num_t) * per_forward
        check(launched == (expect, 0), f"batched rollout fast_x0={fast}: IPA "
              f"forward launches {launched}, expected ({expect}, 0)")
        check(atoms.shape == (B, n_steps, pad_to, 37, 3)
              and rigids.shape == (B, n_steps, pad_to, 7),
              f"batched rollout: shapes {tuple(atoms.shape)} "
              f"{tuple(rigids.shape)}")
        check(bool(torch.isfinite(atoms).all() and torch.isfinite(rigids).all()),
              "batched rollout: non-finite output")
        out[fast] = dict(atoms=atoms, rigids=rigids, seconds=dt,
                         launches=launched[0])
        print(f"batched rollout: B={B} windows (n_res {list(lengths)} padded "
              f"to {pad_to}) n_steps={n_steps} num_t={num_t} fast_x0={fast}: "
              f"{dt:.3f} s, {B * n_steps / dt:.2f} frames/s, {launched[0]} "
              f"IPA forward launches{tag}")
    gens = window_generators(seed, B, device)
    looped = 0.0
    for b in range(B):
        t0 = time.perf_counter()
        a, r = rollout(model, diffuser, {k: v[b] for k, v in batch.items()},
                       n_steps=n_steps, num_t=num_t, noise_scale=noise_scale,
                       generator=gens[b])
        _sync(torch, device)
        looped += time.perf_counter() - t0
        for name, got, want in (("atom37", out[False]["atoms"][b], a),
                                ("rigids", out[False]["rigids"][b], r),
                                ("atom37 fast_x0", out[True]["atoms"][b], a)):
            err, tol = same_path_error(torch, got, want)
            print(f"batched rollout: window {b} {name} against rollout on "
                  f"the window: max_abs_err {err:.3e} tol {tol:.3e}")
            check(err <= tol, f"batched rollout window {b} {name}: {err} > "
                  f"{tol}")
    print(f"batched rollout: rollout on each window in turn, full sampler: "
          f"{looped:.3f} s, {B * n_steps / looped:.2f} frames/s{tag}")
    return dict(launches=out[False]["launches"],
                launches_fast_x0=out[True]["launches"],
                seconds=out[False]["seconds"],
                seconds_fast_x0=out[True]["seconds"],
                frames_per_s=B * n_steps / out[False]["seconds"],
                frames_per_s_fast_x0=B * n_steps / out[True]["seconds"])


def recording(fn, outputs: list):
    """``fn`` that also appends each of its results to ``outputs``."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        outputs.append(out)
        return out
    return wrapped


def picard_phase(device: str, overrides: list[str], *, n_res: int,
                 pad_to: int, num_t: int, seed: int = 0,
                 tag: str = "") -> dict:
    """picard_reverse_sample with tol 0 and max_sweeps num_t - 1 against
    reverse_sample on the same noise (num_t - 1 pairs drawn up front from
    a seeded generator): num_t - 1 sweeps, the last sweep's chain equal to
    the sequential chain step for step, the same prediction, and
    ((num_t - 1)^2 + 1) forwards' IPA launches on the card. Both timed."""
    import torch

    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.sampling.picard import (
        draw_reverse_noise,
        picard_reverse_sample,
    )
    from dynamicpdb_tpu_torch.sampling.reverse import reverse_sample

    cfg, model, diffuser, (feats,) = sampling_setup(device, overrides,
                                                    (n_res,), pad_to, seed)
    noise_scale = cfg.experiment.noise_scale
    g = torch.Generator(device=device).manual_seed(seed)
    noise = draw_reverse_noise(diffuser, feats["rigids_t"].shape[:-1], num_t,
                               generator=g, device=device)
    chains = {"seq": [], "picard": []}
    reverse = diffuser.reverse
    try:
        diffuser.reverse = recording(reverse, chains["seq"])
        t0 = time.perf_counter()
        seq = reverse_sample(model, diffuser, feats, num_t=num_t,
                             noise_scale=noise_scale, noise=noise)
        _sync(torch, device)
        seq_s = time.perf_counter() - t0
        diffuser.reverse = recording(reverse, chains["picard"])
        reset_ipa_counts(ipa_mod)  # the path starts
        t0 = time.perf_counter()
        par = picard_reverse_sample(model, diffuser, feats, num_t=num_t,
                                    noise_scale=noise_scale, tol=0.0,
                                    max_sweeps=num_t - 1, noise=noise)
        _sync(torch, device)
        par_s = time.perf_counter() - t0
        launched = ipa_counts(ipa_mod)["ipa_attention_fwd"]
    finally:
        diffuser.reverse = reverse
    per_forward = cfg.model.ipa.num_blocks if device == "cuda" else 0
    expect = ((num_t - 1) ** 2 + 1) * per_forward
    check(launched == (expect, 0), f"picard: IPA forward launches "
          f"{launched}, expected ({expect}, 0)")
    check(par["n_sweeps"] == num_t - 1, f"picard: {par['n_sweeps']} sweeps, "
          f"expected {num_t - 1}")
    last_sweep = chains["picard"][-(num_t - 1):]
    worst = 0.0
    for k, (p, q) in enumerate(zip(last_sweep, chains["seq"])):
        err, tol = same_path_error(torch, p.to_tensor_7(), q.to_tensor_7())
        check(err <= tol, f"picard: chain step {k} differs from the "
              f"sequential chain by {err} > {tol}")
        worst = max(worst, err / tol)
    for key in ("rigids", "atom37"):
        err, tol = same_path_error(torch, par[key], seq[key])
        print(f"picard: final {key} against reverse_sample on the same "
              f"noise: max_abs_err {err:.3e} tol {tol:.3e}")
        check(err <= tol, f"picard final {key}: {err} > {tol}")
    print(f"picard: the last sweep's {num_t - 1} steps equal the sequential "
          f"chain (worst {worst:.3f} of tol); sweep delta "
          f"{float(par['sweep_delta']):.4e}")
    print(f"picard: n_res={n_res} num_t={num_t} tol=0 max_sweeps={num_t - 1}: "
          f"{par['n_sweeps']} sweeps in {par_s:.3f} s "
          f"({par_s / par['n_sweeps']:.3f} s a sweep), reverse_sample "
          f"{seq_s:.3f} s on the same noise; {launched[0]} IPA forward "
          f"launches{tag}")
    return dict(launches=launched[0], seconds=par_s, seconds_reverse=seq_s,
                n_sweeps=par["n_sweeps"])


# ---------------------------------------------------------------------------
# phase 4: gradients on the card, and training at release width
# ---------------------------------------------------------------------------
IPA_PROJECTIONS = ("linear_q", "linear_kv", "linear_q_points",
                   "linear_kv_points", "linear_b", "down_z", "head_weights")
# card against CPU, float32 with TF32 off on both: the CUDA kernels and
# cuDNN/cuBLAS sum in other orders than the CPU's plain versions through
# two IPA blocks and the ConvNet; 1e-3 of each gradient's largest
# magnitude, floored at 1e-6 of the model's largest gradient (a gradient
# whose true value is 0, like linear_b's bias, is rounding noise)
GRAD_FLOW_RTOL = 1e-3


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def grad_flow_phase(seed: int = 0, overrides=tuple(SMALL_OVERRIDES),
                    label: str = "grad flow") -> dict:
    """One train-step loss and backward at a small width (or the model of
    ``overrides``) in float32, every parameter drawn from a seeded
    generator (randomize_: the AF2 zero init of linear_out would make every
    IPA input gradient exactly 0), with the same injected noise on the card
    and on the CPU. Every parameter's gradient must agree, every IPA
    projection's gradient must be nonzero on the card, and each backward
    kernel must have run once per block and window, on the route the
    model's widths select."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.data.dataset import pad_window
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.train.experiment import Trainer
    from dynamicpdb_tpu_torch.weights import randomize_

    cfg = config_lib.apply_overrides(config_lib.Config(), list(overrides))
    ipa = cfg.model.ipa
    route = ipa_route(ipa_mod, dict(C=ipa.c_hidden, Pq=ipa.no_qk_points,
                                    Pv=ipa.no_v_points, Dz=ipa.c_z // 4))
    ws = [pad_window(make_window(n_res=n, frame_time=cfg.data.frame_time,
                                 node_dim=cfg.model.node_repr_dim,
                                 edge_dim=cfg.model.edge_repr_dim,
                                 seed=seed + i, rot_wiggle=0.1), 16)
          for i, n in enumerate((16, 12))]
    batch = {k: np.stack([w[k] for w in ws]) for k in ws[0]}
    grads = {}
    for dev in ("cpu", "cuda"):
        t = Trainer(cfg, device=dev)
        randomize_(t.model, seed)
        if dev == "cpu":
            noises = [t.draw_window_noise(cfg.data.frame_time, 16)
                      for _ in ws]
        reset_ipa_counts(ipa_mod)
        loss, _ = t.loss_and_grads(batch, _to(noises, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = ipa_counts(ipa_mod)
        launched = tuple(counts[k][route == "wide"] for k in BWD_KERNELS)
        other = sum(counts[k][route == "tc"] for k in BWD_KERNELS)
        grads[dev] = (float(loss), {n: p.grad.detach().cpu()
                                    for n, p in t.model.named_parameters()
                                    if p.grad is not None})
    expect = cfg.model.ipa.num_blocks * len(ws)
    check(launched == (expect,) * 3 and other == 0, f"{label}: backward "
          f"kernel launches {launched} on the {route} route ({other} on the "
          f"other), expected {expect} each")
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = grads["cpu"], grads["cuda"]
    check(sorted(g_cpu) == sorted(g_gpu), "grad flow: different parameters "
          "received gradients on the card and on the CPU")
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
    worst = (0.0, "")
    for name, want in g_cpu.items():
        tol = GRAD_FLOW_RTOL * max(float(want.abs().max()),
                                   floor / GRAD_FLOW_RTOL)
        err = float((g_gpu[name] - want).abs().max())
        check(err <= tol, f"{label}: {name} card vs CPU {err} > {tol}")
        worst = max(worst, (err / tol, name))
    for b in range(cfg.model.ipa.num_blocks):
        for proj in IPA_PROJECTIONS:
            key = f"score_model.trunk.ipa_{b}.{proj}" + (
                "" if proj == "head_weights" else ".weight")
            check(float(g_gpu[key].abs().max()) > 0,
                  f"{label}: {key} has a zero gradient on the card")
    print(f"{label}: C={ipa.c_hidden} Pq={ipa.no_qk_points} "
          f"Pv={ipa.no_v_points} Dz={ipa.c_z // 4}, {ipa.num_blocks} "
          f"block(s), float32, randomised weights: loss card {loss_gpu:.6f} "
          f"CPU {loss_cpu:.6f}; {len(g_cpu)} parameter gradients agree "
          f"(worst {worst[1]} at {worst[0]:.3f} of its tol "
          f"{GRAD_FLOW_RTOL:.0e} x max|g|); every IPA projection gradient "
          f"nonzero on the card; backward kernel launches {launched} on the "
          f"{route} route")
    return dict(loss_cuda=loss_gpu, loss_cpu=loss_cpu, route=route)


def write_manifest(tmp: str, lengths, n_frames: int, seed: int = 0,
                   rot_wiggle: float = 0.0) -> str:
    """make_trajectory_npz bundles and their CSV manifest in ``tmp``."""
    from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz

    rows = []
    for i, n in enumerate(lengths):
        path = make_trajectory_npz(os.path.join(tmp, f"prot{i}.npz"),
                                   n_res=n, n_frames=n_frames, seed=seed + i,
                                   rot_wiggle=rot_wiggle)
        rows.append(f"prot{i},{path},{n}")
    csv = os.path.join(tmp, "train.csv")
    with open(csv, "w") as f:
        f.write("name,atlas_npz,seq_len\n" + "\n".join(rows) + "\n")
    return csv


def train_phase(device: str, config: str, extra: list[str], *, lengths,
                n_frames: int, max_steps: int, tmp: str, tag: str = "") -> dict:
    """train_cli.main on a manifest of synthetic bundles: checks the loss
    and grad_norm of every step are finite, that the parameters moved
    (the IPA projections and the zero-initialised out-projections
    included), and on the card that every kernel launched exactly as the
    model's structure implies: per step, each window runs every block's
    forward twice (once more in the backward, for remat) and each backward
    kernel once."""
    import torch

    from dynamicpdb_tpu_torch import train_cli
    from dynamicpdb_tpu_torch.data.prefetch import THREAD_NAME
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.train.experiment import Trainer
    from dynamicpdb_tpu_torch.weights import init_like_jax_

    csv = write_manifest(tmp, lengths, n_frames)
    argv = ["--config", config, "--max-steps", str(max_steps), "--device",
            device, f"data.csv_path={csv}",
            f"experiment.ckpt_dir={os.path.join(tmp, 'ckpt')}",
            f"experiment.eval_dir={os.path.join(tmp, 'eval')}", *extra]
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    recorder = BatchRecorder(torch, max_steps)
    train_step = Trainer.train_step

    def recorded_step(self, raw_batch, noises=None):
        recorder(raw_batch)
        return train_step(self, raw_batch, noises)

    Trainer.train_step = recorded_step
    reset_ipa_counts(ipa_mod)  # the main path starts
    t0 = time.perf_counter()
    try:
        exp = train_cli.main(argv)
    finally:
        Trainer.train_step = train_step
    wall = time.perf_counter() - t0
    cfg, trainer = exp.cfg, exp.trainer
    alive = [t for t in threading.enumerate()
             if t.name == THREAD_NAME and t.is_alive()]
    check(not alive, f"train: {len(alive)} prefetcher thread(s) alive after "
          "train_cli returned")
    check_received_batches(torch, recorder, cfg, device)
    ipa = cfg.model.ipa
    route = (ipa_route(ipa_mod, dict(C=ipa.c_hidden, Pq=ipa.no_qk_points,
                                     Pv=ipa.no_v_points, Dz=ipa.c_z // 4))
             if on_card else "tc")
    counts = ipa_counts(ipa_mod)
    launched = {k: counts[name][route == "wide"] for k, name in
                zip(("fwd", "dq", "dkv", "pair"), IPA_COUNTERS)}
    other = sum(c[route == "tc"] for c in counts.values())
    check(other == 0, f"train: {other} launches off the {route} route")
    check(trainer.diffuser.so3d.tables.cache_hit, "IGSO3 table "
          f"{trainer.diffuser.so3d.tables.cache_file} was rebuilt, not read "
          "from the cache")
    check(exp.step == max_steps, f"trained {exp.step} steps, not {max_steps}")
    for m in exp.step_metrics:
        check(math.isfinite(m["total_loss"]) and math.isfinite(m["grad_norm"]),
              f"step {m['step']}: loss {m['total_loss']} grad_norm "
              f"{m['grad_norm']}")
    start = init_like_jax_(type(trainer.model)(cfg.model, device="cpu"),
                           cfg.experiment.seed).state_dict()
    now = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    moved = [k for k in now if not torch.equal(now[k], start[k])]
    for b in range(cfg.model.ipa.num_blocks):
        for proj in ("linear_q", "linear_kv", "linear_out", "down_z"):
            key = f"score_model.trunk.ipa_{b}.{proj}.weight"
            check(key in moved, f"{key} did not change in training")
    B, blocks = cfg.experiment.batch_size, cfg.model.ipa.num_blocks
    per_step = B * blocks
    expect = (dict(fwd=2 * per_step * max_steps if cfg.model.remat
                   else per_step * max_steps,
                   dq=per_step * max_steps, dkv=per_step * max_steps,
                   pair=per_step * max_steps) if on_card
              else dict(fwd=0, dq=0, dkv=0, pair=0))
    check(launched == expect, f"train: kernel launches {launched}, expected "
          f"{expect}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for m in exp.step_metrics:
        total = m["seconds"] + m["data_seconds"]
        print(f"train: step {m['step']} B={B} loss {m['total_loss']:.4f} "
              f"grad_norm {m['grad_norm']:.4f}: {total:.3f} s ({m['seconds']:.3f}"
              f" s train_step, {m['data_seconds']:.3f} s waiting for the "
              f"batch), {B / total:.2f} windows/s{tag}")
    steady = [m["seconds"] + m["data_seconds"] for m in exp.step_metrics[1:]]
    print(f"train: steady steps' data_seconds (waiting for the prefetcher) "
          f"{[m['data_seconds'] for m in exp.step_metrics[1:]]}{tag}")
    print(f"train: {max_steps} steps in {wall:.2f} s of train_cli; steady "
          f"steps (step 1 apart) {steady}; peak "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB; kernel "
          f"launches {launched} on the {route} route ({len(moved)} of "
          f"{len(now)} tensors moved){tag}")
    ckpt = os.path.join(cfg.experiment.ckpt_dir, f"step_{exp.step}.ckpt")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    return dict(ckpt=ckpt, launched=launched, route=route,
                steps=exp.step_metrics, peak_bytes=peak, wall=wall, batch=B,
                csv=csv)


class BatchRecorder:
    """A host copy of each batch a train step receives, and the device each
    tensor was on. On the card the copies run on a stream of their own,
    which first waits on the step's stream (so they read what the step
    reads, after the prefetcher's event); the step's stream never waits on
    them, so a timed step only queues them. The pinned buffers they fill
    are allocated for every step by the first step."""

    def __init__(self, torch, steps: int):
        self.torch, self.steps = torch, steps
        self.buffers, self.devices, self.stream = None, [], None

    def __call__(self, batch: dict):
        torch = self.torch
        if self.buffers is None:
            self.buffers = [
                {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
                 for k, v in batch.items()} for _ in range(self.steps)]
            if any(v.is_cuda for v in batch.values()):
                self.stream = torch.cuda.Stream()
        buf = self.buffers[len(self.devices)]
        self.devices.append({v.device.type for v in batch.values()})
        if self.stream is None:
            for k, v in batch.items():
                buf[k].copy_(v)
            return
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                buf[k].copy_(v, non_blocking=True)
                if v.is_cuda:  # the step may free it before the copy ends
                    v.record_stream(self.stream)


def check_received_batches(torch, recorder: BatchRecorder, cfg, device: str):
    """Every batch the steps received equals, in order, the plain
    iterator's on the host (the same dataset, sampler and epochs as
    train_cli's), bit for bit, and was on ``device``."""
    from dynamicpdb_tpu_torch.data.dataset import (
        TrajectoryDataset,
        batch_iterator,
        make_sampler,
    )

    if device == "cuda":
        torch.cuda.synchronize()
    dataset = TrajectoryDataset(cfg.data, split="train",
                                pad_to=cfg.data.filtering.max_len)
    sampler = make_sampler(dataset, cfg.data,
                           batch_size=cfg.experiment.batch_size,
                           seed=cfg.experiment.seed)
    plain, epoch = [], 0
    while len(plain) < len(recorder.devices):
        plain += list(batch_iterator(dataset, sampler, epoch))
        epoch += 1
    for i, (got, devices) in enumerate(zip(recorder.buffers,
                                           recorder.devices)):
        check(devices == {torch.device(device).type}, f"train: step {i + 1} "
              f"received tensors on {devices}, not {device}")
        want = plain[i]
        check(sorted(got) == sorted(want), f"train: step {i + 1} received "
              f"keys {sorted(got)}, the iterator gave {sorted(want)}")
        for k, v in want.items():
            check(torch.equal(got[k], torch.as_tensor(v)), f"train: step "
                  f"{i + 1}'s {k} differs from the plain iterator's")
    print(f"train: the {len(recorder.devices)} batches the steps received on "
          f"{device} equal the plain iterator's on the host, in order")


def serve_checkpoint(device: str, config: str, ckpt: str, extra: list[str], *,
                     n_res: int, pad_to: int, tag: str = "") -> dict:
    """serve_cli from a training checkpoint: one fast_x0 request over HTTP
    (n_steps = 2: one forward per step, each running every block's IPA
    kernel on the card)."""
    from dynamicpdb_tpu_torch import serve_cli
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    args = serve_cli.parse_args(["--ckpt", ckpt, "--port", "0", "--pad-to",
                                 str(pad_to), "--device", device, "--config",
                                 config, *extra])
    service = serve_cli.service_from_args(args)
    server = serve_cli.make_server(service, args.host, args.port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        cfg = service.model.cfg
        w = make_window(n_res=n_res, frame_time=2,
                        node_dim=cfg.node_repr_dim, edge_dim=cfg.edge_repr_dim,
                        seed=7)
        reset_ipa_counts(ipa_mod)
        t0 = time.perf_counter()
        out = _post(f"http://{args.host}:{server.server_address[1]}",
                    {k: w[k] for k in serve_cli.RAW_KEYS},
                    "n_steps=2&fast_x0=1&seed=0")
        dt = time.perf_counter() - t0
        launched = sum(ipa_counts(ipa_mod)["ipa_attention_fwd"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    check(service.step > 0, f"served step {service.step}, not the checkpoint's")
    expect = 2 * cfg.ipa.num_blocks if device == "cuda" else 0
    check(launched == expect, f"serve from checkpoint: {launched} kernel "
          f"launches, expected {expect}")
    check(out["atom_traj"].shape == (2, n_res, 37, 3)
          and bool(np.isfinite(out["atom_traj"]).all()),
          f"served from the checkpoint: {out['atom_traj'].shape}, finite "
          f"{np.isfinite(out['atom_traj']).all()}")
    print(f"serve from checkpoint: {os.path.basename(ckpt)} (step "
          f"{service.step}), one fast_x0 request n_res={n_res} n_steps=2: "
          f"{dt:.3f} s, {launched} kernel launches{tag}")
    return out


# ---------------------------------------------------------------------------
# phase 8: data parallel
# ---------------------------------------------------------------------------
# The machine has one card and NCCL refuses two ranks on one device, so the
# two-rank runs join with gloo on cuda:0: gloo's all_reduce takes CUDA
# tensors, and the port's gathers (ZeRO, 'model') go through host memory
# under gloo. Two ranks sharing a card measure correctness and the
# collectives' overhead, not scaling.
LAUNCHER = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK", "ROLE_RANK",
                "TORCHELASTIC_RUN_ID")
# two ranks against one process on the global batch: the same windows and
# noise, the gradient summed in another order (each rank's 4 windows, then
# the all-reduce of the two sums). Losses and grad norms to 1e-3 relative,
# as in tests/test_torch_parallel.py. The update (the parameters' move from
# their start) and each AMSGrad moment are held over the whole model, each
# as its distance from one process's over its norm, to a bound of its own
# taken from the card: the update read 8.513e-3, mu 3.4e-4, nu 4.9e-5 and
# nu_max 2.4e-5 (from step 2 on the gradients follow parameters that differ
# slightly, through a release-init network whose first gradient norm is
# ~1e5, so an element can move far: bb_update's mu by 4% of its tensor's
# largest). A control, one process at half the global batch (the gradient
# a rank would take without the other's windows), must read above every
# bound, so that each bound catches that fault. One process is
# bit-reproducible on the card (two runs measured equal).
DP_LOSS_RTOL = 1e-3
DP_GAP_BOUNDS = {"update": 2e-2, "mu": 5e-3, "nu": 1e-3, "nu_max": 1e-3}


def run_command(cmd: list[str], label: str, timeout: float = 900) -> str:
    """``cmd`` from the repo root without any launcher variables of this
    process, in a session of its own that is killed whole on a timeout;
    fails unless it exits 0. Returns its output."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise CheckFailed(f"{label}: no end within {timeout} s")
    check(proc.returncode == 0, f"{label}: exit {proc.returncode}\n"
          f"{out[-6000:]}")
    return out


def dp_run(torch, label: str, nproc: int, tmp: str, csv: str, config: str,
           overrides: list[str], steps: int, card: str, device: str,
           backend: str = "gloo") -> list[dict]:
    """tools/dp_step.py on ``nproc`` ranks (gloo ranks sharing cuda:0 on
    one card), over the manifest's batches; prints each rank's step and all-reduce seconds, its
    peak memory and the memory its parameters and optimizer state hold
    between steps; returns every rank's result."""
    out = os.path.join(tmp, label)
    cmd = LAUNCHER + [f"--nproc_per_node={nproc}", "-m",
                      "dynamicpdb_tpu_torch.tools.dp_step", "--config", config,
                      "--device", device, "--backend", backend, "--steps",
                      str(steps), "--csv", csv, "--out", out, *overrides]
    t0 = time.perf_counter()
    run_command(cmd, f"dp {label}")
    wall = time.perf_counter() - t0
    results = [torch.load(os.path.join(out, f"rank{r}.pt"),
                          weights_only=True) for r in range(nproc)]
    for res in results:
        print(f"dp {label}: rank {res['rank']} of {nproc} ({res['mesh']}): "
              f"step seconds {[round(s, 4) for s in res['seconds']]}, "
              f"all-reduce seconds {[round(s, 4) for s in res['comm_seconds']]}"
              f", peak {res['peak_bytes'] / 2**30:.3f} GiB, parameters and "
              f"optimizer state between steps {res['state_bytes'] / 2**30:.3f}"
              f" GiB, IPA launches {res['launches']} [{card}]")
    print(f"dp {label}: {nproc} ranks, {steps} steps in {wall:.2f} s of "
          f"launcher wall [{card}]")
    return results


def dp_train_cli(torch, label: str, nproc: int, tmp: str, csv: str,
                 config: str, overrides: list[str], steps: int, card: str,
                 device: str, backend: str) -> dict:
    """train_cli on ``nproc`` ranks under the launcher, with ``--backend``
    and ``--device`` given (gloo ranks sharing cuda:0 on one card), a
    metrics line a step; returns rank 0's checkpoint (params, optimizer
    with the moments gathered whole, rng) and its metrics lines (aux)."""
    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib

    run_dir = os.path.join(tmp, f"{label}-cli")
    local = load_yaml(config, overrides).experiment.batch_size
    t0 = time.perf_counter()
    out = run_command(LAUNCHER + [
        f"--nproc_per_node={nproc}", "-m", "dynamicpdb_tpu_torch.train_cli",
        "--config", config, "--max-steps", str(steps), "--device", device,
        "--backend", backend, *overrides, f"data.csv_path={csv}",
        f"experiment.ckpt_dir={run_dir}/ckpt",
        f"experiment.eval_dir={run_dir}/eval", "experiment.log_freq=1"],
        f"dp {label} train_cli")
    wall = time.perf_counter() - t0
    check(f"global_batch={local * nproc} ({local} a rank)" in out,
          f"dp {label}: train_cli did not train on {nproc} data ranks")
    saved = ckpt_lib.load(os.path.join(run_dir, "ckpt", f"step_{steps}.ckpt"))
    with open(os.path.join(run_dir, "eval", "logs", "metrics.jsonl")) as f:
        aux = [json.loads(line) for line in f]
    check(saved["step"] == steps
          and [a["step"] for a in aux] == list(range(1, steps + 1)),
          f"dp {label} train_cli: step {saved['step']}, metric lines of "
          f"steps {[a['step'] for a in aux]}")
    print(f"dp {label}: train_cli on {nproc} ranks ({backend}, {device}), "
          f"{steps} steps in {wall:.2f} s of launcher wall: rank 0 wrote "
          f"step_{steps}.ckpt and {len(aux)} metric lines [{card}]")
    return dict(params=saved["model"], optimizer=saved["optimizer"],
                rng=saved["rng"], aux=aux)


def dp_launches_ok(results: list[dict], cfg, steps: int, label: str,
                   on_card: bool):
    """Each rank ran every block's forward twice (remat) and each backward
    kernel once per window of its batch, all on the tensor-core route (none
    off the card)."""
    B, blocks = cfg.experiment.batch_size, cfg.model.ipa.num_blocks
    per_step = B * blocks if on_card else 0
    want = dict(launches=2 * per_step * steps, bwd_dq_launches=per_step * steps,
                bwd_dkv_launches=per_step * steps,
                bwd_pair_launches=per_step * steps, wide_launches=0,
                wide_bwd_dq_launches=0, wide_bwd_dkv_launches=0,
                wide_bwd_pair_launches=0)
    for res in results:
        check(res["launches"] == want, f"dp {label}: rank {res['rank']} "
              f"launched {res['launches']}, expected {want}")


def state_gaps(torch, label: str, got: dict, want: dict,
               start: dict) -> dict:
    """The distance of ``got``'s update (its parameters' move from
    ``start``) and of each of its gathered AMSGrad moments from ``want``'s,
    over the norm of ``want``'s, each over the whole model."""
    diff2 = norm2 = 0.0
    for name, w in want["model"].items():
        g = got["params"][name].to(w.dtype)
        diff2 += float((g - w).double().pow(2).sum())
        norm2 += float((w - start[name]).double().pow(2).sum())
    gaps = {"update": math.sqrt(diff2) / max(math.sqrt(norm2), 1e-30)}
    sg, sw = got["optimizer"]["state"], want["optimizer"]["state"]
    check(sorted(sg) == sorted(sw), f"dp {label}: optimizer state of "
          f"{len(sg)} tensors, one process has {len(sw)}")
    for k in sorted({k for st in sw.values() for k in st}):
        diff2 = norm2 = 0.0
        for i, st in sw.items():
            if k not in st:  # an EMA without moments: never a gradient
                continue
            w, g = st[k].float().cpu(), sg[i][k].float().cpu()
            check(g.shape == w.shape, f"dp {label}: moment {i} {k} has shape "
                  f"{tuple(g.shape)}, not {tuple(w.shape)}")
            diff2 += float((g - w).double().pow(2).sum())
            norm2 += float(w.double().pow(2).sum())
        gaps[k] = math.sqrt(diff2) / max(math.sqrt(norm2), 1e-30)
    missing = sorted(gaps.keys() - DP_GAP_BOUNDS.keys())
    check(not missing, f"dp {label}: no bound for {missing}")
    return gaps


def dp_against_one_process(torch, label: str, got: dict, want: dict,
                           start: dict, control: dict | None = None):
    """``got`` (params, optimizer with gathered moments, per-step aux)
    against the one-process run ``want`` (model, optimizer, aux): each
    step's loss and grad norm, the update and each moment within
    ``DP_GAP_BOUNDS``; a ``control`` run must read past every bound."""
    for i, (g, w) in enumerate(zip(got["aux"], want["aux"])):
        for k in ("total_loss", "grad_norm"):
            err = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            check(err <= DP_LOSS_RTOL, f"dp {label}: step {i + 1} {k} "
                  f"{g[k]} against {w[k]} (relative {err:.3e})")
    gaps = state_gaps(torch, label, got, want, start)
    for k, v in gaps.items():
        check(v <= DP_GAP_BOUNDS[k], f"dp {label}: {k} is {v:.3e} of its "
              f"norm from one process's (bound {DP_GAP_BOUNDS[k]})")
    line = {k: float(f"{v:.4g}") for k, v in gaps.items()}
    if control is not None:
        far = state_gaps(torch, f"{label} control", control, want, start)
        for k, v in far.items():
            check(v > DP_GAP_BOUNDS[k], f"dp {label}: the control reads {k} "
                  f"{v:.3e} of its norm, within its bound "
                  f"{DP_GAP_BOUNDS[k]}: the bound would not catch it")
        line = {k: (v, float(f"{far[k]:.4g}")) for k, v in line.items()}
    print(f"dp {label}: against one process, of their norms: "
          f"{line}{' (reading, control)' if control is not None else ''}, "
          f"bounds {DP_GAP_BOUNDS}; losses "
          f"{[a['total_loss'] for a in got['aux']]} against "
          f"{[a['total_loss'] for a in want['aux']]}")


def equal_to(torch, label: str, got: dict, want: dict):
    """Bit-equal parameters and gathered moments."""
    for k, v in want["model"].items():
        check(torch.equal(got["params"][k].cpu(), v.cpu()),
              f"dp {label}: {k} differs")
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            check(torch.equal(got["optimizer"]["state"][i][k].cpu(), v.cpu()),
                  f"dp {label}: moment {i} {k} differs")


def max_param_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float().to(a[k].device)).abs().max())
               for k in a)


def dp_phase(torch, config: str, train: dict, tmp: str, card: str,
             device: str = "cuda", extra: tuple = ()) -> dict:
    """8a: train_cli on two gloo ranks sharing cuda:0 at B = 4 each (ZeRO
    on, the default) against phase 4's one process at B = 8, the same
    manifest, seed and steps, with a control at B = 4 in one process; then
    the same steps through tools/dp_step.py, for each rank's launches,
    seconds and memory, bit-equal to train_cli's; 8b: dp_step with ZeRO
    off, whose parameters must equal 8a's; 8c: train_cli under a launcher
    at world 1 on NCCL with experiment.mesh_shape=(1,), whose checkpoint
    must equal, bit for bit, a run without a launcher or mesh; 8d: two
    ranks on a (1, 2) ('data', 'model') mesh at B = 8 each, whose ranks run
    one process's rows and sums: bit-equal to phase 4, and within the
    bounds of 8a. ``extra``: phase 4's config overrides (a CPU rehearsal
    runs a small width)."""
    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib
    from dynamicpdb_tpu_torch.weights import init_like_jax_

    extra = list(extra)
    cfg = load_yaml(config, extra)
    on_card = device == "cuda"
    rank_device = "cuda:0" if on_card else device
    steps = len(train["steps"])
    one = ckpt_lib.load(train["ckpt"])
    want = dict(model=one["model"], optimizer=one["optimizer"],
                aux=train["steps"])
    start = init_like_jax_(DFoldScoreNetwork(cfg.model, device="cpu"),
                           cfg.experiment.seed).state_dict()
    half = extra + [f"experiment.batch_size={cfg.experiment.batch_size // 2}"]

    # 8a: the real entry point on two ranks, against one process
    cli = dp_train_cli(torch, "8a", 2, tmp, train["csv"], config, half,
                       steps, card, rank_device, "gloo")
    check(torch.equal(cli["rng"], one["rng"]), "dp 8a: the ranks' noise "
          "generator left one process's")
    out = os.path.join(tmp, "8a-control")
    run_command([sys.executable, "-m", "dynamicpdb_tpu_torch.tools.dp_step",
                 "--config", config, "--device", rank_device, "--steps",
                 str(steps), "--csv", train["csv"], "--out", out, *half],
                "dp 8a control")
    control = torch.load(os.path.join(out, "rank0.pt"), weights_only=True)
    dp_against_one_process(torch, "8a", cli, want, start, control)
    # the same steps through dp_step: each rank's launches and memory
    a = dp_run(torch, "8a", 2, tmp, train["csv"], config, half, steps, card,
               rank_device)
    dp_launches_ok(a, load_yaml(config, half), steps, "8a", on_card)
    check(max_param_diff(a[0]["params"], a[1]["params"]) == 0.0,
          "dp 8a: the two ranks' parameters differ")
    check(torch.equal(a[0]["rng"], a[1]["rng"]), "dp 8a: the ranks' noise "
          "generators left lock step")
    equal_to(torch, "8a dp_step against train_cli", a[0],
             dict(model=cli["params"], optimizer=cli["optimizer"]))
    check([x["total_loss"] for x in a[0]["aux"]]
          == [x["total_loss"] for x in cli["aux"]], "dp 8a: dp_step's losses "
          "differ from train_cli's")
    print("dp 8a: dp_step's ranks equal train_cli's checkpoint bit for bit")

    # 8b
    b = dp_run(torch, "8b", 2, tmp, train["csv"], config,
               half + ["experiment.zero_opt_state=false"], steps, card,
               rank_device)
    diff = max_param_diff(a[0]["params"], b[0]["params"])
    print(f"dp 8b: ZeRO off against on: parameters differ by at most "
          f"{diff:.3e} (bound 0: the AMSGrad update is elementwise)")
    equal_to(torch, "8b", b[0], dict(model=a[0]["params"],
                                     optimizer=a[0]["optimizer"]))

    # 8c
    base = ["--config", config, "--max-steps", "2", "--device", device,
            *extra, f"data.csv_path={train['csv']}"]
    ckpts = {}
    for name, cmd, mesh_args in (
            ("launcher", LAUNCHER + ["--nproc_per_node=1", "-m"],
             ["experiment.mesh_shape=(1,)"]),
            ("plain", [sys.executable, "-m"], [])):
        run_dir = os.path.join(tmp, f"8c-{name}")
        t0 = time.perf_counter()
        out = run_command(cmd + ["dynamicpdb_tpu_torch.train_cli", *base,
                                 f"experiment.ckpt_dir={run_dir}/ckpt",
                                 f"experiment.eval_dir={run_dir}/eval",
                                 *mesh_args], f"dp 8c {name}")
        print(f"dp 8c: train_cli {name}, 2 steps, in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        if name == "launcher":
            check("mesh=Mesh({'data': 1}" in out, "dp 8c: train_cli under "
                  "the launcher did not build the (1,) mesh")
        ckpts[name] = ckpt_lib.load(os.path.join(run_dir, "ckpt",
                                                 "step_2.ckpt"))
    got, ref = ckpts["launcher"], ckpts["plain"]
    for k, v in ref["model"].items():
        check(torch.equal(got["model"][k], v), f"dp 8c: {k} differs between "
              "NCCL at world 1 and no launcher")
    for i, st in ref["optimizer"]["state"].items():
        for k, v in st.items():
            check(torch.equal(got["optimizer"]["state"][i][k], v),
                  f"dp 8c: moment {i} {k} differs")
    check(torch.equal(got["rng"], ref["rng"]), "dp 8c: generator states differ")
    print("dp 8c: NCCL at world 1 through train_cli: the checkpoint equals "
          "the run without a launcher, bit for bit")

    # 8d
    d = dp_run(torch, "8d", 2, tmp, train["csv"], config,
               extra + ["experiment.mesh_shape=(1,2)",
                        "experiment.mesh_axes=(data,model)"], steps, card,
               rank_device)
    dp_launches_ok(d, cfg, steps, "8d", on_card)
    diff = max_param_diff(d[0]["params"], d[1]["params"])
    check(diff == 0.0, f"dp 8d: the 'model' ranks' parameters differ by {diff}")
    # the 'model' ranks run one process's rows and sums: bit-equal to it
    equal_to(torch, "8d", d[0], want)
    check([x["total_loss"] for x in d[0]["aux"]]
          == [x["total_loss"] for x in want["aux"]], "dp 8d: losses differ "
          "from one process's")
    print("dp 8d: ('data', 'model') = (1, 2): parameters and moments equal "
          "one process's bit for bit")
    dp_against_one_process(torch, "8d against 8a", d[0], dict(
        model=a[0]["params"], optimizer=a[0]["optimizer"], aux=a[0]["aux"]),
        start)
    print(f"dp 8d: per-rank peak memory {[r['peak_bytes'] / 2**30 for r in d]}"
          f" GiB against 8a's {[r['peak_bytes'] / 2**30 for r in a]}; held "
          f"between steps {[r['state_bytes'] / 2**30 for r in d]} against "
          f"{[r['state_bytes'] / 2**30 for r in a]} (8b, ZeRO off: "
          f"{[r['state_bytes'] / 2**30 for r in b]}) GiB [{card}]")
    return dict(a=a, b=b, d=d)


def dp_cards_phase(torch, card: str, device: str = "cuda",
                   extra: tuple = ()) -> dict:
    """``chip_smoke.py --dp-cards``: data parallel over every card of the
    host on NCCL, one rank a card, at the release config and phase 4's
    bundles, global B = 8, 3 steps: one process on one card, then every
    card with ZeRO (B = 8 / n a rank), without, and on an (n / 2, 2)
    ('data', 'model') mesh (B = 16 / n); each against the one process
    with phase 8's bounds, each rank's replicas equal, ZeRO off equal to
    on; then train_cli on every card with ZeRO, within the same bounds and
    equal to dp_step's ZeRO run bit for bit. ``device="cpu"``
    rehearses it with gloo on 4 processes at a small width (``extra``)."""
    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.weights import init_like_jax_

    on_card = device == "cuda"
    backend = "nccl" if on_card else "gloo"
    n = torch.cuda.device_count() if on_card else 4
    check(n >= 2 and n % 2 == 0, f"--dp-cards needs an even number of cards "
          f"(at least 2), not {n}")
    extra = list(extra)
    config = os.path.join("configs",
                          "release.yaml" if on_card else "tiny.yaml")
    cfg = load_yaml(config, extra)
    B, steps = 8, 3
    start = init_like_jax_(DFoldScoreNetwork(cfg.model, device="cpu"),
                           cfg.experiment.seed).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        csv = write_manifest(tmp, (256, 200) if on_card else (12, 10),
                             8 if on_card else 6)
        out = os.path.join(tmp, "one")
        run_command([sys.executable, "-m", "dynamicpdb_tpu_torch.tools.dp_step",
                     "--config", config, "--device", device, "--steps",
                     str(steps), "--csv", csv, "--out", out, *extra,
                     f"experiment.batch_size={B}"], "dp one process")
        one = torch.load(os.path.join(out, "rank0.pt"), weights_only=True)
        print(f"dp one process B={B}: step seconds {one['seconds']}, peak "
              f"{one['peak_bytes'] / 2**30:.3f} GiB, held "
              f"{one['state_bytes'] / 2**30:.3f} GiB [{card}]")
        want = dict(model=one["params"], optimizer=one["optimizer"],
                    aux=one["aux"])
        runs = {
            "zero": [f"experiment.batch_size={B // n}"],
            "no-zero": [f"experiment.batch_size={B // n}",
                        "experiment.zero_opt_state=false"],
            "data-model": [f"experiment.batch_size={2 * B // n}",
                           f"experiment.mesh_shape=({n // 2},2)",
                           "experiment.mesh_axes=(data,model)"],
        }
        res = {}
        for label, ov in runs.items():
            res[label] = r = dp_run(torch, f"x{n} {label}", n, tmp, csv,
                                    config, extra + ov, steps, card, device,
                                    backend)
            dp_launches_ok(r, load_yaml(config, extra + ov), steps, label,
                           on_card)
            for other in r[1:]:
                equal_to(torch, f"x{n} {label} rank {other['rank']}", other,
                         dict(model=r[0]["params"],
                              optimizer=r[0]["optimizer"]))
            dp_against_one_process(torch, f"x{n} {label}", r[0], want, start)
        equal_to(torch, f"x{n} ZeRO off against on", res["no-zero"][0],
                 dict(model=res["zero"][0]["params"],
                      optimizer=res["zero"][0]["optimizer"]))
        print(f"dp x{n}: ZeRO off equals ZeRO on, bit for bit")
        # the real entry point on every card, ZeRO on: dp_step's twin
        cli = dp_train_cli(torch, f"x{n}", n, tmp, csv, config,
                           extra + runs["zero"], steps, card, device, backend)
        dp_against_one_process(torch, f"x{n} train_cli", cli, want, start)
        equal_to(torch, f"x{n} train_cli against dp_step", res["zero"][0],
                 dict(model=cli["params"], optimizer=cli["optimizer"]))
        check(torch.equal(cli["rng"], one["rng"]), f"dp x{n} train_cli: the "
              "noise generator left one process's")
    return res


# ---------------------------------------------------------------------------
# phase 4b: the wide IPA route in a model
# ---------------------------------------------------------------------------
# the release model with the IPA widths past the tensor-core kernels'
# (C = 384, Pq*3 = 36, Dz = 64): it runs the wide kernels
WIDE_MODEL = ["model.edge_embed_size=256", "model.ipa.c_z=256",
              "model.ipa.c_hidden=384", "model.ipa.no_qk_points=12"]
# depth 1, float32, for the card-against-CPU gradients
WIDE_OVERRIDES = WIDE_MODEL + [
    "model.ipa.num_blocks=1",
    f"diffuser.so3.cache_dir={os.path.join(ROOT, '.cache', 'igso3')}",
]


# ---------------------------------------------------------------------------
# phase 6: evaluation
# ---------------------------------------------------------------------------
def forwards_per_protein(num_t: int, cfg_gamma) -> int:
    """Model forwards of one reverse_sample: num_t, and one more for each
    of the num_t - 1 SDE steps with classifier-free guidance."""
    return num_t + (num_t - 1 if cfg_gamma is not None else 0)


def eval_phase(device: str, config: str, ckpt: str, csv: str,
               extra: list[str], tmp: str, tag: str = "") -> dict:
    """The eval slice on a train_cli checkpoint of ``config`` (release
    width on the card): eval_cli over the proteins of ``csv`` (every
    metric finite, the IPA forward launched once per block and forward on
    the card, never on the CPU);
    eval_cli --extension 4 --save-dcd (the DCD read back with the
    topology's atom count and 4 frames); then ``evaluate`` one protein at a
    time, plain and with classifier-free guidance and aux_traj, for the
    seconds per protein."""
    import torch

    from dynamicpdb_tpu_torch import eval_cli
    from dynamicpdb_tpu_torch.analysis.pdb_io import read_pdb
    from dynamicpdb_tpu_torch.train_cli import EVAL_METRICS
    from dynamicpdb_tpu_torch.data.dataset import (
        TrajectoryDataset,
        eval_windows,
    )
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.preprocess.dcd import read_dcd
    from dynamicpdb_tpu_torch.sampling.evaluate import evaluate

    base = ["--ckpt", ckpt, "--config", config, "--device", device,
            f"data.test_csv_path={csv}", *extra]
    on_card = device == "cuda"
    os.makedirs(tmp, exist_ok=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_ipa_counts(ipa_mod)  # eval_cli's path starts
    t0 = time.perf_counter()
    res = eval_cli.main(base + ["--metrics-json",
                                os.path.join(tmp, "metrics.json")])
    wall = time.perf_counter() - t0
    counts = ipa_counts(ipa_mod)
    args = eval_cli.parse_args(base)
    cfg, trainer = eval_cli.load_model(args, eval_cli.config_from_args(args),
                                       torch.device(device))
    n_prot, num_t = len(res["rows"]), cfg.data.num_t
    blocks = cfg.model.ipa.num_blocks if on_card else 0
    cfg_gamma = cfg.model.cfg_gamma if cfg.model.cfg_drop_rate > 0.01 else None
    expect = n_prot * blocks * forwards_per_protein(num_t, cfg_gamma)
    check(n_prot == 2, f"eval: {n_prot} rows, not 2")
    check(counts["ipa_attention_fwd"] == (expect, 0), f"eval: IPA forward "
          f"launches {counts['ipa_attention_fwd']}, expected ({expect}, 0)")
    for row in res["rows"]:
        bad = {k: v for k, v in row.items() if k != "name"
               and not math.isfinite(v)}
        check(not bad, f"eval: {row['name']} non-finite {bad}")
        print(f"eval: {row['name']}: " + " ".join(
            f"{k}={row[k]:.4f}" for k in EVAL_METRICS))
    with open(os.path.join(tmp, "metrics.json")) as f:
        check(json.load(f)["means"] == res["means"], "eval: --metrics-json "
              "differs from the returned means")
    print(f"eval: eval_cli, {n_prot} proteins, num_t={num_t}, cfg_gamma="
          f"{cfg_gamma}: {wall:.3f} s of the CLI (weights loaded included), "
          f"IPA forward launches {counts['ipa_attention_fwd'][0]}{tag}")

    ext_dir = os.path.join(tmp, "extension")
    reset_ipa_counts(ipa_mod)
    t0 = time.perf_counter()
    out = eval_cli.main(base + ["--extension", "4", "--save-dcd",
                                "--save-dir", ext_dir])
    ext_wall = time.perf_counter() - t0
    launched = ipa_counts(ipa_mod)["ipa_attention_fwd"]
    check(launched == (n_prot * 4 * num_t * blocks, 0), f"eval extension: "
          f"IPA forward launches {launched}")
    for path in out["extension"]:
        stem = path[:-len("_extension.npz")]
        topo = read_pdb(f"{stem}_topology.pdb")
        xyz = read_dcd(f"{stem}_extension.dcd")["xyz"]
        n_atoms = int(topo[1].sum())
        check(xyz.shape == (4, n_atoms, 3) and np.isfinite(xyz).all(),
              f"eval extension: {stem}.dcd holds {xyz.shape}, the topology "
              f"{n_atoms} atoms")
        print(f"eval extension: {os.path.basename(stem)}: 4 frames x "
              f"{n_atoms} atoms read back from the DCD")
    print(f"eval extension: --extension 4 --save-dcd, {n_prot} proteins in "
          f"{ext_wall:.3f} s of the CLI, {launched[0]} IPA forward launches"
          f"{tag}")

    # evaluate one protein at a time: plain, then guided with aux_traj
    dataset = TrajectoryDataset(cfg.data, split="test",
                                pad_to=cfg.data.filtering.max_len)
    windows = list(eval_windows(dataset))
    timing = {}
    for label, gamma, aux in (("plain", cfg_gamma, False),
                              ("cfg", 2.0, True)):
        seconds = []
        for w in windows:
            reset_ipa_counts(ipa_mod)
            g = torch.Generator(device=device).manual_seed(0)
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows, _ = evaluate(trainer.model, trainer.diffuser, [w],
                               num_t=num_t, min_t=cfg.data.min_t,
                               noise_scale=cfg.experiment.noise_scale,
                               cfg_gamma=gamma, aux_traj=aux,
                               save_dir=os.path.join(tmp, label) if aux
                               else None, generator=g)
            seconds.append(time.perf_counter() - t0)  # rows are floats
            n_fwd = blocks * forwards_per_protein(num_t, gamma)
            launched = ipa_counts(ipa_mod)["ipa_attention_fwd"]
            check(launched == (n_fwd, 0), f"evaluate {label}: IPA forward "
                  f"launches {launched}, expected ({n_fwd}, 0)")
            if aux:
                with np.load(os.path.join(tmp, label,
                                          f"{w['name']}_pred.npz")) as z:
                    traj = z["prot_traj"]
                check(traj.shape[0] == num_t and np.isfinite(traj).all(),
                      f"evaluate cfg: prot_traj {traj.shape}, finite "
                      f"{np.isfinite(traj).all()}")
        timing[label] = seconds
        print(f"eval: evaluate {label} (cfg_gamma={gamma}, aux_traj={aux}): "
              f"s per protein {[round(x, 4) for x in seconds]} (N="
              f"{cfg.data.filtering.max_len} padded), {n_fwd} IPA forward "
              f"launches each{tag}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"eval: peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB"
          f"{tag}")
    return dict(rows=res["rows"], seconds=timing, peak_bytes=peak,
                launches=counts["ipa_attention_fwd"][0])


# card against CPU on the metric rows: float32 with TF32 off on both, the
# rows are means over residues of one x0 prediction, whose coordinates
# agree to 1e-3 of their scale (phase 3's small check): 2e-3 relative, and
# 2e-3 absolute. Every angle compared is degrees from zero (the weights are
# random and the residues rotate from frame to frame), where
# 2 acos(|<q1, q2>|) is well conditioned
EVAL_RTOL, EVAL_ATOL = 2e-3, 2e-3
# radians of the correlated per-residue rotation each synthetic frame adds
# (make_window's rot_wiggle): the reference's last two frames then differ
# by degrees, so ref_ave_rot measures something
EVAL_ROT_WIGGLE = 0.1
# a reference-format copy of the same weights runs the same arithmetic
EVAL_REF_RTOL = 1e-5
SMALL_EVAL = SMALL_OVERRIDES + [
    # the synthetic bundles carry embeddings of the release widths
    "model.node_repr_dim=256", "model.edge_repr_dim=128",
    "model.cfg_drop_rate=0.1", "experiment.ema_decay=0.99",
    "experiment.batch_size=2", "data.filtering.max_len=16", "data.num_t=3",
]


def _rows_close(a: list, b: list, rtol: float, atol: float,
                label: str) -> tuple[float, dict]:
    """Every metric of rows ``a`` within ``atol`` + ``rtol`` x |b| of
    ``b``'s; returns the worst ratio of error to tolerance and each
    metric's largest absolute gap."""
    check([r["name"] for r in a] == [r["name"] for r in b],
          f"{label}: rows {[r['name'] for r in a]} {[r['name'] for r in b]}")
    worst, gaps = 0.0, {}
    for ra, rb in zip(a, b):
        for k, v in rb.items():
            if k == "name" or (math.isnan(v) and math.isnan(ra[k])):
                continue
            err = abs(ra[k] - v)
            tol = atol + rtol * abs(v)
            check(err <= tol, f"{label}: {rb['name']} {k} {ra[k]} vs {v}")
            worst = max(worst, err / tol if tol else 0.0)
            gaps[k] = max(gaps.get(k, 0.0), err)
    return worst, gaps


def write_reference_checkpoint(ckpt: str, model_cfg, path: str) -> str:
    """The EMA weights of train_cli checkpoint ``ckpt`` in the reference's
    format: 'module.' prefixes, the dead embedding_layer.* entries (the
    reference embedder's LayerNorms and time projections) and a pickled
    conf object whose class does not import when the file is read."""
    import types

    import torch

    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.train.checkpoint import restore
    from dynamicpdb_tpu_torch.train.optim import AMSGrad, ema_state_dict

    model = DFoldScoreNetwork(model_cfg, device="cpu")
    opt = AMSGrad(model.parameters(), 1e-4)
    restore(ckpt, model, opt)
    sd = ema_state_dict(opt, model)
    ns, es = model_cfg.node_embed_size, model_cfg.edge_embed_size
    for name, d_out in (("node", ns), ("edge", es)):
        pre = f"embedding_layer.{name}_timestep_proj"
        sd[f"{pre}.0.weight"] = torch.zeros(d_out // 2, ns)
        sd[f"{pre}.0.bias"] = torch.zeros(d_out // 2)
        sd[f"{pre}.2.weight"] = torch.zeros(d_out, d_out // 2)
        sd[f"{pre}.2.bias"] = torch.zeros(d_out)
        sd[f"embedding_layer.{name}_ln.weight"] = torch.ones(d_out)
        sd[f"embedding_layer.{name}_ln.bias"] = torch.zeros(d_out)
    mod = types.ModuleType("reference_conf_absent_at_load")
    conf_cls = type("DictConfig", (), {"__module__": mod.__name__})
    mod.DictConfig = conf_cls
    conf = conf_cls()
    conf.model = {"ipa": {"c_s": model_cfg.ipa.c_s}}
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                    "conf": conf, "optimizer": None, "epoch": 0, "step": 1},
                   path)
    finally:
        del sys.modules[mod.__name__]
    return path


def eval_card_vs_cpu(tmp: str, devices=("cuda", "cpu")) -> dict:
    """A small model (classifier-free guidance on, EMA kept) with seeded
    random weights (weights.randomize_: its zero-initialised backbone
    update then moves the frames), trained one step on the CPU from them on
    trajectories whose residues rotate (EVAL_ROT_WIGGLE), evaluated by
    eval_cli --ema on each device, and again through --ref-ckpt from a
    reference-format file of the same EMA weights: the rows of the two
    devices agree (EVAL_RTOL, EVAL_ATOL), and each device's --ref-ckpt rows
    equal its --ema rows (EVAL_REF_RTOL)."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch import eval_cli, train_cli
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib
    from dynamicpdb_tpu_torch.train.experiment import Trainer
    from dynamicpdb_tpu_torch.train.optim import make_optimizer
    from dynamicpdb_tpu_torch.train_cli import EVAL_METRICS
    from dynamicpdb_tpu_torch.weights import randomize_

    os.makedirs(tmp, exist_ok=True)
    csv = write_manifest(tmp, (16, 12), n_frames=6, seed=3,
                         rot_wiggle=EVAL_ROT_WIGGLE)
    cfg = config_lib.apply_overrides(config_lib.Config(), SMALL_EVAL)
    init = Trainer(cfg, device="cpu")
    with torch.no_grad():
        randomize_(init.model, seed=5)
    # the EMA starts at the parameters the optimizer is made with
    opt = make_optimizer(init.model.parameters(), cfg.experiment)
    start = os.path.join(tmp, "random_init.ckpt")
    ckpt_lib.save(start, init.model, opt, step=0, epoch=0)
    exp = train_cli.main(["--max-steps", "1", "--device", "cpu",
                          f"data.csv_path={csv}",
                          f"experiment.ckpt_dir={os.path.join(tmp, 'ckpt')}",
                          f"experiment.eval_dir={os.path.join(tmp, 'logs')}",
                          f"experiment.warm_start={start}", *SMALL_EVAL])
    ckpt = os.path.join(tmp, "ckpt", "step_1.ckpt")
    ref = write_reference_checkpoint(ckpt, cfg.model,
                                     os.path.join(tmp, "reference.pth"))
    out = {}
    for dev in devices:
        common = ["--device", dev, f"data.csv_path={csv}", *SMALL_EVAL]
        out[dev] = eval_cli.main(["--ckpt", ckpt, "--ema"] + common)
        out[f"{dev}-ref"] = eval_cli.main(["--ckpt", ref, "--ref-ckpt"]
                                          + common)
        worst, _ = _rows_close(out[f"{dev}-ref"]["rows"], out[dev]["rows"],
                               EVAL_REF_RTOL, 0.0, f"eval {dev} --ref-ckpt")
        print(f"eval {dev}: --ema and --ref-ckpt rows agree (worst "
              f"{worst:.3f} of tol {EVAL_REF_RTOL:.0e} relative); step "
              f"{exp.step}, cfg_gamma {cfg.model.cfg_gamma}")
        for row in out[dev]["rows"]:
            print(f"eval {dev}: {row['name']}: " + " ".join(
                f"{k}={row[k]:.5f}" for k in EVAL_METRICS + ("ref_ave_rot",)))
    if len(devices) == 2:
        worst, gaps = _rows_close(out[devices[0]]["rows"],
                                  out[devices[1]]["rows"], EVAL_RTOL,
                                  EVAL_ATOL, "eval card vs CPU")
        print("eval card vs CPU: largest gap per metric " + " ".join(
            f"{k}={v:.3e}" for k, v in gaps.items()))
        print(f"eval card vs CPU: every metric of {len(out['cuda']['rows'])} "
              f"rows agrees (worst {worst:.3f} of its tol {EVAL_RTOL:.0e} "
              f"relative + {EVAL_ATOL:.0e})")
    return out


# ---------------------------------------------------------------------------
# phase 5: OmegaFold embedding extraction
# ---------------------------------------------------------------------------
RESTYPES = "ARNDCQEGHILKMFPSTWYV"


def extract_phase(device: str, cfg, *, lengths, num_cycles: int,
                  num_pseudo_msa: int, pad_multiple: int, tmp: str,
                  seed: int = 0, dtype: str = "float32", tag: str = "") -> dict:
    """Seeded random weights at ``cfg`` -> torch.save -> the extraction
    CLI's main on random sequences of ``lengths``. Checks every npz against
    the DFOLD contract (validate) and the kernel launch counts (every
    cycle runs each GeoFormer block's attention with edge bias once and its
    geom_count geometric attentions; none on the CPU). Returns the records,
    counts, parameter count, peak device memory and the npz arrays."""
    import torch

    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
    from dynamicpdb_tpu_torch.preprocess import extract_embeddings as cli
    from dynamicpdb_tpu_torch.preprocess.embeddings import validate
    from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict

    t0 = time.perf_counter()
    sd = random_omegafold_state_dict(cfg, seed)
    n_params = sum(v.size for v in sd.values())
    ckpt = os.path.join(tmp, f"omegafold_{device}.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    del sd
    gb = os.path.getsize(ckpt) / 1e9
    print(f"extract: {n_params:,} parameters, {gb:.2f} GB checkpoint written "
          f"in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    fasta = os.path.join(tmp, "seqs.fasta")
    with open(fasta, "w") as f:
        for i, n in enumerate(lengths):
            f.write(f">seq{i}_{n}\n{''.join(rng.choice(list(RESTYPES), n))}\n")
    out_dir = os.path.join(tmp, f"npz_{device}_{dtype}")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    geom_mod.geom_launches = geom_mod.node_launches = 0  # the path starts
    t0 = time.perf_counter()
    records = cli.main(["--fasta", fasta, "--out-dir", out_dir, "--weights",
                        ckpt, "--num-cycles", str(num_cycles),
                        "--num-pseudo-msa", str(num_pseudo_msa),
                        "--pad-multiple", str(pad_multiple), "--device",
                        device, "--dtype", dtype])
    wall = time.perf_counter() - t0
    launched = {"geom_attention": geom_mod.geom_launches,
                "node_attention": geom_mod.node_launches}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    per_cycle = cfg.geo_num_blocks if on_card else 0
    expect = {"geom_attention": len(lengths) * num_cycles * per_cycle
              * cfg.geom_count,
              "node_attention": len(lengths) * num_cycles * per_cycle}
    check(launched == expect, f"extract: kernel launches {launched}, "
          f"expected {expect}")
    check(sorted(r["n_res"] for r in records) == sorted(lengths),
          f"extract: sequences {[r['n_res'] for r in records]}")
    arrays = {}
    for r in records:
        validate(r["path"], n_res=r["n_res"])
        with np.load(r["path"]) as z:
            arrays[r["name"]] = {k: z[k] for k in z.files}
        print(f"extract: {r['name']} n_res={r['n_res']} padded={r['padded']}"
              f" {num_cycles} cycles x {num_pseudo_msa + 1} pseudo-MSA rows: "
              f"{r['seconds']:.3f} s, {num_cycles / r['seconds']:.2f} cycles/s"
              f", cycle {r['cycle']} selected (confidences "
              f"{[round(c, 5) for c in r['confidences']]}){tag}")
    print(f"extract: {len(records)} sequences in {wall:.2f} s of the CLI "
          f"(weights loaded and moved included); peak "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB; kernel "
          f"launches {launched}{tag}")
    return dict(records=records, launches=launched, params=n_params,
                peak_bytes=peak, wall=wall, arrays=arrays, ckpt=ckpt)


# card against CPU: float32 with TF32 off on both, sums in other orders
# through the PLM, the GeoFormer, the structure module and two recycles:
# 1e-3 of each output's largest magnitude; confidences 1e-4
EXTRACT_RTOL = 1e-3
EXTRACT_CONF_ATOL = 1e-4
# bfloat16 against float32 on the card: the JAX package's bar for its bf16
# path (tests/test_omegafold_model.py), a mean error under 0.1 of the mean
# magnitude
EXTRACT_BF16_RTOL = 0.1


def extract_card_vs_cpu(tmp: str) -> None:
    """The extraction CLI at the release widths and a reduced depth (2 PLM
    layers, 2 GeoFormer blocks, 2 structure cycles; N = 40, 4 pseudo-MSA
    rows, 2 cycles) on the card and on the CPU: every output must agree and
    the same cycle must be selected. Then --dtype bfloat16 on the card
    against float32 on the card."""
    from dynamicpdb_tpu_torch.models.omegafold.model import (
        OmegaFoldConfig,
        StructConfig,
    )
    from dynamicpdb_tpu_torch.models.omegafold.plm import PLMConfig

    cfg = OmegaFoldConfig(plm=PLMConfig(num_layers=2), geo_num_blocks=2,
                          struct=StructConfig(num_cycle=2))
    runs = {dev: extract_phase(dev, cfg, lengths=(40,), num_cycles=2,
                               num_pseudo_msa=3, pad_multiple=0, tmp=tmp,
                               seed=1)
            for dev in ("cuda", "cpu")}
    for rec_gpu, rec_cpu in zip(runs["cuda"]["records"], runs["cpu"]["records"]):
        check(rec_gpu["cycle"] == rec_cpu["cycle"], f"extract card vs CPU: "
              f"cycle {rec_gpu['cycle']} selected on the card, "
              f"{rec_cpu['cycle']} on the CPU")
        a, b = runs["cuda"]["arrays"][rec_gpu["name"]], \
            runs["cpu"]["arrays"][rec_cpu["name"]]
        for key in ("node_repr", "edge_repr", "confidence"):
            err = float(np.abs(a[key] - b[key]).max())
            tol = (EXTRACT_CONF_ATOL if key == "confidence" else
                   EXTRACT_RTOL * max(1.0, float(np.abs(b[key]).max())))
            print(f"extract card vs CPU: {key} max_abs_err {err:.3e} tol "
                  f"{tol:.3e}")
            check(err <= tol, f"extract card vs CPU: {key} {err} > {tol}")
        conf_err = max(abs(x - y) for x, y in zip(rec_gpu["confidences"],
                                                   rec_cpu["confidences"]))
        check(conf_err <= EXTRACT_CONF_ATOL, f"extract card vs CPU: cycle "
              f"confidences differ by {conf_err}")
        print(f"extract card vs CPU: cycle {rec_gpu['cycle']} selected on "
              f"both; per-cycle confidences within {conf_err:.3e}")
    bf16 = extract_phase("cuda", cfg, lengths=(40,), num_cycles=2,
                         num_pseudo_msa=3, pad_multiple=0, tmp=tmp, seed=1,
                         dtype="bfloat16")
    for name, b in bf16["arrays"].items():
        a = runs["cuda"]["arrays"][name]
        for key in ("node_repr", "edge_repr"):
            err = float(np.abs(b[key] - a[key]).mean())
            tol = EXTRACT_BF16_RTOL * float(np.abs(a[key]).mean())
            print(f"extract bfloat16 vs float32 on the card: {key} mean abs "
                  f"err {err:.3e} tol {tol:.3e} (max abs err "
                  f"{float(np.abs(b[key] - a[key]).max()):.3e})")
            check(err <= tol, f"extract bf16 vs f32: {key} {err} > {tol}")


# ---------------------------------------------------------------------------
# phase 7: structure prediction through fold_cli
# ---------------------------------------------------------------------------
def pdb_b_factors(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([float(line[60:66]) for line in f
                           if line.startswith("ATOM")])


def fold_phase(device: str, cfg, ckpt: str, *, lengths, num_cycles: int,
               num_pseudo_msa: int, pad_multiple: int, tmp: str,
               seed: int = 0, tag: str = "") -> dict:
    """fold_cli.main on random sequences of ``lengths`` with the OmegaFold
    checkpoint ``ckpt`` (of ``cfg``): one PDB per sequence that reads back
    with the sequence's residues, finite coordinates and B-factors = pLDDT
    x 100 in [0, 100] whose mean is the sidecar's mean_plddt, a sidecar
    with a confidence in [0, 1], and the launch counts of both GeoFormer
    attention kernels (as extraction's; none on the CPU). Returns the
    records, counts and times."""
    import torch

    from dynamicpdb_tpu_torch import fold_cli
    from dynamicpdb_tpu_torch.analysis.pdb_io import read_pdb
    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod

    rng = np.random.default_rng(seed + 100)
    seqs = {f"fold{i}_{n}": "".join(rng.choice(list(RESTYPES), n))
            for i, n in enumerate(lengths)}
    fasta = os.path.join(tmp, f"fold_{device}.fasta")
    with open(fasta, "w") as f:
        f.writelines(f">{name}\n{seq}\n" for name, seq in seqs.items())
    out_dir = os.path.join(tmp, f"fold_{device}")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    geom_mod.geom_launches = geom_mod.node_launches = 0  # the path starts
    t0 = time.perf_counter()
    records = fold_cli.main(["--fasta", fasta, "--out-dir", out_dir,
                             "--weights", ckpt, "--num-cycles",
                             str(num_cycles), "--num-pseudo-msa",
                             str(num_pseudo_msa), "--pad-multiple",
                             str(pad_multiple), "--device", device])
    wall = time.perf_counter() - t0
    launched = {"geom_attention": geom_mod.geom_launches,
                "node_attention": geom_mod.node_launches}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    per_cycle = cfg.geo_num_blocks if on_card else 0
    expect = {"geom_attention": len(lengths) * num_cycles * per_cycle
              * cfg.geom_count,
              "node_attention": len(lengths) * num_cycles * per_cycle}
    check(launched == expect, f"fold: kernel launches {launched}, expected "
          f"{expect}")
    check(sorted(r["name"] for r in records) == sorted(seqs),
          f"fold: folded {[r['name'] for r in records]}")
    for r in records:
        seq = seqs[r["name"]]
        atom37, mask, aatype, _ = read_pdb(r["pdb"])
        check(atom37.shape == (len(seq), 37, 3) and r["n_res"] == len(seq),
              f"fold {r['name']}: atoms {atom37.shape} for {len(seq)} "
              "residues")
        check("".join(RESTYPES[a] for a in aatype) == seq,
              f"fold {r['name']}: the PDB's residues are not the sequence")
        check(bool(np.isfinite(atom37).all()) and mask.sum() > 0,
              f"fold {r['name']}: non-finite or no atoms")
        b = pdb_b_factors(r["pdb"])
        with open(r["json"]) as f:
            side = json.load(f)
        check(sorted(side) == ["confidence_overall", "mean_plddt"],
              f"fold {r['name']}: sidecar keys {sorted(side)}")
        check(0.0 <= side["confidence_overall"] <= 1.0
              and 0.0 <= side["mean_plddt"] <= 1.0,
              f"fold {r['name']}: sidecar {side}")
        check(bool(((b >= 0) & (b <= 100)).all()), f"fold {r['name']}: "
              f"B-factors outside [0, 100]: {b.min()} {b.max()}")
        # every atom of a residue carries its pLDDT x 100 (2 decimals); the
        # mean over residues is the sidecar's
        counts = mask.sum(1).astype(int)
        per_res = b[np.cumsum(counts) - counts] / 100
        check(abs(per_res.mean() - side["mean_plddt"]) <= 1e-4,
              f"fold {r['name']}: B-factors' mean {per_res.mean()} against "
              f"mean_plddt {side['mean_plddt']}")
        print(f"fold: {r['name']} n_res={r['n_res']} padded={r['padded']} "
              f"{num_cycles} cycles x {num_pseudo_msa + 1} pseudo-MSA rows: "
              f"{r['seconds']:.3f} s ({r['seconds'] / num_cycles:.3f} s a "
              f"cycle), cycle {r['cycle']} selected, confidence "
              f"{side['confidence_overall']:.5f}, mean pLDDT "
              f"{side['mean_plddt']:.5f}{tag}")
    print(f"fold: {len(records)} sequences in {wall:.2f} s of fold_cli "
          f"(weights loaded and moved included); peak "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB; kernel "
          f"launches {launched}{tag}")
    return dict(records=records, launches=launched, wall=wall,
                peak_bytes=peak)


def fold_card_vs_cpu(seed: int = 2, devices=("cuda", "cpu")) -> None:
    """fold_cli.fold at the release widths and a reduced depth (2 PLM
    layers, 2 GeoFormer blocks, 2 structure cycles; N = 40, 4 pseudo-MSA
    rows, 4 cycles) on one seeded random state dict, on the card and on
    the CPU (``devices``): pos14, pLDDT, the confidences and the selected
    cycle must agree (EXTRACT_RTOL of each output's scale,
    EXTRACT_CONF_ATOL)."""
    from dynamicpdb_tpu_torch import fold_cli
    from dynamicpdb_tpu_torch.models.omegafold.model import (
        OmegaFoldConfig,
        StructConfig,
        omegafold_from_state_dict,
    )
    from dynamicpdb_tpu_torch.models.omegafold.plm import PLMConfig
    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
    from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict

    cfg = OmegaFoldConfig(plm=PLMConfig(num_layers=2), geo_num_blocks=2,
                          struct=StructConfig(num_cycle=2))
    sd = random_omegafold_state_dict(cfg, seed)
    rng = np.random.default_rng(seed)
    lines = [">f40\n", "".join(rng.choice(list(RESTYPES), 40)) + "\n"]
    runs = []
    for dev in devices:
        model = omegafold_from_state_dict(sd, device=dev)
        geom_mod.geom_launches = geom_mod.node_launches = 0
        runs.append(next(fold_cli.fold(lines, model, num_cycles=4,
                                       num_pseudo_msa=3))[1])
        launched = (geom_mod.geom_launches, geom_mod.node_launches)
        expect = (4 * 2 * cfg.geom_count, 4 * 2) if dev == "cuda" else (0, 0)
        check(launched == expect, f"fold card vs CPU on {dev}: launches "
              f"{launched}, expected {expect}")
        del model
    gpu, cpu = runs
    check(gpu["cycle"] == cpu["cycle"], f"fold card vs CPU: cycle "
          f"{gpu['cycle']} selected on the card, {cpu['cycle']} on the CPU")
    for key in ("pos14", "plddt", "atom37"):
        err = float(np.abs(gpu[key] - cpu[key]).max())
        tol = EXTRACT_RTOL * max(1.0, float(np.abs(cpu[key]).max()))
        print(f"fold card vs CPU: {key} max_abs_err {err:.3e} tol {tol:.3e}")
        check(err <= tol, f"fold card vs CPU: {key} {err} > {tol}")
    conf_err = max(abs(a - b) for a, b in zip(
        gpu["confidences"] + [gpu["confidence_overall"]],
        cpu["confidences"] + [cpu["confidence_overall"]]))
    check(conf_err <= EXTRACT_CONF_ATOL, f"fold card vs CPU: confidences "
          f"differ by {conf_err}")
    print(f"fold card vs CPU: cycle {gpu['cycle']} selected on both "
          f"(confidences {[round(c, 5) for c in cpu['confidences']]}); "
          f"confidences within {conf_err:.3e}")


def dp_cards_main() -> int:
    """``--dp-cards``: only the data-parallel check across every card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from dynamicpdb_tpu_torch.ops import _build

    card = card_line()
    print(card)
    _build.build(sorted(os.path.basename(p)[:-3] for p in
                        glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))))
    t0 = time.perf_counter()
    dp_cards_phase(torch, card)
    print(f"dp: {torch.cuda.device_count()} cards in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    return 0


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)  # configs/release.yaml names the IGSO3 cache relatively
    from dynamicpdb_tpu_torch.models.omegafold.model import OmegaFoldConfig
    from dynamicpdb_tpu_torch.ops import _build
    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    # phase 0
    card = card_line()
    print(card)
    card_kind = torch.cuda.get_device_name(0)
    device = resolve_device("cuda")
    print(f"setup: {card_kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # phase 1
    names = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    built = _build.build(names)
    for b in built.values():
        print(f"build: {b.name} in {b.seconds:.2f} s -> "
              f"{os.path.relpath(b.path, ROOT)}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build: {b.name}: {line.strip()}")
    print(f"build: {len(built)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    fwd_smem = ipa_mod._lib("ipa_attention_fwd").ipa_attention_fwd_smem(
        256, 8, 12, 32)
    print(f"build: ipa_attention_fwd: {fwd_smem} bytes of dynamic shared "
          "memory per block at the release shapes")
    lib = ipa_mod._lib("ipa_attention_bwd")
    for which, kname in enumerate(BWD_KERNELS):
        print(f"build: {kname}: {lib.ipa_attention_bwd_smem(which, 256, 8, 12, 32)}"
              " bytes of dynamic shared memory per block at the release shapes")
    w = WIDE_CASE
    for kname in IPA_COUNTERS:
        need = ipa_mod.wide_smem(kname, w["C"], 3 * w["Pq"], 3 * w["Pv"],
                                 w["Dz"])
        print(f"build: {kname} wide route: {need} bytes of dynamic shared "
              f"memory per block at the wide case (limit "
              f"{ipa_mod.wide_smem_limit()})")
    for gname, shp in GEOM_SHAPES.items():
        print(f"build: {gname}: {geom_mod._lib().geom_attention_smem(shp['d'])}"
              f" bytes of dynamic shared memory per block at d={shp['d']}")
    mma = sass_mma_counts(_build.nvcc(), built["geom_attention"].path)
    for fn, n in sorted(mma.items()):
        print(f"build: geom_attention.cu SASS: {n} tensor-core instructions "
              f"in {fn}")
    check(len(mma) == 6 and all(mma.values()), "geom_attention.cu: a "
          f"kernel without tensor-core instructions: {mma}")
    ipa_sass = {src: sass_mma_counts(_build.nvcc(), built[src].path)
                for src in ("ipa_attention_fwd", "ipa_attention_bwd")}
    for src_name, kernel in (("ipa_attention_fwd", "ipa_attn_fwd_kernel"),
                             ("ipa_attention_bwd", "ipa_bwd_dq_kernel"),
                             ("ipa_attention_bwd", "ipa_bwd_dkv_kernel"),
                             ("ipa_attention_bwd", "ipa_bwd_pair_kernel")):
        mma = {fn: n for fn, n in ipa_sass[src_name].items() if kernel in fn}
        for fn, n in sorted(mma.items()):
            print(f"build: {src_name}.cu SASS: {n} tensor-core instructions "
                  f"in {fn}")
        check(len(mma) > 0 and all(mma.values()), f"{src_name}.cu: "
              f"{kernel} without tensor-core instructions: {mma}")
    print(f"build: phase in {time.perf_counter() - t0:.2f} s")

    # phase 2
    t0 = time.perf_counter()
    fwd_report, wide_fwd_report = kernel_phase(torch, device, card)
    bwd_reports = bwd_kernel_phase(torch, device, card)
    geom_reports = geom_kernel_phase(torch, device, card)
    print(f"kernels: phase in {time.perf_counter() - t0:.2f} s")

    # phase 3: the serving path at release width
    t0 = time.perf_counter()
    serve = serve_phase("cuda", RELEASE_OVERRIDES, lengths=(256, 200, 97),
                        pad_to=256, n_steps=4, num_t=10, tag=f" [{card}]")
    fwd_report["launches_serve"] = serve["launches"]
    print(f"serve: release width, 4 requests in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    # the same path at a small width, on the card and on the CPU
    small = {}
    for dev in ("cuda", "cpu"):
        small[dev] = serve_phase(dev, SMALL_OVERRIDES, lengths=(16, 12, 9),
                                 pad_to=16, n_steps=3, num_t=2,
                                 label=f"small-{dev}")
    for i, (a, b) in enumerate(zip(small["cuda"]["results"],
                                   small["cpu"]["results"])):
        for key in ("atom_traj", "rigid_traj"):
            err = float(np.abs(a["out"][key] - b["out"][key]).max())
            tol = 1e-3 * max(1.0, float(np.abs(b["out"][key]).max()))
            print(f"small: request {i} card vs CPU {key} max_abs_err "
                  f"{err:.3e} tol {tol:.3e}")
            check(err <= tol, f"small request {i} {key}: card and CPU "
                  f"differ by {err} > {tol}")

    # phase 3c: batched rollout at release width
    t0 = time.perf_counter()
    batched = batched_rollout_phase("cuda", RELEASE_OVERRIDES,
                                    lengths=(256, 200), pad_to=256,
                                    n_steps=2, num_t=10, tag=f" [{card}]")
    fwd_report["launches_batched_rollout"] = batched["launches"]
    print(f"batched rollout: release width in {time.perf_counter() - t0:.2f} "
          f"s [{card}]")

    # phase 3d: the Picard sampler at release width
    t0 = time.perf_counter()
    picard = picard_phase("cuda", RELEASE_OVERRIDES, n_res=256, pad_to=256,
                          num_t=10, tag=f" [{card}]")
    fwd_report["launches_picard"] = picard["launches"]
    print(f"picard: release width in {time.perf_counter() - t0:.2f} s "
          f"[{card}]")

    release = os.path.join("configs", "release.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        # phase 4: gradients through the kernels, then training at release
        # width
        grad_flow_phase()
        t0 = time.perf_counter()
        train = train_phase("cuda", release, [], lengths=(256, 200),
                            n_frames=8, max_steps=3, tmp=tmp,
                            tag=f" [{card}]")
        serve_checkpoint("cuda", release, train["ckpt"], [], n_res=200,
                         pad_to=256, tag=f" [{card}]")
        print(f"train: release width through train_cli and serve_cli in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        check(train["route"] == "tc", "train: the release widths left the "
              "tensor-core kernels")
        launched = train["launched"]
        fwd_report["launches"] = launched["fwd"]
        for rep, key in zip(bwd_reports[:3], ("dq", "dkv", "pair")):
            rep["launches"] = launched[key]

        # phase 6: evaluation at release width on the checkpoint phase 4
        # wrote
        t0 = time.perf_counter()
        ev = eval_phase("cuda", release, train["ckpt"], train["csv"], [],
                        os.path.join(tmp, "eval6"), tag=f" [{card}]")
        fwd_report["launches_eval"] = ev["launches"]
        print(f"eval: release width in {time.perf_counter() - t0:.2f} s "
              f"[{card}]")

        # phase 8: data parallel, against phase 4's one process
        t0 = time.perf_counter()
        dp_phase(torch, release, train, tmp, card)
        print(f"dp: phase in {time.perf_counter() - t0:.2f} s [{card}]")

    # phase 4b: the wide route in a model: one block's gradients on the card
    # against the CPU, then train_cli and serve_cli at release depth
    t0 = time.perf_counter()
    grad_flow_phase(overrides=WIDE_OVERRIDES, label="grad flow wide")
    with tempfile.TemporaryDirectory() as tmp:
        wide = train_phase("cuda", release, WIDE_MODEL + [
            "experiment.batch_size=2"], lengths=(256, 200), n_frames=8,
            max_steps=3, tmp=tmp, tag=f" [wide, {card}]")
        serve_checkpoint("cuda", release, wide["ckpt"], WIDE_MODEL,
                         n_res=200, pad_to=256, tag=f" [wide, {card}]")
    check(wide["route"] == "wide", f"train wide: ran the {wide['route']} "
          "route")
    wide_fwd_report["launches"] = wide["launched"]["fwd"]
    for rep, key in zip(bwd_reports[3:], ("dq", "dkv", "pair")):
        rep["launches"] = wide["launched"][key]
    print(f"wide: grad flow, train_cli and serve_cli in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    # phase 6b: eval on the card against the CPU, --ema and --ref-ckpt
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        eval_card_vs_cpu(tmp)
    print(f"eval: card vs CPU in {time.perf_counter() - t0:.2f} s")

    # phase 5: OmegaFold embedding extraction at release width and depth
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ext = extract_phase("cuda", OmegaFoldConfig(), lengths=(256, 203),
                            num_cycles=10, num_pseudo_msa=15, pad_multiple=32,
                            tmp=tmp, tag=f" [{card}]")
        print(f"extract: release width and depth, 2 sequences in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")

        # phase 7: fold_cli on the same checkpoint
        t0 = time.perf_counter()
        fold = fold_phase("cuda", OmegaFoldConfig(), ext["ckpt"],
                          lengths=(256, 203), num_cycles=3,
                          num_pseudo_msa=15, pad_multiple=32, tmp=tmp,
                          tag=f" [{card}]")
        print(f"fold: release width and depth, 2 sequences in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
    check(ext["params"] == 795_074_210, f"extract: the release model has "
          f"{ext['params']:,} parameters, not 795,074,210")
    for rep in geom_reports:
        rep["launches"] = ext["launches"][rep["name"]]
        rep["launches_fold"] = fold["launches"][rep["name"]]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        extract_card_vs_cpu(tmp)
    print(f"extract: card vs CPU in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fold_card_vs_cpu()
    print(f"fold: card vs CPU in {time.perf_counter() - t0:.2f} s")

    reports = [fwd_report, wide_fwd_report] + bwd_reports + geom_reports
    for rep in reports:
        check(rep["launches"] > 0, f"{rep['name']} never launched on its "
              "main path")

    print(f"total: {time.perf_counter() - t_start:.2f} s wall [{card}]")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": reports}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not os.path.isdir(os.path.join(ROOT, "dynamicpdb_tpu_torch")):
        print("chip_smoke: dynamicpdb_tpu_torch is not beside this script",
              file=sys.stderr)
        sys.exit(1)
    sys.exit(dp_cards_main() if sys.argv[1:] == ["--dp-cards"] else main())
