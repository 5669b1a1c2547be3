#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynamicpdb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. setup: the card's name and power limit (nvidia-smi), device checks;
  1. build: every kernel source under dynamicpdb_tpu_torch/csrc, one nvcc
     each, all started together, with ptxas's registers and spills; the
     machine code of the GeoFormer kernels, the IPA forward and the IPA dq
     kernel must hold tensor-core instructions (cuobjdump -sass);
  2. kernels: the IPA forward and its three backward kernels against their
     plain PyTorch versions on the card, at the release widths and N = 5,
     16, 203, 256 and 611, at the tiny width, and with the first key tile
     all pad (the backward with cotangents zero on pad rows and with
     cotangents everywhere), the autograd Function against dense autograd,
     with errors, tolerances and times;
  3. serve: the release-width model with seeded random weights is saved,
     loaded by serve_cli and driven over HTTP (healthz + 4 rollouts), with
     the kernel launch counts of that run checked against the model's
     structure; then the same path at a small width on the card and on the
     CPU, which must agree;
  4. train: one loss and backward at a small width with randomised weights
     on the card and on the CPU (every gradient must agree, every IPA
     projection's must be nonzero); then train_cli at release width
     (configs/release.yaml, B=8, remat, bfloat16) for 3 steps on two
     synthetic trajectories, with the launch counts of that run checked,
     and serve_cli answering one request from the checkpoint it wrote;
  5. extract: a seeded random OmegaFold at release width and depth (795M
     parameters) saved to a temporary checkpoint (3.2 GB) and run by the
     extraction CLI on two sequences (256 and 203 residues, padded to
     multiples of 32, 10 cycles, 15 pseudo-MSA rows), every npz checked
     against the DFOLD contract and the launch counts of both GeoFormer
     attention kernels checked; then the same CLI at release width and a
     reduced depth on the card and on the CPU, which must agree and select
     the same cycle, and in bfloat16 on the card against float32.
Phase 2 also holds both GeoFormer attention kernels against their plain
versions (release, ragged and long ragged L, float32 and bfloat16) and
times them beside their bounds and torch's SDPA on the same attention
core. Every kernel report carries two bounds: bound_ms with every
operation on the CUDA cores in float32, tc_bound_ms with the products on
the TF32 tensor cores in three passes (bounds()).
The line before the last is the kernel report (launches: the IPA kernels'
from the training run, the GeoFormer kernels' from the extraction run),
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
    """The time of IPA kernel ``kind`` (``ipa_attention_fwd`` on the
    forward's 10 inputs, or a backward launcher on the 15 backward inputs)
    alone: outputs allocated once, then ``reps`` launches straight through
    the library of ``mod`` (no checks, no counter moves)."""
    q = operands[0]
    F, N, H, C = q.shape
    Dz = operands[7].shape[-1]
    if kind == "ipa_attention_fwd":
        Pq, Pv = operands[3].shape[-2], operands[5].shape[-2]
        shapes = ((F, N, H, C), (F, N, H, Pv, 3), (F, N, H, Dz), (F, H, N))
        lib = mod._lib("ipa_attention_fwd")
    else:
        Pq, Pv = operands[3].shape[-1] // 3, operands[5].shape[-1] // 3
        shapes = IPA_BWD_OUT_SHAPES[kind](F, N, H, C, 3 * Pq, 3 * Pv, Dz)
        lib = mod._lib("ipa_attention_bwd")
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
# the online softmax rescales it away
IPA_CASES = (("release", dict(N=256, masked=56)),
             ("ragged", dict(N=203, masked=11)),
             ("N5", dict(N=5, masked=1)),
             ("N16", dict(N=16, masked=3)),
             ("long", dict(N=611, masked=13)),
             ("tiny", dict(N=37, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=5)),
             ("first-tile-pad", dict(N=203, masked=5, lead_masked=40)))


def kernel_phase(torch, device, card: str) -> dict:
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    report = None
    for label, shape in IPA_CASES:
        args, c_qk = ipa_inputs(torch, device, seed=len(label), **shape)
        got = ipa_mod.ipa_attention_fwd(*args, c_qk)
        torch.cuda.synchronize()
        want = ipa_mod.ipa_attention_plain(*args, c_qk)
        errs = ipa_errors(got, want, args)
        for name in ("o", "o_pt", "o_pair"):
            e = errs[name]
            print(f"kernel ipa_attention_fwd {label}: {name} max_abs_err "
                  f"real rows {e['real']:.3e} (tol {e['tol_real']:.0e}), pad "
                  f"rows {e['pad']:.3e} (tol {e['tol_pad']:.3e})")
            check(e["real"] <= e["tol_real"] and e["pad"] <= e["tol_pad"],
                  f"ipa_attention_fwd {label} {name} out of tolerance: {e}")
        print(f"kernel ipa_attention_fwd {label}: lse max_abs_err "
              f"{errs['lse']['max']:.3e} (tol {IPA_ATOL:.0e} + "
              f"{IPA_LSE_RTOL:.0e}*|lse|)")
        check(errs["lse"]["ok"], f"ipa_attention_fwd {label} lse out of "
              "tolerance")
        if label == "release":
            F, N, H, C = args[0].shape
            Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
            ms = time_ms(torch, lambda: ipa_mod.ipa_attention_fwd(*args, c_qk),
                         50)
            kernel_ms = ipa_kernel_ms(torch, ipa_mod, "ipa_attention_fwd",
                                      args, c_qk, 50)
            plain_ms = time_ms(
                torch, lambda: ipa_mod.ipa_attention_plain(*args, c_qk), 20)
            ops, nbytes, ew_ops = ipa_cost(F, N, H, C, Pq, Pv, Dz)
            streams = [errs[n] for n in ("o", "o_pt", "o_pair")]
            report = {
                "name": "ipa_attention_fwd",
                "route": "cuda",
                "source": "dynamicpdb_tpu_torch/csrc/ipa_attention_fwd.cu",
                "replaces": "dynamicpdb_tpu/ops/pallas/ipa_attention.py:39",
                "launches": None,  # filled from the serving run
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
            print(f"kernel ipa_attention_fwd release: {ms:.4f} ms through "
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
    case of IPA_CASES, with cotangents zeroed on pad rows and with
    cotangents everywhere, and there the autograd Function's backward
    against autograd of the plain forward on the card; then each kernel's
    time (through its wrapper and alone) against its plain version."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    reports = {}
    for label, shape in IPA_CASES:
        args, c_qk = ipa_inputs(torch, device, seed=10 + len(label), **shape)
        for zero_pad in (True, False):
            case = "pad cotangents 0" if zero_pad else "pad cotangents random"
            inputs, cots = ipa_bwd_inputs(torch, args, c_qk,
                                          zero_pad=zero_pad, seed=3)
            got = ipa_bwd_grads(torch, inputs, c_qk, plain=False)
            torch.cuda.synchronize()
            want = ipa_bwd_grads(torch, inputs, c_qk, plain=True)
            pad_scale = None if zero_pad else ipa_bwd_pad_scale(torch, inputs,
                                                                c_qk)
            errs = ipa_bwd_errors(got, want, pad_scale)
            for name, (err, tol) in errs.items():
                print(f"kernel backward {label}, {case}: {name} max_abs_err "
                      f"{err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"backward {label} {case}: {name} "
                      f"{err} > {tol}")
            if label == "release":
                for kname, (_, grads) in BWD_KERNELS.items():
                    key = "max_abs_err" if zero_pad else "max_abs_err_pad_cotangents"
                    reports.setdefault(kname, {})[key] = max(
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

    args, c_qk = ipa_inputs(torch, device, seed=20)
    inputs, _ = ipa_bwd_inputs(torch, args, c_qk, zero_pad=False, seed=4)
    F, N, H, C = args[0].shape
    costs = ipa_bwd_cost(F, N, H, C, args[3].shape[-2], args[5].shape[-2],
                         args[7].shape[-1])
    kw = dict(c_qk=c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5)
    out = []
    for kname, (replaces, _) in BWD_KERNELS.items():
        kernel = getattr(ipa_mod, kname)
        plain = getattr(ipa_mod, kname.replace("ipa_attention_bwd",
                                               "ipa_bwd") + "_plain")
        ms = time_ms(torch, lambda: kernel(*inputs, **kw), 50)
        kernel_ms = ipa_kernel_ms(torch, ipa_mod, kname, inputs, c_qk, 50)
        plain_ms = time_ms(torch, lambda: plain(*inputs, **kw), 20)
        ops, nbytes, ew_ops = costs[kname]
        rep = {
            "name": kname, "route": "cuda",
            "source": "dynamicpdb_tpu_torch/csrc/ipa_attention_bwd.cu",
            "replaces": replaces, "launches": None, **reports[kname],
            "ms": ms, "ms_kernel": kernel_ms, "plain_ms": plain_ms,
            **bounds(ops, ew_ops, nbytes),
            "library_ms": None,  # no single PyTorch call computes it
        }
        print(f"kernel {kname} release: {ms:.4f} ms through the wrapper, "
              f"{kernel_ms:.4f} ms alone, plain {plain_ms:.4f} ms, "
              f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}: "
              f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), tensor-core "
              f"bound {rep['tc_bound_ms']:.4f} ms, warm L2 [{card}]")
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


def grad_flow_phase(seed: int = 0) -> dict:
    """One train-step loss and backward at a small width in float32, every
    parameter drawn from a seeded generator (randomize_: the AF2 zero init
    of linear_out would make every IPA input gradient exactly 0), with the
    same injected noise on the card and on the CPU. Every parameter's
    gradient must agree, every IPA projection's gradient must be nonzero
    on the card, and each backward kernel must have run once per block and
    window."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.data.dataset import pad_window
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.train.experiment import Trainer
    from dynamicpdb_tpu_torch.weights import randomize_

    cfg = config_lib.apply_overrides(config_lib.Config(), SMALL_OVERRIDES)
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
        ipa_mod.bwd_dq_launches = ipa_mod.bwd_dkv_launches = 0
        ipa_mod.bwd_pair_launches = 0
        loss, _ = t.loss_and_grads(batch, _to(noises, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        launched = (ipa_mod.bwd_dq_launches, ipa_mod.bwd_dkv_launches,
                    ipa_mod.bwd_pair_launches)
        grads[dev] = (float(loss), {n: p.grad.detach().cpu()
                                    for n, p in t.model.named_parameters()
                                    if p.grad is not None})
    expect = cfg.model.ipa.num_blocks * len(ws)
    check(launched == (expect,) * 3, f"grad flow: backward kernel launches "
          f"{launched}, expected {expect} each")
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = grads["cpu"], grads["cuda"]
    check(sorted(g_cpu) == sorted(g_gpu), "grad flow: different parameters "
          "received gradients on the card and on the CPU")
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
    worst = (0.0, "")
    for name, want in g_cpu.items():
        tol = GRAD_FLOW_RTOL * max(float(want.abs().max()),
                                   floor / GRAD_FLOW_RTOL)
        err = float((g_gpu[name] - want).abs().max())
        check(err <= tol, f"grad flow: {name} card vs CPU {err} > {tol}")
        worst = max(worst, (err / tol, name))
    for b in range(cfg.model.ipa.num_blocks):
        for proj in IPA_PROJECTIONS:
            key = f"score_model.trunk.ipa_{b}.{proj}" + (
                "" if proj == "head_weights" else ".weight")
            check(float(g_gpu[key].abs().max()) > 0,
                  f"grad flow: {key} has a zero gradient on the card")
    print(f"grad flow: small width, float32, randomised weights: loss card "
          f"{loss_gpu:.6f} CPU {loss_cpu:.6f}; {len(g_cpu)} parameter "
          f"gradients agree (worst {worst[1]} at {worst[0]:.3f} of its tol "
          f"{GRAD_FLOW_RTOL:.0e} x max|g|); every IPA projection gradient "
          f"nonzero on the card; backward kernel launches {launched}")
    return dict(loss_cuda=loss_gpu, loss_cpu=loss_cpu)


def write_manifest(tmp: str, lengths, n_frames: int, seed: int = 0) -> str:
    """make_trajectory_npz bundles and their CSV manifest in ``tmp``."""
    from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz

    rows = []
    for i, n in enumerate(lengths):
        path = make_trajectory_npz(os.path.join(tmp, f"prot{i}.npz"),
                                   n_res=n, n_frames=n_frames, seed=seed + i)
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
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.weights import init_like_jax_

    csv = write_manifest(tmp, lengths, n_frames)
    argv = ["--config", config, "--max-steps", str(max_steps), "--device",
            device, f"data.csv_path={csv}",
            f"experiment.ckpt_dir={os.path.join(tmp, 'ckpt')}",
            f"experiment.eval_dir={os.path.join(tmp, 'eval')}", *extra]
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ipa_mod.launches = ipa_mod.bwd_dq_launches = 0  # the main path starts
    ipa_mod.bwd_dkv_launches = ipa_mod.bwd_pair_launches = 0
    t0 = time.perf_counter()
    exp = train_cli.main(argv)
    wall = time.perf_counter() - t0
    launched = dict(fwd=ipa_mod.launches, dq=ipa_mod.bwd_dq_launches,
                    dkv=ipa_mod.bwd_dkv_launches, pair=ipa_mod.bwd_pair_launches)
    cfg, trainer = exp.cfg, exp.trainer
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
    print(f"train: {max_steps} steps in {wall:.2f} s of train_cli; steady "
          f"steps (step 1 apart) {steady}; peak "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB; kernel "
          f"launches {launched} ({len(moved)} of {len(now)} tensors "
          f"moved){tag}")
    ckpt = os.path.join(cfg.experiment.ckpt_dir, f"step_{exp.step}.ckpt")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    return dict(ckpt=ckpt, launched=launched, steps=exp.step_metrics,
                peak_bytes=peak, wall=wall, batch=B)


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
        ipa_mod.launches = 0
        t0 = time.perf_counter()
        out = _post(f"http://{args.host}:{server.server_address[1]}",
                    {k: w[k] for k in serve_cli.RAW_KEYS},
                    "n_steps=2&fast_x0=1&seed=0")
        dt = time.perf_counter() - t0
        launched = ipa_mod.launches
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
                peak_bytes=peak, wall=wall, arrays=arrays)


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


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "dynamicpdb_tpu_torch")):
        print("chip_smoke: dynamicpdb_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
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
    for gname, shp in GEOM_SHAPES.items():
        print(f"build: {gname}: {geom_mod._lib().geom_attention_smem(shp['d'])}"
              f" bytes of dynamic shared memory per block at d={shp['d']}")
    mma = sass_mma_counts(_build.nvcc(), built["geom_attention"].path)
    for fn, n in sorted(mma.items()):
        print(f"build: geom_attention.cu SASS: {n} tensor-core instructions "
              f"in {fn}")
    check(len(mma) == 6 and all(mma.values()), "geom_attention.cu: a "
          f"kernel without tensor-core instructions: {mma}")
    for src_name, kernel in (("ipa_attention_fwd", "ipa_attn_fwd_kernel"),
                             ("ipa_attention_bwd", "ipa_bwd_dq_kernel")):
        mma = {fn: n for fn, n in sass_mma_counts(
            _build.nvcc(), built[src_name].path).items() if kernel in fn}
        for fn, n in sorted(mma.items()):
            print(f"build: {src_name}.cu SASS: {n} tensor-core instructions "
                  f"in {fn}")
        check(len(mma) > 0 and all(mma.values()), f"{src_name}.cu: "
              f"{kernel} without tensor-core instructions: {mma}")
    print(f"build: phase in {time.perf_counter() - t0:.2f} s")

    # phase 2
    t0 = time.perf_counter()
    fwd_report = kernel_phase(torch, device, card)
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

    # phase 4: gradients through the kernels, then training at release width
    grad_flow_phase()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase("cuda", os.path.join("configs", "release.yaml"),
                            [], lengths=(256, 200), n_frames=8, max_steps=3,
                            tmp=tmp, tag=f" [{card}]")
        serve_checkpoint("cuda", os.path.join("configs", "release.yaml"),
                         train["ckpt"], [], n_res=200, pad_to=256,
                         tag=f" [{card}]")
    print(f"train: release width through train_cli and serve_cli in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    launched = train["launched"]
    fwd_report["launches"] = launched["fwd"]
    for rep, key in zip(bwd_reports, ("dq", "dkv", "pair")):
        rep["launches"] = launched[key]

    # phase 5: OmegaFold embedding extraction at release width and depth
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ext = extract_phase("cuda", OmegaFoldConfig(), lengths=(256, 203),
                            num_cycles=10, num_pseudo_msa=15, pad_multiple=32,
                            tmp=tmp, tag=f" [{card}]")
    check(ext["params"] == 795_074_210, f"extract: the release model has "
          f"{ext['params']:,} parameters, not 795,074,210")
    for rep in geom_reports:
        rep["launches"] = ext["launches"][rep["name"]]
    print(f"extract: release width and depth, 2 sequences in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        extract_card_vs_cpu(tmp)
    print(f"extract: card vs CPU in {time.perf_counter() - t0:.2f} s")

    reports = [fwd_report] + bwd_reports + geom_reports
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
    sys.exit(main())
