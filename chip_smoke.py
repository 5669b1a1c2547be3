#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynamicpdb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-cards   # data parallel over every card (NCCL)
    python3 chip_smoke.py --alphafold [--parent DIR]   # phases 2d and 12

Phases, each printing its own lines:
  0. setup: the card's name and power limit (nvidia-smi), device checks;
  1. build: every kernel source under dynamicpdb_tpu_torch/csrc, one nvcc
     each, all started together, with ptxas's registers and spills (the
     GeoFormer kernel's per instance); the machine code of the GeoFormer
     kernels (six in each instance, 128 and 256 query rows a block), the
     IPA forward and the three IPA backward kernels, and the wide route's
     tensor-core forward and three backward kernels must hold tensor-core
     instructions (cuobjdump -sass);
  2. kernels: the IPA forward and its three backward kernels against their
     plain PyTorch versions on the card, at the release widths and N = 5,
     16, 203, 256 and 611, at the tiny width, and with the first key tile
     all pad (the backward with cotangents zero on pad rows and with
     cotangents everywhere), the autograd Function against dense autograd,
     with errors, tolerances and times; then the same at three cases past
     the tensor-core kernels' widths ("wide": C 384, Pq 12, Pv 18, Dz 64,
     4 heads; "wide-dz": Dz 64; "wide-model": phase 4b's widths and
     window, C 384, Pq 12, Dz 64, N 256), which must run all four on the
     wide tensor-core kernels (each wrapper's counter of its route moves,
     no other), and at one past the wide tensor-core kernels' widths
     ("past-wide-tc": C 392, Pq 14, Pv 20, Dz 72, N 37), where all four
     run on the CUDA cores; then the rectangular calls of sequence
     parallelism on each route: rows 128-255 (the 56 pad rows among them)
     of the release and wide-model windows against all 256 keys, every
     kernel against its plain version and against the square call's rows
     (bit for bit), timed;
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
     by serve_cli, every IPA launch on the wide tensor-core kernels;
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
     state hold between steps printed. Phase 8's runs start at once, as
     do phase 9's and phase 10's (most of a run's time is its processes'
     start-up); their printed seconds are taken under that load.
  9. sequence parallelism (two gloo ranks sharing cuda:0 on a ('data',
     'seq') = (1, 2) mesh: each window's residues split over them): 9a,
     train_cli at phase 4's config, batch, manifest and steps in float32
     compute and moments, against one process's float32 steps: losses,
     moments and the update over the elements whose gradient one process
     resolves within phase 8's bounds, and a planted fault that must read
     past the update's bound; 9b, tools/sp_run.py's rollout of phase 3c's
     first window (256 residues, 2 frames, full sampler and fast_x0, the
     same weights and generator seed) against one process's, in float32
     and in bfloat16, each rank's IPA launches; 9c, one train step of a
     1024-residue window at release widths (B 1, remat, bfloat16) through
     tools/dp_step.py, one process and two 'seq' ranks with their
     collectives timed: the loss within bfloat16's precision of one
     process's, each rank's peak memory printed beside (and below) the
     one process's, each rank's IPA launches.
  10. OmegaFold under sequence parallelism (run after phase 7, on phase
     5's checkpoint; two gloo ranks sharing cuda:0 on a ('data', 'seq') =
     (1, 2) mesh, tools/sp_run.py): 10a, phase 5's sequences (256, and 203
     padded to 224), 2 cycles with the structure, against one process:
     every cycle's node, edge and confidence, the selected cycle (equal),
     its pos14 and pLDDT within SP_OF_RTOL of their scale, every rank's
     result equal to rank 0's, each rank's GeoFormer kernel launches (its
     node_attention blocks of at most 128 rows in the 128-row instance); a
     run with a planted fault (the column view from the rank's own rows)
     must read past the bound; 10b, one cycle at 512 residues, one
     process and a 'seq' rank with its collectives timed: each one's
     peak memory (a rank's below one process's), seconds and collectives.
  11. ingest -> train -> export -> score (run after phase 10, in phase 5's
     directory, on its checkpoint): 11a, a synthetic dynamicPDB release
     directory of one protein (96 residues, 16 frames: segment pickles
     wrapped by one box length, a gzipped State XML, an _npt_sim.dat)
     through tools/ingest_release.py with --unwrap and --weights: one
     manifest row, the unwrapped frames, node and edge reprs equal to a
     direct omegafold_embed, the GeoFormer launches of 10 cycles (all in
     the 128-row instance at 96 residues), the
     energy table's summary; 11b, train_cli at configs/release.yaml with
     model.embed.use_aatype_embedding=true for 3 steps at B 8 on that
     manifest (phase 4's checks: finite losses, the batches received, the
     IPA launches; the embedding must move) and serve_cli answering one
     request from its checkpoint; 11c, the embedding at the small width
     with randomised weights, forward and every gradient on the card
     against the CPU at phase 4's grad-flow bar, and zeroing it must move
     the outputs; 11d, train/export_torch.py's CLI on phase 4's checkpoint
     (run beside phase 4, whose directory closes before phase 11) read
     back by train/import_torch.py, one forward bit-equal to the original
     network's, and the strict export of 11b's checkpoint refused,
     --no-strict written without the embedding; 11e, phase 3's served
     frames (256 and 97 residues) scored by analysis/violations.py,
     analysis/structure_checks.py and analysis/contact_order.py (on the
     card), every metric finite, the key sets JAX's;
  12. alphafold (``--alphafold`` runs it alone, after phase 2d, and with
     ``--parent DIR`` holds the kernels' outputs against DIR's package bit
     for bit, bench_geom.py's --save-outputs/--compare-outputs): a seeded
     random AlphaFold2 model_5 (92.7M parameters) saved to a temporary
     checkpoint and run by the extraction CLI (--model alphafold2) on one
     256-residue alignment of 4,096 rows, 4 recycles: the npz's keys and
     shapes, and the launches a recycle (node_attention 2 x 48, the
     one-axis geom_attention 2 x 52, the single-view triangle route 2 x 52);
     then a tiny model_5 on the CPU, which launches nothing.
Phase 2d holds the triangle route's single view (AlphaFold2's outgoing
and incoming triangle multiplications) against its plain version at L 256
and 203, both views, and times it beside its bound.
Phase 2 also holds both GeoFormer attention kernels against their plain
versions (release, ragged and long ragged L, float32 and bfloat16) and
times them beside their bounds and torch's SDPA on the same attention
core, then at the shapes AlphaFold2 model_5 calls them at (MSA row
attention, 512 rows of 256 keys; MSA column attention on the transpose,
256 rows of 512 keys with a zero bias; triangle attention on z and z^T,
one axis, H 4, d 128), float32 (``--alphafold`` runs these too); then their rectangular calls under sequence parallelism
(node_attention on rows 0-127 and 128-255 of the release window, on a
ragged block with a pad row and on rows 256-511 of 512, the odd rows' last
33 keys masked; geom_attention on B = 128 rows of a 256 window) and both
kernels' square calls at L 96, each against its plain version, equal to
the square call's rows bit for bit and, where it runs the 128-row
instance, to the 256-row instance's output bit for bit; one case of each
kernel timed, naming its instance. Every kernel report carries two bounds: bound_ms with every
operation on the CUDA cores in float32, tc_bound_ms with the products on
the TF32 tensor cores in three passes (bounds()).
The line before the last is the kernel report (launches: the tensor-core
IPA kernels' from the release training run, the wide ones' from the wide
training run, the GeoFormer kernels' from the extraction run; the IPA
forward's report adds those of serving, batched rollout, Picard and eval,
the GeoFormer kernels' those of fold_cli, the tensor-core IPA kernels'
a 'seq' rank's in 9c's step and the forward's in 9b's rollout, and
phase 11b's and 11a's launches as launches_pipeline_train and
launches_ingest; errors
and times at the same shapes; each IPA kernel's "rectangular" entry its
rectangular call's errors, times and bounds; the GeoFormer kernels'
rectangular calls as two reports of their own, their launches a 'seq'
rank's in 10a; each GeoFormer report names the instance it timed,
``tile_rows``, and counts the launches of the 128-row instance,
``launches_128``, ``launches_ingest_128``),
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
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections.abc import Callable, Generator
from typing import Any, NamedTuple

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


def ptxas_usage(log: str) -> dict:
    """{kernel function: "N registers, S bytes spill stores, L bytes spill
    loads"} from nvcc's -Xptxas -v output."""
    usage, name, spills = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            spills = ", ".join(p.strip() for p in line.split(",")[1:])
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            usage[name] = f"{regs}, {spills}"
            name = None
    return usage


def geom_instance(fn: str) -> str:
    """geom_attn_kernel<T, MASKED, PP, ROWS>, named from a mangled kernel
    name (the name itself when it is not one of them)."""
    m = re.search(r"geom_attn_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d+)"
                  r"ELi(\d+)E", fn)
    if not m:
        return fn
    dtype = "float" if m[1] == "f" else "bfloat16"
    return (f"geom_attn_kernel<{dtype}, masked={m[2]}, passes={m[3]}, "
            f"rows={m[4]}>")


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


def ipa_cost(F, N, H, C, Pq, Pv, Dz, Nk=None):
    """(operations, bytes, elementwise operations) the forward must do and
    move at N query rows against Nk keys (Nk = N: the square call): the
    five contractions (2 per multiply-add) plus ~12 elementwise operations
    per logit; each input read once, each output written once, float32."""
    Nk = N if Nk is None else Nk
    ops = F * H * N * Nk * (2 * C + 2 * 3 * Pq + 2 * C + 2 * 3 * Pv + 2 * Dz
                            + 12)
    n_in = F * N * H * C + 2 * F * Nk * H * C + F * N * H * Pq * 3 \
        + F * Nk * H * Pq * 3 + F * Nk * H * Pv * 3 + N * Nk * H \
        + N * Nk * Dz + F * N + (F * Nk if Nk != N else 0) + H
    n_out = F * N * H * C + F * N * H * Pv * 3 + F * N * H * Dz + F * H * N
    return ops, 4 * (n_in + n_out), F * H * N * Nk * 12


def ipa_bwd_cost(F, N, H, C, Pq, Pv, Dz, Nk=None):
    """{kernel: (operations, bytes, elementwise operations)} of the three
    backward kernels at N query rows against Nk keys (Nk = N: the square
    call): each recomputes the tile (the forward's logit terms, ~12
    elementwise operations, then ds = g_o.v + g_opt.vp + g_pair.pz and dl,
    2 per multiply-add, and 2 elementwise) and adds its own sums and
    elementwise steps; each reads the 15 backward inputs (and a key mask)
    once and writes its outputs once, float32."""
    Nk = N if Nk is None else Nk
    P3q, P3v = 3 * Pq, 3 * Pv
    recompute = (2 * C + 2 * P3q + 12) + (2 * C + 2 * P3v + 2 * Dz) + 2
    per_elem = {
        "ipa_attention_bwd_dq": recompute + 2 * C + 2 * P3q + 4,
        "ipa_attention_bwd_dkv": recompute + 2 * C + 2 * P3q + 1 + 2 * C
        + 2 * P3v,
        "ipa_attention_bwd_pair": recompute + 2 * Dz + 1,
    }
    n_in = 2 * F * N * H * C + 2 * F * Nk * H * C + F * N * H * P3q \
        + F * Nk * H * P3q + F * Nk * H * P3v + F * N * H * P3v \
        + N * Nk * H + N * Nk * Dz + F * N + (F * Nk if Nk != N else 0) + H \
        + 2 * F * H * N + F * N * H * Dz
    n_out = {
        "ipa_attention_bwd_dq": F * N * H * C + F * N * H * P3q + F * H * N,
        "ipa_attention_bwd_dkv": 2 * F * Nk * H * C + F * Nk * H * P3q
        + F * Nk * H * P3v,
        "ipa_attention_bwd_pair": N * Nk * H + N * Nk * Dz,
    }
    ew = {"ipa_attention_bwd_dq": 14 + 4, "ipa_attention_bwd_dkv": 14 + 1,
          "ipa_attention_bwd_pair": 14 + 1}
    return {k: (F * H * N * Nk * per_elem[k], 4 * (n_in + n_out[k]),
                F * H * N * Nk * ew[k]) for k in per_elem}


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


def ipa_bwd_inputs(torch, args, c_qk, *, zero_pad: bool, seed: int,
                   key_mask=None):
    """Forward (the kernel on the card), seeded random cotangents for o,
    o_pt and o_pair (zeroed on pad query rows when ``zero_pad``), and the
    15 inputs of the backward kernels. ``key_mask``: a rectangular call's
    (None: square)."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    kw = {} if key_mask is None else dict(key_mask=key_mask)
    out = ipa_mod.ipa_attention_fwd(*args, c_qk, **kw)
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    mask = args[8]
    cots = []
    for o in out[:3]:
        c = torch.randn(o.shape, generator=g, device=o.device)
        if zero_pad:
            c = c * mask.reshape(mask.shape + (1,) * (c.dim() - 2))
        cots.append(c)
    return ipa_mod.backward_inputs(tuple(args) + tuple(out), *cots), cots


def ipa_bwd_grads(torch, inputs, c_qk, plain: bool, key_mask=None) -> dict:
    """The nine gradients from the three backward kernels (or their plain
    versions), dhw reduced over frames and rows as the Function does."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    kw = dict(c_qk=c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5)
    if key_mask is not None:
        kw["key_mask"] = key_mask
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


def ipa_bwd_pad_scale(torch, inputs, c_qk, key_mask=None) -> dict:
    """Per gradient, the largest sum of the absolute values of its pad-row
    terms: the plain backward's sums with every operand taken absolute and
    a, dl restricted to pad query rows."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    kw = dict(c_qk=c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5)
    if key_mask is not None:
        kw["key_mask"] = key_mask
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


# launcher -> its output shapes from (F, Nq, Nk, H, C, P3q, P3v, Dz), as
# the wrappers allocate them; kept here so that ipa_kernel_ms also times
# another checkout's package (tools/bench_ipa.py --package)
IPA_BWD_OUT_SHAPES = {
    "ipa_attention_bwd_dq": lambda F, Nq, Nk, H, C, P3q, P3v, Dz: (
        (F, Nq, H, C), (F, Nq, H, P3q), (F, H, Nq)),
    "ipa_attention_bwd_dkv": lambda F, Nq, Nk, H, C, P3q, P3v, Dz: (
        (F, Nk, H, C), (F, Nk, H, P3q), (F, Nk, H, C), (F, Nk, H, P3v)),
    "ipa_attention_bwd_pair": lambda F, Nq, Nk, H, C, P3q, P3v, Dz: (
        (Nq, Nk, H), (Nq, Nk, Dz)),
}


def ipa_kernel_ms(torch, mod, kind: str, operands, c_qk: float,
                  reps: int, key_mask=None) -> float:
    """The time of IPA launcher ``kind`` (a forward's, ``*_fwd``, on the
    forward's 10 inputs, or a backward one, ``*_bwd_{dq,dkv,pair}``, on the
    15 backward inputs, of any route's library) alone: outputs
    allocated once, then ``reps`` launches straight through the library of
    ``mod`` (no checks, no counter moves). A package whose launchers take
    a key mask and Nk (``input_shapes`` marks it) gets the query mask twice
    in the square call; ``key_mask`` makes the call rectangular (keys
    ``operands[1].shape[1]``), which an older package cannot take."""
    q = operands[0]
    F, N, H, C = q.shape
    Nk = operands[1].shape[1]
    Dz = operands[7].shape[-1]
    rect = hasattr(mod, "input_shapes")
    check(rect or (key_mask is None and Nk == N), f"{kind}: this package's "
          "launchers take square calls only")
    if kind.endswith("_fwd"):
        Pq, Pv = operands[3].shape[-2], operands[5].shape[-2]
        shapes = ((F, N, H, C), (F, N, H, Pv, 3), (F, N, H, Dz), (F, H, N))
        lib = mod._lib(kind)
    else:
        Pq, Pv = operands[3].shape[-1] // 3, operands[5].shape[-1] // 3
        base = "ipa_attention_bwd_" + kind.rsplit("_", 1)[1]
        shapes = IPA_BWD_OUT_SHAPES[base](F, N, Nk, H, C, 3 * Pq, 3 * Pv, Dz)
        lib = mod._lib(kind[:kind.rindex("_")])
    outs = [torch.empty(s, dtype=torch.float32, device=q.device)
            for s in shapes]
    operands = tuple(operands)
    if rect:  # the key mask after the query mask
        km = operands[8] if key_mask is None else key_mask
        operands = operands[:9] + (km,) + operands[9:]
    ptrs = [t.data_ptr() for t in operands + tuple(outs)]
    fn = getattr(lib, kind)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sizes = (F, N, Nk) if rect else (F, N)
    args = (*ptrs, *sizes, H, C, Pq, Pv, Dz, c_qk, math.sqrt(1.0 / 3), 1e5,
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
# the online softmax rescales it away. The last four are past the
# tensor-core kernels' widths (ipa_attention.TILE_LIMITS) and run the wide
# tensor-core kernels: "wide" at every width past its limit
# at once (C = 384, Pq*3 = 36, Pv*3 = 54, Dz = 64; 4 heads, 203 residues
# ending in a ragged tile), "wide-dz" at the release widths with Dz = 64,
# "wide-model" at the widths and window of phase 4b's model (WIDE_MODEL:
# the release model with c_z 256, c_hidden 384, no_qk_points 12, so 8
# heads, Pv 12, Dz 64, on a 256-residue window with 56 pad rows), whose
# errors and times go into the wide kernels' reports beside the launches
# of that phase; and "past-wide-tc", past the wide tensor-core kernels'
# widths too (ipa_attention.WIDE_TC_LIMITS), where all four run on the CUDA
# cores
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
             ("wide-model", WIDE_MODEL_CASE),
             ("past-wide-tc", dict(N=37, H=2, C=392, Pq=14, Pv=20, Dz=72,
                                   masked=5)))
# the cases each IPA kernel is also timed at. The kernels line reports the
# tensor-core kernels at "release" and the wide ones at "wide-model" (the
# shapes phases 4 and 4b launch them at); the times at "wide" are printed
TIMED_CASES = (("release", {}), ("wide-model", WIDE_MODEL_CASE),
               ("wide", WIDE_CASE))
REPORTED_CASES = ("release", "wide-model")
# the IPA kernels' routes (ops/ipa_attention.kernel_route): the tensor-core
# kernels, the wide tensor-core kernels and the wide route's CUDA-core
# kernels
IPA_ROUTES = ("tc", "wide_tc", "wide")


def ipa_counts(ipa_mod) -> dict:
    """{wrapper: its launches on each of IPA_ROUTES} of this process (0 on
    a route the wrapper does not have)."""
    return {k: tuple(getattr(ipa_mod, ipa_mod.COUNTERS[(k, r)])
                     if (k, r) in ipa_mod.COUNTERS else 0
                     for r in IPA_ROUTES)
            for k in ipa_mod.WRAPPERS}


def reset_ipa_counts(ipa_mod):
    for name in ipa_mod.COUNTERS.values():
        setattr(ipa_mod, name, 0)


def ipa_routes(ipa_mod, shape: dict) -> dict:
    """{wrapper: the route ``shape``'s widths (release unless stated) select
    for it}."""
    w = dict(dict(C=256, Pq=8, Pv=12, Dz=32), **shape)
    return {k: ipa_mod.kernel_route(k, w["C"], 3 * w["Pq"], 3 * w["Pv"],
                                    w["Dz"]) for k in ipa_mod.WRAPPERS}


def on_routes(counts: dict, routes: dict) -> tuple[dict, int]:
    """({wrapper: its launches in ``counts`` on its route in ``routes``},
    the launches of every wrapper off its route)."""
    on = {k: counts[k][IPA_ROUTES.index(r)] for k, r in routes.items()}
    return on, sum(sum(c) for c in counts.values()) - sum(on.values())


def ipa_kernel_name(ipa_mod, fn: str, routes: dict) -> tuple[str, str]:
    """(launcher, library source under csrc/) of wrapper ``fn``'s kernel on
    its route."""
    lib, name = ipa_mod.launcher(fn, routes[fn])
    return name, f"dynamicpdb_tpu_torch/csrc/{lib}.cu"


def check_launched(ipa_mod, before: dict, kernels, routes: dict, label: str):
    """Each of ``kernels`` launched once since ``before`` on its route in
    ``routes``, and never on another."""
    after = ipa_counts(ipa_mod)
    for k in kernels:
        got = tuple(a - b for a, b in zip(after[k], before[k]))
        want = tuple(int(r == routes[k]) for r in IPA_ROUTES)
        check(got == want, f"{k} {label}: launches {got} on the routes "
              f"{IPA_ROUTES}, expected {want}")


def kernel_phase(torch, device, card: str) -> list[dict]:
    """The forward kernel against its plain version at every case of
    IPA_CASES, on the route its widths select; the reports of the
    tensor-core kernel (release case) and the wide tensor-core kernel
    (wide-model case), after timing it at every case of TIMED_CASES."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    reports = {}
    for label, shape in IPA_CASES:
        args, c_qk = ipa_inputs(torch, device, seed=len(label), **shape)
        routes = ipa_routes(ipa_mod, shape)
        before = ipa_counts(ipa_mod)
        got = ipa_mod.ipa_attention_fwd(*args, c_qk)
        torch.cuda.synchronize()
        check_launched(ipa_mod, before, ("ipa_attention_fwd",), routes, label)
        want = ipa_mod.ipa_attention_plain(*args, c_qk)
        errs = ipa_errors(got, want, args)
        kname, source = ipa_kernel_name(ipa_mod, "ipa_attention_fwd", routes)
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
            reports[label] = fwd_report(torch, ipa_mod, kname, source, label,
                                        args, c_qk, errs, card)
    return [reports[label] for label in REPORTED_CASES]


def fwd_report(torch, ipa_mod, kname: str, source: str, label: str, args,
               c_qk, errs, card: str) -> dict:
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
        "source": source,
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
    tensor-core kernels (wide-model case)."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    reports = {}
    for label, shape in IPA_CASES:
        args, c_qk = ipa_inputs(torch, device, seed=10 + len(label), **shape)
        routes = ipa_routes(ipa_mod, shape)
        route = "/".join(routes[k] for k in BWD_KERNELS)
        for zero_pad in (True, False):
            case = "pad cotangents 0" if zero_pad else "pad cotangents random"
            inputs, cots = ipa_bwd_inputs(torch, args, c_qk,
                                          zero_pad=zero_pad, seed=3)
            before = ipa_counts(ipa_mod)
            got = ipa_bwd_grads(torch, inputs, c_qk, plain=False)
            torch.cuda.synchronize()
            check_launched(ipa_mod, before, BWD_KERNELS, routes,
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
        routes = ipa_routes(ipa_mod, shape)
        args, c_qk = ipa_inputs(torch, device, seed=20, **shape)
        inputs, _ = ipa_bwd_inputs(torch, args, c_qk, zero_pad=False, seed=4)
        F, N, H, C = args[0].shape
        Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
        costs = ipa_bwd_cost(F, N, H, C, Pq, Pv, Dz)
        for kname, (replaces, _) in BWD_KERNELS.items():
            name, source = ipa_kernel_name(ipa_mod, kname, routes)
            kernel = getattr(ipa_mod, kname)
            plain = getattr(ipa_mod, kname.replace("ipa_attention_bwd",
                                                   "ipa_bwd") + "_plain")
            ms = time_ms(torch, lambda: kernel(*inputs, c_qk=c_qk, **kw), 50)
            kernel_ms = ipa_kernel_ms(torch, ipa_mod, name, inputs, c_qk, 50)
            plain_ms = time_ms(torch, lambda: plain(*inputs, c_qk=c_qk, **kw),
                               20)
            ops, nbytes, ew_ops = costs[kname]
            rep = {
                "name": name, "route": "cuda", "source": source,
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


# The rectangular calls of sequence parallelism (phase 9): one rank's block
# of query rows against every key. At the release window (N = 256, 56 pad
# rows) two 'seq' ranks give rows 128-255, whose block holds the 56 pad
# rows, against all 256 keys; at the release widths (tensor-core route) and
# at "wide-model" (the wide route). Every kernel against its plain version
# at the square calls' tolerances, then timed.
RECT_ROWS = (128, 256)
RECT_CASES = (("release", dict(N=256, masked=56)),
              ("wide-model", WIDE_MODEL_CASE))


def rect_block(args, rows):
    """The query side of the forward's inputs cut to ``rows`` (q, q_pts,
    bias and pair_z rows, the query mask), the keys whole; and the key
    mask."""
    q0, q1 = rows
    q, k, v, qp, kp, vp, bias, pz, mask, hw = args
    block = (q[:, q0:q1].contiguous(), k, v, qp[:, q0:q1].contiguous(), kp,
             vp, bias[q0:q1].contiguous(), pz[q0:q1].contiguous(),
             mask[:, q0:q1].contiguous(), hw)
    return block, mask


# the query-row axis of each query-side input of the backward kernels
BWD_ROW_AXIS = {"q": 1, "q_pts": 1, "bias": 0, "pair_z": 0, "mask": 1,
                "lse": 2, "dvec": 2, "g_o": 1, "g_opt": 1, "g_pair": 1}


def rect_bwd_block(ipa_mod, inputs, rows):
    """The query side of the 15 backward inputs cut to ``rows``
    (BWD_ROW_AXIS), the keys whole."""
    q0, q1 = rows
    return tuple(
        t.narrow(BWD_ROW_AXIS[n], q0, q1 - q0).contiguous()
        if n in BWD_ROW_AXIS else t
        for n, t in zip(ipa_mod.BWD_INPUT_NAMES, inputs))


def rect_rows_equal(torch, ipa_mod, full, c_qk, rows, label: str):
    """Each IPA kernel's outputs on the query rows ``rows`` of the window
    ``full`` (a rectangular call against every key) equal the square
    call's rows bit for bit: the forward's four outputs, dq, dqp and the
    dhw rows, dbias and dpz (dk, dv and their points are sums over the
    rows, not rows)."""
    q0, q1 = rows
    block, key_mask = rect_block(full, rows)
    sq = ipa_mod.ipa_attention_fwd(*full, c_qk)
    rect = ipa_mod.ipa_attention_fwd(*block, c_qk, key_mask=key_mask)
    pairs = {n: (a[:, :, q0:q1] if n == "lse" else a[:, q0:q1], b)
             for n, a, b in zip(("o", "o_pt", "o_pair", "lse"), sq, rect)}
    inputs, _ = ipa_bwd_inputs(torch, full, c_qk, zero_pad=False, seed=6)
    kw = dict(c_qk=c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5)
    cut = rect_bwd_block(ipa_mod, inputs, rows)
    for fn, names in (("ipa_attention_bwd_dq", ("dq", "dqp", "dhw_rows")),
                      ("ipa_attention_bwd_pair", ("dbias", "dpz"))):
        sq = getattr(ipa_mod, fn)(*inputs, **kw)
        rect = getattr(ipa_mod, fn)(*cut, key_mask=key_mask, **kw)
        for n, a, b in zip(names, sq, rect):
            pairs[n] = (a[:, :, q0:q1] if n == "dhw_rows"
                        else a[q0:q1] if n in ("dbias", "dpz")
                        else a[:, q0:q1], b)
    same = {n: bool(torch.equal(a, b)) for n, (a, b) in pairs.items()}
    print(f"kernel rectangular {label} rows {q0}-{q1 - 1}: equal to the "
          f"square call's rows bit for bit: {same}")
    check(all(same.values()), f"rectangular {label}: rows differ from the "
          f"square call's: {same}")


def rect_kernel_phase(torch, device, card: str, reports: dict):
    """The four IPA kernels on rows ``RECT_ROWS`` of each ``RECT_CASES``
    window against their plain versions (the backward with cotangents zero
    on pad rows and everywhere) and against the square call's rows
    (rect_rows_equal), each timed through its wrapper, alone and plain;
    each result goes into ``reports[kernel name]["rectangular"]`` (the
    tensor-core kernels' reports at "release", the wide route's at
    "wide-model")."""
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    kw = dict(c_b=math.sqrt(1.0 / 3), inf=1e5)
    for label, shape in RECT_CASES:
        full, c_qk = ipa_inputs(torch, device, seed=30 + len(label), **shape)
        args, key_mask = rect_block(full, RECT_ROWS)
        routes = ipa_routes(ipa_mod, shape)
        fwd_name, _ = ipa_kernel_name(ipa_mod, "ipa_attention_fwd", routes)
        F, Nq, H, C = args[0].shape
        Nk = args[1].shape[1]
        Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
        case = (f"{label} rows {RECT_ROWS[0]}-{RECT_ROWS[1] - 1}: F={F} "
                f"Nq={Nq} Nk={Nk} H={H} C={C} Pq={Pq} Pv={Pv} Dz={Dz}")
        # the forward
        before = ipa_counts(ipa_mod)
        got = ipa_mod.ipa_attention_fwd(*args, c_qk, key_mask=key_mask)
        torch.cuda.synchronize()
        check_launched(ipa_mod, before, ("ipa_attention_fwd",), routes,
                       f"rectangular {label}")
        want = ipa_mod.ipa_attention_plain(*args, c_qk, key_mask=key_mask)
        errs = ipa_errors(got, want, args)
        for name in ("o", "o_pt", "o_pair"):
            e = errs[name]
            print(f"kernel {fwd_name} rectangular {case}: {name} max_abs_err "
                  f"real rows {e['real']:.3e} (tol {e['tol_real']:.0e}), pad "
                  f"rows {e['pad']:.3e} (tol {e['tol_pad']:.3e})")
            check(e["real"] <= e["tol_real"] and e["pad"] <= e["tol_pad"],
                  f"{fwd_name} rectangular {label} {name}: {e}")
        check(errs["lse"]["ok"], f"{fwd_name} rectangular {label}: lse "
              f"{errs['lse']['max']}")
        streams = [errs[n] for n in ("o", "o_pt", "o_pair")]
        ops, nbytes, ew_ops = ipa_cost(F, Nq, H, C, Pq, Pv, Dz, Nk=Nk)
        rect = {
            "case": case,
            "max_abs_err": max(max(e["real"], e["pad"]) for e in streams),
            "ms": time_ms(torch, lambda: ipa_mod.ipa_attention_fwd(
                *args, c_qk, key_mask=key_mask), 50),
            "ms_kernel": ipa_kernel_ms(torch, ipa_mod, fwd_name, args,
                                       c_qk, 50, key_mask=key_mask),
            "plain_ms": time_ms(torch, lambda: ipa_mod.ipa_attention_plain(
                *args, c_qk, key_mask=key_mask), 20),
            **bounds(ops, ew_ops, nbytes),
        }
        reports[fwd_name]["rectangular"] = rect
        print(f"kernel {fwd_name} rectangular {case}: {rect['ms']:.4f} ms "
              f"through the wrapper, {rect['ms_kernel']:.4f} ms alone, plain "
              f"{rect['plain_ms']:.4f} ms, bound {rect['bound_ms']:.4f} ms, "
              f"tensor-core bound {rect['tc_bound_ms']:.4f} ms [{card}]")
        # the three backward kernels
        errs_by = {}
        for zero_pad in (True, False):
            inputs, _ = ipa_bwd_inputs(torch, args, c_qk, zero_pad=zero_pad,
                                       seed=5, key_mask=key_mask)
            before = ipa_counts(ipa_mod)
            got = ipa_bwd_grads(torch, inputs, c_qk, plain=False,
                                key_mask=key_mask)
            torch.cuda.synchronize()
            check_launched(ipa_mod, before, BWD_KERNELS, routes,
                           f"rectangular {label}")
            want = ipa_bwd_grads(torch, inputs, c_qk, plain=True,
                                 key_mask=key_mask)
            pad_scale = (None if zero_pad else ipa_bwd_pad_scale(
                torch, inputs, c_qk, key_mask=key_mask))
            cots = "pad cotangents 0" if zero_pad else "pad cotangents random"
            for name, (err, tol) in ipa_bwd_errors(got, want,
                                                   pad_scale).items():
                print(f"kernel backward rectangular {case}, {cots}: {name} "
                      f"max_abs_err {err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"backward rectangular {label} {cots}: "
                      f"{name} {err} > {tol}")
                errs_by[(zero_pad, name)] = err
        rect_rows_equal(torch, ipa_mod, full, c_qk, RECT_ROWS, label)
        costs = ipa_bwd_cost(F, Nq, H, C, Pq, Pv, Dz, Nk=Nk)
        for kname, (_, grads) in BWD_KERNELS.items():
            name, _ = ipa_kernel_name(ipa_mod, kname, routes)
            kernel = getattr(ipa_mod, kname)
            plain = getattr(ipa_mod, kname.replace("ipa_attention_bwd",
                                                   "ipa_bwd") + "_plain")
            kwk = dict(kw, c_qk=c_qk, key_mask=key_mask)
            ops, nbytes, ew_ops = costs[kname]
            rect = {
                "case": case,
                "max_abs_err": max(errs_by[(True, g)] for g in grads),
                "max_abs_err_pad_cotangents": max(errs_by[(False, g)]
                                                  for g in grads),
                "ms": time_ms(torch, lambda: kernel(*inputs, **kwk), 50),
                "ms_kernel": ipa_kernel_ms(torch, ipa_mod, name, inputs,
                                           c_qk, 50, key_mask=key_mask),
                "plain_ms": time_ms(torch, lambda: plain(*inputs, **kwk), 20),
                **bounds(ops, ew_ops, nbytes),
            }
            reports[name]["rectangular"] = rect
            print(f"kernel {name} rectangular {case}: {rect['ms']:.4f} ms "
                  f"through the wrapper, {rect['ms_kernel']:.4f} ms alone, "
                  f"plain {rect['plain_ms']:.4f} ms, bound "
                  f"{rect['bound_ms']:.4f} ms, tensor-core bound "
                  f"{rect['tc_bound_ms']:.4f} ms [{card}]")


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
                wdtype=None, rows: tuple | None = None,
                masked_suffix: int = 0):
    """Seeded inputs of kernel ``kind`` at its release widths and length L:
    x ~ N(0, 1) (a normalised activation) in ``dtype``, weights ~ N(0, 1/d)
    and biases ~ N(0, 0.1^2) in ``wdtype`` (default: ``dtype``), the
    attention bias ~ N(0, 1) with the last ``pad`` keys at -1e9 (pad_safe
    padding); node_attention's key mask drops ~12% of the keys of every row
    but the first (the pseudo-MSA's mask rate), row 1 also its first
    ``masked_prefix`` keys and every odd row its last ``masked_suffix``.
    ``B`` overrides the release batch (B = L for geom_attention).
    ``rows`` = (q0, Lq): node_attention's rectangular call, the query rows
    [q0, q0 + Lq) (``inp["q0"]``) with their rows of the bias (rows past L
    have a bias too: a 'seq' rank's pad rows)."""
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
    q0, Lq = rows or (0, L)
    bias = rnd(R, H, max(L, q0 + Lq), L)[:, :, q0:q0 + Lq].contiguous()
    if pad:
        bias[..., L - pad:] = -1e9
    kmask = None
    if kind == "node_attention":
        kmask = (torch.rand((B, L), generator=g, device=device) > 0.12).float()
        kmask[0] = 1.0
        kmask[1, :masked_prefix] = 0.0
        kmask[1::2, L - masked_suffix:] = 0.0
        x, bias = x[:, 0], bias[0]
    w = {k: v.to(wdtype or dtype) for k, v in w.items()}
    return dict(x=x, bias=bias, kmask=kmask, q0=q0, **w)


def geom_call(mod, kind: str, inp: dict, plain: bool):
    """The kernel (or its plain version) on ``inp``."""
    c, scale = GEOM_C, GEOM_C ** -0.5
    args = [inp["x"], inp["qg_w"], inp["qg_b"], inp["kv_w"], inp["kv_b"],
            inp["bias"]]
    if kind == "node_attention":
        fn = mod.node_attention_plain if plain else mod.fused_gated_node_attention
        # q0 only for a rectangular call: another checkout's package may
        # predate it (tools/bench_geom.py --package)
        q0 = {"q0": inp["q0"]} if inp.get("q0") else {}
        return fn(*args, inp["kmask"], c=c, scale=scale, **q0)
    fn = mod.geom_attention_plain if plain else mod.fused_gated_geom_attention_t
    return fn(*args, c=c, scale=scale)


def geom_error(got, want) -> tuple[float, float]:
    """(max_abs_err, how far past its tolerance: <= 0 passes)."""
    import torch

    w = want.float()
    err = (got.float() - w).abs()
    rtol = GEOM_BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    return float(err.max()), float((err - rtol * w.abs() - GEOM_ATOL).max())


def geom_cost(kind: str, L: int, bytes_per_elem: int = 4, *,
              B: int | None = None, Lq: int | None = None):
    """(operations, bytes, elementwise operations) of one launch of Lq query
    rows (default L) against L keys: the q|gate projection of the Lq rows
    and the k|v projection of the L rows, the two Lq x L x c contractions
    (2 per multiply-add), ~4 elementwise operations per logit and ~4 per
    output; x read once, the bias, key mask and weights once, the output
    written once. ``B`` overrides the release batch (B = L for
    geom_attention)."""
    shp = GEOM_SHAPES[kind]
    B = B or shp["B"] or L
    Lq = Lq or L
    R, H, d, c = shp["R"], shp["H"], shp["d"], GEOM_C
    G = R * H
    ew_ops = B * G * (4 * Lq * L + 4 * Lq * c)
    ops = B * G * (2 * (Lq + L) * d * 2 * c + 4 * Lq * L * c) + ew_ops
    nbytes = (bytes_per_elem * (B * R * L * d + B * G * Lq * c)
              + 4 * (G * Lq * L + 2 * G * d * 2 * c + 2 * G * 2 * c))
    if kind == "node_attention":
        nbytes += 4 * B * L
    return ops, nbytes, ew_ops


GEOM_REPLACES = {
    "geom_attention": "dynamicpdb_tpu/ops/pallas/geom_attention.py:50",
    "node_attention": "dynamicpdb_tpu/ops/pallas/geom_attention.py:76",
}


def geom_kernel_launch(torch, mod, kind: str, inp: dict,
                       rows: int | None = None):
    """A function that launches kernel ``kind`` alone on ``inp`` and
    returns its output ([B, R*H, Lq, c]): the operands prepared once by the
    wrapper's kernel_inputs, the output allocated once, no counter moved;
    in the instance of ``rows`` query rows a block (None: the one the
    wrapper takes)."""
    x, bias = inp["x"], inp["bias"]
    if kind == "node_attention":
        x, bias = x[:, None], bias[None]
    B, R, L, d = x.shape
    H, Lq = inp["qg_w"].shape[2], bias.shape[2]
    ops = mod.kernel_inputs(kind, x, inp["qg_w"], inp["qg_b"], inp["kv_w"],
                            inp["kv_b"], bias, inp["kmask"], GEOM_C)
    out = torch.empty((B, R * H, Lq, GEOM_C), dtype=x.dtype, device=x.device)
    lib, stream = mod._lib(), torch.cuda.current_stream().cuda_stream
    # the query block only for a rectangular call, as in geom_call
    rect = ({"q0": inp["q0"], "Lq": Lq} if (inp.get("q0") or Lq != L)
            else {})
    if rows is not None:  # a package before the instances has no rows
        rect["rows"] = rows

    def run():
        mod.launch(lib, kind, ops, out, B, R, H, L, d, GEOM_C, GEOM_C ** -0.5,
                   x.device.index, stream, **rect)
        return out
    return run


def geom_kernel_ms(torch, mod, kind: str, inp: dict, reps: int,
                   rows: int | None = None) -> float:
    """The time of kernel ``kind`` alone (``geom_kernel_launch``), ``reps``
    launches. The wrapper's own per-call work (checks, views, casts of bf16
    weights) runs on the host and is timed apart, through the public
    function."""
    return time_ms(torch, geom_kernel_launch(torch, mod, kind, inp, rows),
                   reps)


def sdpa_core_ms(torch, mod, kind: str, inp: dict) -> float:
    """The time of torch's scaled_dot_product_attention on the q, k, v and
    bias (+ key mask) of these inputs: the attention core only, without the
    projections and the gate the kernel fuses."""
    c = GEOM_C
    x = inp["x"].float()
    if kind == "node_attention":
        x = x[:, None]
    Lq = inp["bias"].shape[-2]
    xq = mod.query_rows(x, inp.get("q0", 0), Lq)
    qg = torch.einsum("brld,drhe->brhle", xq, inp["qg_w"].float()) + inp["qg_b"].float()
    kv = torch.einsum("brld,drhe->brhle", x, inp["kv_w"].float()) + inp["kv_b"].float()
    B, R, H, L = kv.shape[:4]
    q = qg[..., :c].reshape(B, R * H, Lq, c).contiguous()
    k, v = (t.reshape(B, R * H, L, c).contiguous()
            for t in (kv[..., :c], kv[..., c:]))
    mask = inp["bias"].float().reshape(1, -1, Lq, L)
    if kind == "node_attention":
        mask = mask + (inp["kmask"][:, None, None, :] - 1.0) * 1e9
    mask = mask.expand(B, R * H, Lq, L)
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
            "tile_rows": mod.tile_rows(256),
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
    af2_attention_checks(torch, device)
    return list(reports.values())


# phase 2b's AlphaFold2 cases: both wrappers at the shapes model_5's path
# calls them at (256 residues, 512 MSA clusters), set up as
# models/alphafold/model.py sets them up: MSA row attention (512 rows of
# 256 keys, a bias from the pair), MSA column attention (the wrapper on the
# MSA's transpose: 256 rows of 512 keys, a zero bias), triangle attention
# on z and on z's transpose (one axis, H 4, d 128). Every key unmasked, as
# the path's are. (label, kind, rows, keys, H, d)
AF2_ATTENTION_CASES = (
    ("msa_row", "node_attention", 512, 256, 8, 256),
    ("msa_column", "node_attention", 256, 512, 8, 256),
    ("triangle_start", "geom_attention", 256, 256, 4, 128),
    ("triangle_end", "geom_attention", 256, 256, 4, 128),
)


def af2_attention_inputs(torch, device, case: tuple, seed: int) -> dict:
    """Seeded float32 inputs of an AF2_ATTENTION_CASES call (the keys of
    ``geom_inputs``' dict): x the LayerNorm of N(0, 1) activations, laid
    out as the model lays it out; weights ~ N(0, 1/d), biases ~ N(0,
    0.1^2); the pair bias ~ N(0, 1), zero for column attention."""
    from dynamicpdb_tpu_torch.models.omegafold.core import layer_norm_f32

    label, kind, rows, keys, H, d = case
    c = GEOM_C
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    w = dict(qg_w=rnd(d, 1, H, 2 * c, scale=d ** -0.5),
             qg_b=rnd(1, H, 1, 2 * c, scale=0.1),
             kv_w=rnd(d, 1, H, 2 * c, scale=d ** -0.5),
             kv_b=rnd(1, H, 1, 2 * c, scale=0.1))
    kmask = None
    if label == "msa_row":  # m [M, L, c_m]
        x, bias = layer_norm_f32(rnd(rows, keys, d)), rnd(H, keys, keys)
        kmask = torch.ones(rows, keys, device=device)
    elif label == "msa_column":  # m [M, L, c_m] -> [L, M, c_m]
        x = layer_norm_f32(rnd(keys, rows, d)).transpose(0, 1).contiguous()
        bias = torch.zeros(H, keys, keys, device=device)
        kmask = torch.ones(rows, keys, device=device)
    else:  # z [L, L, c_z], the ending node on z's transpose
        z = rnd(keys, keys, d)
        x = layer_norm_f32(z if label == "triangle_start"
                           else z.transpose(0, 1)).unsqueeze(1)
        bias = rnd(1, H, keys, keys)
    return dict(x=x, bias=bias, kmask=kmask, **w)


def af2_attention_checks(torch, device) -> float:
    """Both wrappers against their plain versions at AF2_ATTENTION_CASES,
    float32 (tolerance GEOM_ATOL), each call counted once. Returns the
    largest error."""
    from dynamicpdb_tpu_torch.ops import geom_attention as mod

    counters = {"node_attention": "node_launches",
                "geom_attention": "geom_launches"}
    worst = 0.0
    for i, case in enumerate(AF2_ATTENTION_CASES):
        label, kind, rows, keys = case[:4]
        inp = af2_attention_inputs(torch, device, case, seed=240 + i)
        before = getattr(mod, counters[kind])
        got = geom_call(mod, kind, inp, plain=False)
        torch.cuda.synchronize()
        check(getattr(mod, counters[kind]) == before + 1,
              f"{kind} alphafold {label}: launches {before} -> "
              f"{getattr(mod, counters[kind])}")
        want = geom_call(mod, kind, inp, plain=True)
        check(got.shape == want.shape, f"{kind} alphafold {label}: "
              f"{tuple(got.shape)}, want {tuple(want.shape)}")
        err, over = geom_error(got, want)
        print(f"kernel {kind} alphafold {label} ({rows} rows of {keys} "
              f"keys) float32: max_abs_err {err:.3e} (tol {GEOM_ATOL}; "
              f"scale {float(want.abs().max()):.3f})")
        check(over <= 0, f"{kind} alphafold {label}: max_abs_err {err} "
              "out of tolerance")
        worst = max(worst, err)
        del inp, got, want
    return worst


# The rectangular calls of OmegaFold under sequence parallelism (phase 10):
# node_attention on one rank's block of query rows [q0, q0 + Lq) against
# all L keys (two 'seq' ranks: rows 0-127 and 128-255 of the release
# window; the ragged 203 residues give rank 1 rows 102-203, its last a pad
# row past L; phase 10b's rank 1 rows 256-511 of 512), the odd pseudo-MSA
# rows with their last 33 keys masked; and geom_attention with a rank's B
# = 128 rows of a 256 window as its batch, the bias whole. Then the square
# calls of phase 11a's 96 residues, both kernels. (label, kind, L, (q0, Lq)
# or None, B). The calls of at most 128 query rows run the 128-row
# instance (ops/geom_attention.tile_rows), the others the 256-row one.
GEOM_RECT_CASES = (
    ("rows 128-255", "node_attention", 256, (128, 128), None),
    ("rows 0-127", "node_attention", 256, (0, 128), None),
    ("ragged rows 102-203", "node_attention", 203, (102, 102), None),
    ("rows 256-511", "node_attention", 512, (256, 256), None),
    ("B 128", "geom_attention", 256, None, 128),
    ("L 96", "node_attention", 96, None, None),
    ("L 96", "geom_attention", 96, None, None),
)
GEOM_RECT_MASKED = 33
GEOM_RECT_TIMED = {"node_attention": "rows 128-255",
                   "geom_attention": "B 128"}


def geom_rect_phase(torch, device, card: str) -> list[dict]:
    """Phase 2b's rectangular and short calls (GEOM_RECT_CASES) against
    their plain versions at phase 2b's tolerances, float32 and bfloat16,
    each a block's rows against the square call's (or a batch's half
    against its own call) and, where it runs the 128-row instance, against
    the 256-row instance on the same inputs, bit for bit; then one case of
    each kernel (GEOM_RECT_TIMED) timed as phase 2b times the square
    calls, with its bounds at the rectangular work and the instance it ran.
    Returns the two reports (``launches`` filled by phase 10)."""
    from dynamicpdb_tpu_torch.ops import geom_attention as mod

    worst, inputs = {}, {}
    for label, kind, L, rows, B in GEOM_RECT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            inp = geom_inputs(torch, device, kind, L, dtype,
                              seed=40 + L + (dtype == torch.bfloat16), B=B,
                              rows=rows, masked_suffix=GEOM_RECT_MASKED)
            got = geom_call(mod, kind, inp, plain=False)
            torch.cuda.synchronize()
            want = geom_call(mod, kind, inp, plain=True)
            check(got.dtype == dtype and got.shape == want.shape,
                  f"{kind} {label}: {got.dtype} {tuple(got.shape)}, want "
                  f"{dtype} {tuple(want.shape)}")
            err, over = geom_error(got, want)
            print(f"kernel {kind} rectangular {label} L={L} "
                  f"{str(dtype)[6:]}: max_abs_err {err:.3e} (tol "
                  f"{'1e-4' if dtype == torch.float32 else '1e-4 + 2^-7 |want|'}"
                  f"; scale {float(want.float().abs().max()):.3f})")
            check(over <= 0, f"{kind} rectangular {label} {dtype}: "
                  f"max_abs_err {err} out of tolerance")
            # a row's arithmetic does not depend on the rows beside it:
            # the block's rows are the square call's bit for bit
            if kind == "geom_attention" and B:
                half = dict(inp, x=inp["x"][:B // 2])
                same = torch.equal(geom_call(mod, kind, half, plain=False),
                                   got[:B // 2])
                what = f"batch rows 0-{B // 2 - 1} of a {B // 2}-row call"
            elif rows and rows[0] + rows[1] <= L:
                square = geom_inputs(torch, device, kind, L, dtype,
                                     seed=40 + L + (dtype == torch.bfloat16),
                                     masked_suffix=GEOM_RECT_MASKED)
                same = torch.equal(geom_call(mod, kind, square, plain=False)
                                   [:, :, rows[0]:rows[0] + rows[1]], got)
                what = "the square call's rows"
            else:
                same, what = True, None
            if what:
                print(f"kernel {kind} rectangular {label} {str(dtype)[6:]}: "
                      f"equal to {what} bit for bit: {same}")
                check(same, f"{kind} rectangular {label} {dtype}: not "
                      f"{what} bit for bit")
            # nor on the instance: the 128-row tile's rows are the 256-row
            # tile's
            tile = mod.tile_rows(rows[1] if rows else L)
            if tile != max(mod.TILE_ROWS):
                other = geom_kernel_launch(torch, mod, kind, inp,
                                           max(mod.TILE_ROWS))()
                same = torch.equal(other.view(got.shape), got)
                print(f"kernel {kind} rectangular {label} {str(dtype)[6:]}: "
                      f"the {tile}-row instance equal to the "
                      f"{max(mod.TILE_ROWS)}-row one bit for bit: {same}")
                check(same, f"{kind} rectangular {label} {dtype}: the "
                      f"{tile}-row instance differs from the "
                      f"{max(mod.TILE_ROWS)}-row one")
            if dtype == torch.float32:
                worst[kind] = max(worst.get(kind, 0.0), err)
                if GEOM_RECT_TIMED[kind] == label:
                    inputs[kind] = (inp, L, rows, B)
            del got, want
    reports = []
    for kind, (inp, L, rows, B) in inputs.items():
        Lq = rows[1] if rows else L
        ops, nbytes, ew_ops = geom_cost(kind, L, B=B, Lq=Lq)
        rep = {
            "name": f"{kind}_rectangular", "route": "cuda",
            "source": "dynamicpdb_tpu_torch/csrc/geom_attention.cu",
            "replaces": GEOM_REPLACES[kind], "launches": None,
            "case": GEOM_RECT_TIMED[kind], "tile_rows": mod.tile_rows(Lq),
            "max_abs_err": worst[kind],
            "ms": time_ms(torch, lambda: geom_call(mod, kind, inp,
                                                   plain=False), 20),
            "ms_kernel": geom_kernel_ms(torch, mod, kind, inp, 20),
            "plain_ms": time_ms(torch, lambda: geom_call(mod, kind, inp,
                                                         plain=True), 5),
            **bounds(ops, ew_ops, nbytes),
            "library_ms": sdpa_core_ms(torch, mod, kind, inp),
            "library": "scaled_dot_product_attention (attention core only)",
        }
        reports.append(rep)
        print(f"kernel {kind} rectangular {rep['case']} float32, the "
              f"{rep['tile_rows']}-row instance: "
              f"{rep['ms']:.4f} ms through the wrapper, {rep['ms_kernel']:.4f}"
              f" ms alone, plain {rep['plain_ms']:.4f} ms, SDPA core only "
              f"{rep['library_ms']:.4f} ms, bound {rep['bound_ms']:.4f} ms "
              f"({rep['bound_by']}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f}"
              f" MB), tensor-core bound {rep['tc_bound_ms']:.4f} ms "
              f"({rep['tc_bound_by']}); warm L2 [{card}]")
    return reports


# ---------------------------------------------------------------------------
# phase 2c: GeometricAttention's triangle-multiplicative route
# ---------------------------------------------------------------------------
TRI_D = 128  # the release edge width, the one the kernels are built for
# (label, L, (q0, Lr) or None, masked tail, pad_safe): the release square
# call; a ragged L with its padded tail masked as pad_safe masks it; the
# short calls of phase 11a; a 'seq' rank's rows 128-255 of the release
# window, pad_safe; rank 1's rows of a ragged 203 (its last a pad row)
TRI_CASES = (("release", 256, None, 0, False),
             ("ragged pad_safe", 203, None, 11, True),
             ("L 96", 96, None, 0, False),
             ("rows 128-255 pad_safe", 256, (128, 128), 32, True),
             ("ragged rows 102-203", 203, (102, 102), 0, False))
# float32 on both sides, sums of 128 and 256 terms in another order, then
# a LayerNorm that rescales ab by ~1/4 at these inputs: 1e-4 on unit-scale
# outputs, as the attention kernels. bfloat16: the route computes in
# float32 from the bf16 values and rounds its result once, so it is held
# against the plain version run in float32 on the same bf16 values, whose
# result rounded to bf16 may differ by one bf16 step: 2^-7 |want| on top
# (the plain version in bf16 rounds every intermediate to bf16 instead).
TRI_ATOL = 1e-4
TRI_BF16_RTOL = 2.0 ** -7
TRI_KERNELS = ("tri_proj", "tri_mm", "tri_out")


def triangle_inputs(torch, device, L: int, dtype, seed: int, *,
                    rows: tuple | None = None, masked: int = 0) -> dict:
    """Seeded inputs of ``geom_triangle`` at the release width: the whole
    normalised edge ~ N(0, 1) [L, L, d], a rank's rows [q0, q0 + Lr) of it
    as ``edge`` (pad rows past L ~ N(0, 1): the model's pad rows hold
    values too; ``edge`` is ``whole`` for the square call), attended ~ N(0,
    1), the mask with its last ``masked`` residues 0, weights ~ N(0, 1/d)
    and biases ~ N(0, 0.1^2), all in ``dtype`` but the float32 mask."""
    d = TRI_D
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    whole = rnd(L, L, d)
    q0, Lr = rows or (0, L)
    edge = whole
    if rows:
        real = whole[q0:min(q0 + Lr, L)]
        edge = torch.cat([real, rnd(Lr - real.shape[0], L, d)])
    mask = torch.ones(L, device=device)
    mask[L - masked:] = 0.0
    return dict(edge=edge, whole=whole, attended=rnd(Lr, L, d), mask=mask,
                act_w=rnd(d, 2, 5 * d, scale=d ** -0.5),
                act_b=rnd(2, 5 * d, scale=0.1),
                out_proj_w=rnd(2, d, d, scale=d ** -0.5),
                out_proj_b=rnd(2, d, scale=0.1), q0=q0)


TRI_ARGS = ("edge", "whole", "attended", "mask", "act_w", "act_b",
            "out_proj_w", "out_proj_b")


def triangle_call(mod, inp: dict, pad_safe: bool, plain: bool):
    """The route (or its plain version) on ``inp``; the plain version of a
    bf16 call runs in float32 on the same values and rounds its result
    (TRI_BF16_RTOL says why)."""
    args = [inp[k] for k in TRI_ARGS]
    if not plain:
        return mod.geom_triangle(*args, q0=inp["q0"], pad_safe=pad_safe)
    out = mod.geom_triangle_plain(*(a.float() for a in args), q0=inp["q0"],
                                  pad_safe=pad_safe)
    return out.to(inp["attended"].dtype)


def triangle_error(got, want) -> tuple[float, float]:
    """(max_abs_err, how far past its tolerance: <= 0 passes)."""
    import torch

    w = want.float()
    err = (got.float() - w).abs()
    rtol = TRI_BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    return float(err.max()), float((err - rtol * w.abs() - TRI_ATOL).max())


def triangle_cost(L: int) -> dict:
    """{kernel: (products, bytes)} of one square float32 call at the release
    width: products are 2 operations a multiply-add, at the unpadded
    length; bytes count each input read once and each output written once,
    the kernels' float32 operands at their padded length Lp."""
    from dynamicpdb_tpu_torch.ops.geom_triangle import padded_length

    d, Lp, f = TRI_D, padded_length(L), 4
    x = f * L * L * d  # the edge, attended or out
    weights = f * (d * 2 * 5 * d + 2 * 5 * d + 2 * d * d + 2 * d + L)
    act = f * 2 * d * 2 * L * Lp  # act_row and act_col
    ab = f * 2 * d * L * Lp
    return {
        "tri_proj": (2 * 2 * 2 * L * L * d * 2 * d, x + weights + act),
        "tri_mm": (2 * 2 * d * L * L * L, act + ab),
        "tri_out": (2 * 2 * L * L * 2 * d * d, ab + 3 * x + weights),
    }


def triangle_kernel_ms(torch, mod, inp: dict, kernel: str, reps: int,
                       pad_safe: bool = False) -> float:
    """The time of one of the route's kernels alone (``mod.launch`` with
    only ``kernel``; its operands prepared once, its input tensors as
    torch.empty left them), ``reps`` launches."""
    ops = mod.kernel_inputs(*(inp[k] for k in TRI_ARGS), q0=inp["q0"])
    return time_ms(torch, lambda: mod.launch(ops, q0=inp["q0"],
                                             pad_safe=pad_safe,
                                             kernels=(kernel,)), reps)


def triangle_counts(mod) -> dict:
    """The route's counters of ``ops.geom_triangle``: its calls on the card
    (``geom_triangle``) and each kernel's launches."""
    return {"geom_triangle": mod.triangle_launches,
            **{k: getattr(mod, f"{k}_launches") for k in TRI_KERNELS}}


def reset_triangle_counts(mod) -> None:
    mod.triangle_launches = 0
    for k in TRI_KERNELS:
        setattr(mod, f"{k}_launches", 0)


def triangle_phase(torch, device, card: str) -> list[dict]:
    """The route against its plain version at TRI_CASES in float32 and
    bfloat16, each rectangular call's real rows against the square call's
    bit for bit; then, at the release shapes in float32, the route through
    its wrapper, each kernel alone and the plain version (the einsum
    branch the route replaces), with each kernel's bounds. Returns one
    report a kernel (``launches`` filled by phase 5)."""
    from dynamicpdb_tpu_torch.ops import geom_triangle as mod

    worst = 0.0
    for label, L, rows, masked, pad_safe in TRI_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            seed = 60 + L + (dtype == torch.bfloat16)
            inp = triangle_inputs(torch, device, L, dtype, seed, rows=rows,
                                  masked=masked)
            before = [getattr(mod, f"{k}_launches") for k in TRI_KERNELS]
            got = triangle_call(mod, inp, pad_safe, plain=False)
            torch.cuda.synchronize()
            after = [getattr(mod, f"{k}_launches") for k in TRI_KERNELS]
            check(after == [b + 1 for b in before], f"geom_triangle "
                  f"{label}: launches {before} -> {after}")
            want = triangle_call(mod, inp, pad_safe, plain=True)
            check(got.dtype == dtype and got.shape == want.shape,
                  f"geom_triangle {label}: {got.dtype} {tuple(got.shape)}, "
                  f"want {dtype} {tuple(want.shape)}")
            err, over = triangle_error(got, want)
            tol = "1e-4" if dtype == torch.float32 else "1e-4 + 2^-7 |want|"
            print(f"kernel geom_triangle {label} L={L} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e} (tol {tol}; scale "
                  f"{float(want.float().abs().max()):.3f})")
            check(over <= 0, f"geom_triangle {label} {dtype}: max_abs_err "
                  f"{err} out of tolerance")
            if rows:
                # a row's arithmetic does not depend on the rows beside it
                q0, n = rows[0], min(rows[1], L - rows[0])
                square = dict(inp, edge=inp["whole"], q0=0, attended=torch.cat(
                    [inp["whole"][:q0], inp["attended"][:n],
                     inp["whole"][q0 + n:]]))
                same = torch.equal(triangle_call(mod, square, pad_safe,
                                                 plain=False)[q0:q0 + n],
                                   got[:n])
                print(f"kernel geom_triangle {label} {str(dtype)[6:]}: real "
                      f"rows equal to the square call's bit for bit: {same}")
                check(same, f"geom_triangle {label} {dtype}: not the square "
                      "call's rows bit for bit")
            if dtype == torch.float32:
                worst = max(worst, err)
            del inp, got, want
    inp = triangle_inputs(torch, device, 256, torch.float32, seed=7)
    ms = time_ms(torch, lambda: triangle_call(mod, inp, False, plain=False),
                 20)
    plain_ms = time_ms(torch, lambda: triangle_call(mod, inp, False,
                                                    plain=True), 5)
    reports = []
    for kernel, (prods, nbytes) in triangle_cost(256).items():
        rep = {
            "name": kernel, "route": "cuda",
            "source": "dynamicpdb_tpu_torch/csrc/geom_triangle.cu",
            "replaces": None, "launches": None, "max_abs_err": worst,
            # the route's three kernels through the wrapper, and the einsum
            # branch it replaces, on the card
            "ms_route": ms, "plain_ms": plain_ms,
            "ms_kernel": triangle_kernel_ms(torch, mod, inp, kernel, 20),
            **bounds(prods, 0.0, nbytes),
        }
        reports.append(rep)
        print(f"kernel {kernel} release float32: {rep['ms_kernel']:.4f} ms "
              f"alone, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}: "
              f"{prods / 1e9:.3f} GFLOP of products, {nbytes / 1e6:.2f} MB), "
              f"tensor-core bound {rep['tc_bound_ms']:.4f} ms "
              f"({rep['tc_bound_by']}) [{card}]")
    print(f"kernel geom_triangle release float32: {ms:.4f} ms through the "
          f"wrapper (three kernels), the einsum branch it replaces "
          f"{plain_ms:.4f} ms; warm L2 [{card}]")
    return reports


# ---------------------------------------------------------------------------
# phase 2d: the triangle route's single view (AlphaFold2's multiplications)
# ---------------------------------------------------------------------------
# (L, view): the release length and a ragged one, both views
TRI_VIEW_CASES = ((256, 0), (256, 1), (203, 0), (203, 1))
TRI_VIEW_ARGS = ("edge", "attended", "mask", "act_w", "act_b",
                 "out_proj_w", "out_proj_b")


def triangle_view_inputs(torch, device, L: int, seed: int) -> dict:
    """``triangle_inputs`` with one view's weights (the two-view layout's
    view 0: act_w [d, 5d], act_b [5d], out_w [d, d], out_b [d]); the
    residual in attended's place."""
    inp = triangle_inputs(torch, device, L, torch.float32, seed)
    for k in ("act_w", "out_proj_w"):
        inp[k] = inp[k][:, 0].contiguous() if k == "act_w" else inp[k][0]
    for k in ("act_b", "out_proj_b"):
        inp[k] = inp[k][0].contiguous()
    return inp


def triangle_view_call(mod, inp: dict, view: int, plain: bool):
    fn = mod.geom_triangle_view_plain if plain else mod.geom_triangle_view
    return fn(*(inp[k] for k in TRI_VIEW_ARGS), view=view)


def triangle_view_cost(L: int) -> tuple[float, float]:
    """(products, bytes) of one single-view call, float32: the two
    operands' value and gate projections, the L^3 d product, the gate's
    and the output's projections; the edge and the residual read, the
    result written, the weights read."""
    d, f = TRI_D, 4
    prods = 2 * (2 * L * L * d * 2 * d) + 2 * d * L ** 3 + 2 * (2 * L * L * d * d)
    return prods, f * (3 * L * L * d + 6 * d * d + 6 * d + L)


def triangle_view_phase(torch, device, card: str) -> dict:
    """The single-view route against its plain version at TRI_VIEW_CASES
    (float32, tolerance TRI_ATOL), then timed at the release length
    beside its bound. Returns a kernel report."""
    from dynamicpdb_tpu_torch.ops import geom_triangle as mod

    worst = 0.0
    for L, view in TRI_VIEW_CASES:
        inp = triangle_view_inputs(torch, device, L, seed=90 + L + view)
        before = mod.tri_view_launches
        got = triangle_view_call(mod, inp, view, plain=False)
        torch.cuda.synchronize()
        check(mod.tri_view_launches == before + 1, "geom_triangle_view: "
              f"launches {before} -> {mod.tri_view_launches}")
        want = triangle_view_call(mod, inp, view, plain=True)
        err, over = triangle_error(got, want)
        print(f"kernel geom_triangle_view L={L} view {view} float32: "
              f"max_abs_err {err:.3e} (tol {TRI_ATOL}; scale "
              f"{float(want.abs().max()):.3f})")
        check(over <= 0, f"geom_triangle_view L={L} view {view}: "
              f"max_abs_err {err} out of tolerance")
        worst = max(worst, err)
    inp = triangle_view_inputs(torch, device, 256, seed=7)
    rep = {"name": "geom_triangle_view", "route": "cuda",
           "source": "dynamicpdb_tpu_torch/csrc/geom_triangle.cu",
           "replaces": None, "launches": None, "max_abs_err": worst}
    for view in (0, 1):
        rep[f"ms_view{view}"] = time_ms(torch, lambda: triangle_view_call(
            mod, inp, view, plain=False), 20)
        rep[f"plain_ms_view{view}"] = time_ms(torch, lambda: triangle_view_call(
            mod, inp, view, plain=True), 5)
    prods, nbytes = triangle_view_cost(256)
    rep.update(ms=rep["ms_view0"], **bounds(prods, 0.0, nbytes))
    print(f"kernel geom_triangle_view release float32: view 0 "
          f"{rep['ms_view0']:.4f} ms, view 1 {rep['ms_view1']:.4f} ms "
          f"through the wrapper (three kernels; the einsums "
          f"{rep['plain_ms_view0']:.4f}, {rep['plain_ms_view1']:.4f} ms), "
          f"tensor-core bound {rep['tc_bound_ms']:.4f} ms "
          f"({rep['tc_bound_by']}: {prods / 1e9:.3f} GFLOP of products, "
          f"{nbytes / 1e6:.2f} MB) [{card}]")
    return rep


def two_view_against_parent(parent: str, tmp: str) -> None:
    """The two-view route's (and both attention kernels') outputs of this
    checkout against those of the package under ``parent``, bit for bit
    (``tools/bench_geom.py --save-outputs``/``--compare-outputs``)."""
    bench = os.path.join(ROOT, "dynamicpdb_tpu_torch", "tools",
                         "bench_geom.py")
    saved = os.path.join(tmp, "parent_outputs.pt")
    run_command([sys.executable, bench, "--package", parent, "--case",
                 "release", "--rounds", "1", "--reps", "1",
                 "--save-outputs", saved], "bench_geom parent")
    out = run_command([sys.executable, bench, "--case", "release",
                       "--rounds", "1", "--reps", "1", "--compare-outputs",
                       saved], "bench_geom change")
    line = json.loads([ln for ln in out.splitlines()
                       if '"bit_identical"' in ln][-1])
    same = line["bit_identical"]
    tri = {k: v for k, v in same.items() if k.startswith("geom_triangle")}
    print(f"two-view route against {parent}: {len(tri)} triangle outputs, "
          f"bit-identical {all(tri.values())}; every output "
          f"{sum(same.values())}/{len(same)}")
    check(tri and all(same.values()), "the kernels' outputs moved against "
          f"the parent: {[k for k, v in same.items() if not v]}")


# ---------------------------------------------------------------------------
# phase 12: AlphaFold2 extraction from an MSA
# ---------------------------------------------------------------------------
def random_a3m(query: str, rows: int, seed: int) -> list[str]:
    """An alignment of ``query``: rows at 25-90% identity, 10% of the
    changes gaps, insertions after 2% of the positions."""
    rng = np.random.default_rng(seed)
    aa = "ACDEFGHIKLMNPQRSTVWY"
    lines = [">query", query]
    for r in range(1, rows):
        ident = rng.uniform(0.25, 0.9)
        row = []
        for ch in query:
            u = rng.random()
            row.append(ch if u < ident else "-" if u < ident + 0.1 * (
                1 - ident) else aa[rng.integers(20)])
            if rng.random() < 0.02:
                row.append(aa[rng.integers(20)].lower())
        lines += [f">row{r}", "".join(row)]
    return lines


def alphafold_phase(torch, device: str, tmp: str, card: str, *, cfg=None,
                    length: int = 256, rows: int = 4096, seed: int = 0
                    ) -> dict:
    """Seeded random weights at ``cfg`` (``model_5`` by default) ->
    torch.save -> the extraction CLI's main with ``--model alphafold2``
    on one random alignment. Checks the npz's keys and shapes and the
    kernel launches a recycle: every Evoformer block runs node attention
    twice (MSA row and column attention), and every block of both stacks
    the one-axis geometric attention twice (triangle attention) and the
    single-view triangle route twice; none on the CPU."""
    from dynamicpdb_tpu_torch.models.alphafold.model import (
        AlphaFoldConfig,
        random_alphafold_state_dict,
    )
    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
    from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod
    from dynamicpdb_tpu_torch.preprocess import extract_embeddings as cli

    cfg = cfg or AlphaFoldConfig()
    t0 = time.perf_counter()
    sd = random_alphafold_state_dict(cfg, seed)
    n_params = sum(v.size for v in sd.values())
    ckpt = os.path.join(tmp, f"alphafold_{device}.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    del sd
    a3m = os.path.join(tmp, f"prot_{length}.a3m")
    with open(a3m, "w") as f:
        f.write("\n".join(random_a3m(random_sequences((length,), seed)[0],
                                      rows, seed)) + "\n")
    print(f"alphafold: {n_params:,} parameters, the checkpoint and a "
          f"{rows}-row a3m written in {time.perf_counter() - t0:.2f} s")
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    geom_mod.geom_launches = geom_mod.node_launches = 0
    tri_mod.tri_view_launches = 0
    recycles = cfg.num_recycle + 1
    t0 = time.perf_counter()
    records = cli.main([
        "--model", "alphafold2", "--a3m", a3m, "--out-dir",
        os.path.join(tmp, f"af2_npz_{device}"), "--weights", ckpt,
        "--device", device])
    wall = time.perf_counter() - t0
    launched = {"node_launches": geom_mod.node_launches,
                "geom_launches": geom_mod.geom_launches,
                "tri_view_launches": tri_mod.tri_view_launches}
    per_recycle = {k: v / recycles for k, v in launched.items()}
    blocks = cfg.evoformer_blocks + cfg.extra_msa_blocks
    want = ({"node_launches": 2 * cfg.evoformer_blocks,
             "geom_launches": 2 * blocks, "tri_view_launches": 2 * blocks}
            if on_card else dict.fromkeys(launched, 0))
    check(per_recycle == want, f"alphafold: launches a recycle "
          f"{per_recycle}, expected {want}")
    r, = records
    with np.load(r["path"]) as z:
        shapes = {k: z[k].shape for k in z.files}
    L = length
    check(shapes == {"node_repr": (L, cfg.msa_dim),
                     "edge_repr": (L, L, cfg.pair_dim),
                     "single_repr": (L, cfg.struct.node_dim),
                     "confidence": ()}, f"alphafold: npz {shapes}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"alphafold: {r['name']} n_res={r['n_res']} depth={r['depth']} "
          f"{recycles} recycles: {r['seconds']:.3f} s "
          f"({r['n_res'] / r['seconds']:.2f} residues/s), mean pLDDT "
          f"{r['confidence']:.4f}; CLI {wall:.2f} s; peak "
          f"{peak / 2**30:.3f} GiB; launches a recycle {per_recycle} "
          f"[{card}]")
    return dict(record=r, launches=launched, per_recycle=per_recycle,
                params=n_params, peak_bytes=peak)


def alphafold_tiny_cfg():
    """Every part of ``model_5`` narrow and shallow, the pair width 128
    (the triangle kernels' width), for phase 12's CPU run (model_5's data
    settings, which the CLI takes)."""
    from dynamicpdb_tpu_torch.models.alphafold.model import AlphaFoldConfig
    from dynamicpdb_tpu_torch.models.omegafold.model import StructConfig

    return AlphaFoldConfig(
        msa_dim=32, pair_dim=128, extra_msa_dim=16, evoformer_blocks=2,
        extra_msa_blocks=1, msa_heads=2, msa_head_dim=8,
        extra_msa_head_dim=4, pair_heads=2, pair_head_dim=8, opm_dim=4,
        struct=StructConfig(node_dim=24, edge_dim=128, num_cycle=8,
                            num_transition=3, num_head=2, num_point_qk=2,
                            num_point_v=2, num_scalar_qk=4, num_scalar_v=4,
                            num_channel=16, num_residual_block=2,
                            hidden_dim=8, num_bins=10))


def alphafold_main() -> int:
    """``--alphafold [--parent DIR]``: phase 1's build of the triangle
    kernels, phase 2d, phase 12 at the release widths on the card and at a
    tiny size on the CPU (no launches there), and, with ``--parent``, the
    kernels' outputs against that package's, bit for bit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from dynamicpdb_tpu_torch.ops import _build
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    device = resolve_device("cuda")
    for b in _build.build(["geom_triangle", "geom_attention"]).values():
        print(f"build: {b.name} in {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if b.name == "geom_triangle" and ("registers" in line
                                              or "spill" in line):
                print(f"build: {b.name}: {line.strip()}")
    rep = triangle_view_phase(torch, device, card)
    af2_attention_checks(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        parent = (sys.argv[sys.argv.index("--parent") + 1]
                  if "--parent" in sys.argv else None)
        if parent:
            two_view_against_parent(parent, tmp)
        af2 = alphafold_phase(torch, "cuda", tmp, card)
        rep["launches"] = af2["launches"]["tri_view_launches"]
        alphafold_phase(torch, "cpu", tmp, card, cfg=alphafold_tiny_cfg(),
                        length=14, rows=600)
    print(f"total: {time.perf_counter() - t_start:.2f} s wall [{card}]")
    print(json.dumps({"kernels": [rep]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
                                launches=launched, out=out,
                                aatype=window["aatype"]))
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
        check(launched == (expect, 0, 0), f"batched rollout fast_x0={fast}: "
              f"IPA forward launches {launched}, expected ({expect}, 0, 0)")
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
        if b == 0:  # phase 9b's one-process frames
            first = dict(atoms=a, rigids=r, rollout=dict(
                init_feats={k: v[0].cpu() for k, v in batch.items()},
                n_steps=n_steps, num_t=num_t, noise_scale=noise_scale,
                seed=int(np.random.SeedSequence([seed, 0]).generate_state(
                    1, np.uint64)[0])))
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
                frames_per_s_fast_x0=B * n_steps / out[True]["seconds"],
                first=first, state_dict={k: v.cpu() for k, v in
                                         model.state_dict().items()},
                blocks=cfg.model.ipa.num_blocks)


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
    check(launched == (expect, 0, 0), f"picard: IPA forward launches "
          f"{launched}, expected ({expect}, 0, 0)")
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
    routes = ipa_routes(ipa_mod, dict(C=ipa.c_hidden, Pq=ipa.no_qk_points,
                                      Pv=ipa.no_v_points, Dz=ipa.c_z // 4))
    bwd_routes = {k: routes[k] for k in BWD_KERNELS}
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
        on, _ = on_routes(counts, bwd_routes)
        launched = tuple(on.values())
        other = sum(sum(counts[k]) for k in BWD_KERNELS) - sum(launched)
        grads[dev] = (float(loss), {n: p.grad.detach().cpu()
                                    for n, p in t.model.named_parameters()
                                    if p.grad is not None})
    expect = cfg.model.ipa.num_blocks * len(ws)
    check(launched == (expect,) * 3 and other == 0, f"{label}: backward "
          f"kernel launches {launched} on the routes {bwd_routes} ({other} "
          f"on others), expected {expect} each")
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
          f"routes {bwd_routes}")
    return dict(loss_cuda=loss_gpu, loss_cpu=loss_cpu, routes=routes)


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
                n_frames: int, max_steps: int, tmp: str, tag: str = "",
                csv: str | None = None) -> dict:
    """train_cli.main on a manifest of synthetic bundles (of ``lengths``
    residues, ``n_frames`` frames; or ``csv``'s): checks the loss
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

    csv = csv or write_manifest(tmp, lengths, n_frames)
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
    routes = (ipa_routes(ipa_mod, dict(C=ipa.c_hidden, Pq=ipa.no_qk_points,
                                       Pv=ipa.no_v_points, Dz=ipa.c_z // 4))
              if on_card else {k: "tc" for k in ipa_mod.WRAPPERS})
    on, other = on_routes(ipa_counts(ipa_mod), routes)
    launched = dict(zip(("fwd", "dq", "dkv", "pair"), on.values()))
    check(other == 0, f"train: {other} launches off the routes {routes}")
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
          f"launches {launched} on the routes {routes} ({len(moved)} of "
          f"{len(now)} tensors moved){tag}")
    ckpt = os.path.join(cfg.experiment.ckpt_dir, f"step_{exp.step}.ckpt")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    return dict(ckpt=ckpt, launched=launched, routes=routes,
                steps=exp.step_metrics, peak_bytes=peak, wall=wall, batch=B,
                csv=csv, moved=moved)


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


class Job(NamedTuple):
    """A command run from the repo root, its label, and what reads its
    result: ``finish(output, seconds)`` (by default the output)."""
    cmd: list[str]
    label: str
    finish: Callable[[str, float], Any] = lambda out, seconds: out


def run_jobs(jobs: list[Job], timeout: float = 900) -> list:
    """Every job of ``jobs`` started at once from the repo root, without
    any launcher variables of this process, each in a session of its own;
    every one must exit 0 within ``timeout`` s. The first failure, or the
    deadline, kills every one still running, whole. Then each job's
    ``finish(output, its seconds from the start)``, in order; returns what
    they return."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = ROOT
    t0 = time.monotonic()
    procs, seconds = [], [None] * len(jobs)
    try:
        for job in jobs:
            log = tempfile.TemporaryFile(mode="w+")
            procs.append((subprocess.Popen(
                job.cmd, cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT, text=True, start_new_session=True),
                log))
        while None in seconds:
            for i, (proc, log) in enumerate(procs):
                if seconds[i] is not None or proc.poll() is None:
                    continue
                seconds[i] = time.monotonic() - t0
                if proc.returncode != 0:
                    log.seek(0)
                    check(False, f"{jobs[i].label}: exit {proc.returncode}\n"
                          f"{log.read()[-6000:]}")
            late = [j.label for j, s in zip(jobs, seconds) if s is None]
            if late and time.monotonic() - t0 > timeout:
                raise CheckFailed(f"{late}: no end within {timeout} s")
            time.sleep(0.2)
        outs = []
        for _, log in procs:
            log.seek(0)
            outs.append(log.read())
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            log.close()
    return [job.finish(out, s) for job, out, s in zip(jobs, outs, seconds)]


def run_commands(cmds: list[tuple[list[str], str]],
                 timeout: float = 900) -> list[str]:
    """``run_jobs`` of each (cmd, label) of ``cmds``; returns their
    outputs, in order."""
    return run_jobs([Job(cmd, label) for cmd, label in cmds], timeout)


def run_command(cmd: list[str], label: str, timeout: float = 900) -> str:
    """``run_commands`` of one command; returns its output."""
    return run_commands([(cmd, label)], timeout)[0]


def run_phases(*phases: Generator, timeout: float = 900) -> list:
    """Phases side by side, each a generator that yields one list of Jobs
    and takes back their results: every phase's part before its yield,
    then all their jobs at once (``run_jobs``: most of a job's time is its
    processes' start-up, which the host's cores take in parallel), then
    each phase's rest, in order. Returns what each phase returns."""
    wave = [next(p) for p in phases]
    results = iter(run_jobs([job for jobs in wave for job in jobs], timeout))
    out = []
    for phase, jobs in zip(phases, wave):
        try:
            phase.send([next(results) for _ in jobs])
        except StopIteration as stop:
            out.append(stop.value)
        else:
            raise RuntimeError("a phase yielded more than one list of jobs")
    return out


def dp_run_job(torch, label: str, nproc: int, tmp: str, csv: str,
               config: str, overrides: list[str], steps: int, card: str,
               device: str, backend: str = "gloo") -> Job:
    """tools/dp_step.py on ``nproc`` ranks (gloo ranks sharing cuda:0 on
    one card), over the manifest's batches. Its finish prints each rank's
    step and all-reduce seconds, its peak memory and the memory its
    parameters and optimizer state hold between steps, and returns every
    rank's result (the whole state rank 0's alone, every rank's digest of
    it)."""
    out = os.path.join(tmp, label)
    cmd = LAUNCHER + [f"--nproc_per_node={nproc}", "-m",
                      "dynamicpdb_tpu_torch.tools.dp_step", "--config", config,
                      "--device", device, "--backend", backend, "--steps",
                      str(steps), "--csv", csv, "--out", out, "--rank0-state",
                      *overrides]

    def finish(_, wall: float) -> list[dict]:
        results = load_ranks(torch, out, nproc)
        for res in results:
            print(f"dp {label}: rank {res['rank']} of {nproc} ({res['mesh']})"
                  f": step seconds {[round(s, 4) for s in res['seconds']]}, "
                  f"all-reduce seconds "
                  f"{[round(s, 4) for s in res['comm_seconds']]}, peak "
                  f"{res['peak_bytes'] / 2**30:.3f} GiB, parameters and "
                  f"optimizer state between steps "
                  f"{res['state_bytes'] / 2**30:.3f} GiB, IPA launches "
                  f"{res['launches']} [{card}]")
        print(f"dp {label}: {nproc} ranks, {steps} steps in {wall:.2f} s of "
              f"launcher wall [{card}]")
        return results

    return Job(cmd, f"dp {label}", finish)


def dp_run(*args, **kwargs) -> list[dict]:
    """``dp_run_job``'s run, alone; every rank's result."""
    return run_jobs([dp_run_job(*args, **kwargs)])[0]


def dp_train_cli_job(torch, label: str, nproc: int, tmp: str, csv: str,
                     config: str, overrides: list[str], steps: int, card: str,
                     device: str, backend: str, data_ranks: int | None = None
                     ) -> Job:
    """train_cli on ``nproc`` ranks under the launcher, with ``--backend``
    and ``--device`` given (gloo ranks sharing cuda:0 on one card), a
    metrics line a step. Its finish returns rank 0's checkpoint (params,
    optimizer with the moments gathered whole, rng) and its metrics lines
    (aux). ``data_ranks``: how many ways the global batch splits (default
    every rank; 1 for a ('data', 'seq') = (1, n) mesh)."""
    data_ranks = nproc if data_ranks is None else data_ranks
    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib

    run_dir = os.path.join(tmp, f"{label}-cli")
    local = load_yaml(config, overrides).experiment.batch_size
    cmd = LAUNCHER + [
        f"--nproc_per_node={nproc}", "-m", "dynamicpdb_tpu_torch.train_cli",
        "--config", config, "--max-steps", str(steps), "--device", device,
        "--backend", backend, *overrides, f"data.csv_path={csv}",
        f"experiment.ckpt_dir={run_dir}/ckpt",
        f"experiment.eval_dir={run_dir}/eval", "experiment.log_freq=1"]

    def finish(out: str, wall: float) -> dict:
        check(f"global_batch={local * data_ranks} ({local} a rank)" in out,
              f"dp {label}: train_cli did not train on {data_ranks} data "
              "ranks")
        saved = ckpt_lib.load(os.path.join(run_dir, "ckpt",
                                           f"step_{steps}.ckpt"))
        with open(os.path.join(run_dir, "eval", "logs", "metrics.jsonl")) as f:
            aux = [json.loads(line) for line in f]
        check(saved["step"] == steps
              and [a["step"] for a in aux] == list(range(1, steps + 1)),
              f"dp {label} train_cli: step {saved['step']}, metric lines of "
              f"steps {[a['step'] for a in aux]}")
        print(f"dp {label}: train_cli on {nproc} ranks ({backend}, {device}),"
              f" {steps} steps in {wall:.2f} s of launcher wall: rank 0 wrote"
              f" step_{steps}.ckpt and {len(aux)} metric lines [{card}]")
        return dict(params=saved["model"], optimizer=saved["optimizer"],
                    rng=saved["rng"], aux=aux)

    return Job(cmd, f"dp {label} train_cli", finish)


def dp_train_cli(*args, **kwargs) -> dict:
    """``dp_train_cli_job``'s run, alone; rank 0's checkpoint and metrics."""
    return run_jobs([dp_train_cli_job(*args, **kwargs)])[0]


def dp_launches_ok(results: list[dict], cfg, steps: int, label: str,
                   on_card: bool):
    """Each rank ran every block's forward twice (remat) and each backward
    kernel once per window of its batch, all on the tensor-core route (none
    off the card)."""
    B, blocks = cfg.experiment.batch_size, cfg.model.ipa.num_blocks
    per_step = B * blocks if on_card else 0
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    want = dict.fromkeys(ipa_mod.COUNTERS.values(), 0)
    want.update(launches=2 * per_step * steps,
                bwd_dq_launches=per_step * steps,
                bwd_dkv_launches=per_step * steps,
                bwd_pair_launches=per_step * steps)
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
    bounds of 8a. Every run starts at once (``run_jobs``), and the checks
    follow in that order. ``extra``: phase 4's config overrides (a CPU
    rehearsal runs a small width)."""
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

    # every run at once; then 8a-8d's checks in order
    control_out = os.path.join(tmp, "8a-control")
    base = ["--config", config, "--max-steps", "2", "--device", device,
            *extra, f"data.csv_path={train['csv']}"]
    # 8c's two runs: only their checkpoints are compared
    runs_8c = {"launcher": (LAUNCHER + ["--nproc_per_node=1", "-m"],
                            ["experiment.mesh_shape=(1,)"]),
               "plain": ([sys.executable, "-m"], [])}
    jobs = [
        # 8a: the real entry point on two ranks, against one process
        dp_train_cli_job(torch, "8a", 2, tmp, train["csv"], config, half,
                         steps, card, rank_device, "gloo"),
        Job([sys.executable, "-m", "dynamicpdb_tpu_torch.tools.dp_step",
             "--config", config, "--device", rank_device, "--steps",
             str(steps), "--csv", train["csv"], "--out", control_out, *half],
            "dp 8a control", lambda _, s: torch.load(
                os.path.join(control_out, "rank0.pt"), weights_only=True)),
        # the same steps through dp_step: each rank's launches and memory
        dp_run_job(torch, "8a", 2, tmp, train["csv"], config, half, steps,
                   card, rank_device),
        dp_run_job(torch, "8b", 2, tmp, train["csv"], config,
                   half + ["experiment.zero_opt_state=false"], steps, card,
                   rank_device),
        *[Job(cmd + ["dynamicpdb_tpu_torch.train_cli", *base,
                     f"experiment.ckpt_dir={tmp}/8c-{name}/ckpt",
                     f"experiment.eval_dir={tmp}/8c-{name}/eval", *mesh_args],
              f"dp 8c {name}", lambda out, s: (out, s))
          for name, (cmd, mesh_args) in runs_8c.items()],
        dp_run_job(torch, "8d", 2, tmp, train["csv"], config,
                   extra + ["experiment.mesh_shape=(1,2)",
                            "experiment.mesh_axes=(data,model)"], steps, card,
                   rank_device),
    ]
    t0 = time.perf_counter()
    cli, control, a, b, launcher_8c, plain_8c, d = run_jobs(jobs)
    print(f"dp: {len(jobs)} runs (8a-8d) side by side in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    # 8a
    check(torch.equal(cli["rng"], one["rng"]), "dp 8a: the ranks' noise "
          "generator left one process's")
    dp_against_one_process(torch, "8a", cli, want, start, control)
    dp_launches_ok(a, load_yaml(config, half), steps, "8a", on_card)
    check(a[0]["digest"] == a[1]["digest"], "dp 8a: the two ranks' "
          "parameters or moments differ")
    check(torch.equal(a[0]["rng"], a[1]["rng"]), "dp 8a: the ranks' noise "
          "generators left lock step")
    equal_to(torch, "8a dp_step against train_cli", a[0],
             dict(model=cli["params"], optimizer=cli["optimizer"]))
    check([x["total_loss"] for x in a[0]["aux"]]
          == [x["total_loss"] for x in cli["aux"]], "dp 8a: dp_step's losses "
          "differ from train_cli's")
    print("dp 8a: dp_step's ranks equal train_cli's checkpoint bit for bit")

    # 8b
    diff = max_param_diff(a[0]["params"], b[0]["params"])
    print(f"dp 8b: ZeRO off against on: parameters differ by at most "
          f"{diff:.3e} (bound 0: the AMSGrad update is elementwise)")
    equal_to(torch, "8b", b[0], dict(model=a[0]["params"],
                                     optimizer=a[0]["optimizer"]))

    # 8c
    print(f"dp 8c: train_cli under the launcher and without, 2 steps each, "
          f"in {launcher_8c[1]:.2f} and {plain_8c[1]:.2f} s [{card}]")
    check("mesh=Mesh({'data': 1}" in launcher_8c[0], "dp 8c: train_cli under "
          "the launcher did not build the (1,) mesh")
    ckpts = {name: ckpt_lib.load(os.path.join(tmp, f"8c-{name}", "ckpt",
                                              "step_2.ckpt"))
             for name in runs_8c}
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
    dp_launches_ok(d, cfg, steps, "8d", on_card)
    check(d[0]["digest"] == d[1]["digest"], "dp 8d: the 'model' ranks' "
          "parameters or moments differ")
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
                check(other["digest"] == r[0]["digest"], f"dp x{n} {label}:"
                      f" rank {other['rank']}'s state differs from rank 0's")
            dp_against_one_process(torch, f"x{n} {label}", r[0], want, start)
        equal_to(torch, f"x{n} ZeRO off against on", res["no-zero"][0],
                 dict(model=res["zero"][0]["params"],
                      optimizer=res["zero"][0]["optimizer"]))
        print(f"dp x{n}: ZeRO off equals ZeRO on, bit for bit")
        # sequence parallelism across cards (NCCL's all-gathers), in
        # float32 against one process, at 9a's bounds
        f32 = extra + F32_TRAIN
        args = ["--config", config, "--device", device, "--steps",
                str(steps), "--csv", csv, *f32]
        one32 = sp_dp_step(torch, f"x{n} one process float32", 1, tmp,
                           args + [f"experiment.batch_size={B}"])[0]
        label = "data-seq"
        res[label] = r = dp_run(
            torch, f"x{n} {label}", n, tmp, csv, config, f32 + [
                f"experiment.batch_size={2 * B // n}",
                f"experiment.mesh_shape=({n // 2},2)",
                "experiment.mesh_axes=(data,seq)"], steps, card, device,
            backend)
        dp_launches_ok(r, load_yaml(config, extra + [
            f"experiment.batch_size={2 * B // n}"]), steps, label, on_card)
        for other in r[1:]:
            check(other["digest"] == r[0]["digest"], f"dp x{n} {label}: rank "
                  f"{other['rank']}'s state differs from rank 0's")
        names = [k for k, _ in DFoldScoreNetwork(
            cfg.model, device="cpu").named_parameters()]
        sp_against_one_process(torch, f"x{n} {label}", r[0], one32, start,
                               names)
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
# phase 9: sequence parallelism
# ---------------------------------------------------------------------------
# Two gloo ranks share cuda:0 on a ('data', 'seq') = (1, 2) mesh: each
# window's residues split over them (rows 0-127 and 128-255 of a 256-residue
# window), the IPA kernels take each rank's rows against every key. The
# ranks share the card's compute, and gloo stages their collectives through
# host memory: this measures correctness, memory a rank and the collectives'
# cost, not speed-up.
SP_MESH = ["experiment.mesh_shape=(1,2)", "experiment.mesh_axes=(data,seq)"]
# 9b: the split rollout against one process on the same card. In float32
# the same kernels on each query row, the statistics and the matmuls of
# fewer rows summed in another order: 1e-4 of the coordinates' scale,
# JAX's own bar for its split rollout (tests/test_sampler.py:224, atol 1e-4
# on coordinates of scale ~1). In bfloat16 (the release compute) a matmul
# or convolution of half the rows rounds some outputs the other way: in
# the first forward each module's output lies as far from float32 as one
# process's does (PERF.md §6), and 4 blocks of random weights over 2
# frames then carry that rounding far, a different distance for each
# window. So the split's frames are held to one process's bfloat16
# frames' distance from float32 averaged over SP_BF16_WINDOWS windows:
# within SP_BF16_FACTOR of it.
SP_RTOL_F32 = 1e-4
SP_BF16_WINDOWS = 3
SP_BF16_WINDOW_SEED = 10
SP_BF16_FACTOR = 2.0
# 9a holds the split step against one process in float32 compute and
# moments: the same windows, noise and steps, the sums in another order.
F32_TRAIN = ["model.compute_dtype=float32",
             "experiment.opt_state_dtype=float32"]
# AMSGrad's first steps move every element by about +-lr whatever its
# gradient's size, so an element whose gradient is zero up to rounding
# moves by a coin's throw, and the split's sums, taken in another order,
# throw it anew. On the card such elements are many in the second
# convolution of each ConvNet pair (score_model.trunk.conv_0.conv{1-4}.2
# .weight, 20.5M elements each): a fifth or more of them change sign while
# each tensor's gradient agrees with one process's to ~1e-4 of its norm,
# and they carry nearly all of the whole update's distance (9a prints the
# tensors that carry it; PERF.md §6). The update is therefore held over the
# elements one process's gradient resolves: those whose gradient RMS over
# the steps (the square root of AMSGrad's nu) exceeds SP_RESOLVED times its
# tensor's RMS (about half of the elements).
SP_RESOLVED = 1e-2
# The resolved update's distance from one process's, over its norm, is held
# to phase 8's bound for the update, which lies between the split's reading
# and that of the planted fault of SP_FAULTS, which must read past it.
SP_UPDATE_BOUND = DP_GAP_BOUNDS["update"]
# A fault planted in a split run of tools/dp_step.py (the launcher runs
# PLANTED_FAULT, which patches the package and then runs the module named
# after the fault): 'halo', ConvNet's halo rows hand their gradient back to
# no one (the backward of sp.halo_exchange keeps its own rows only);
# 'keys', each rank keeps only its own queries' part of its keys' gradient
# (the reduce-scatter of sp.gather_rows's backward sums nothing); 'column',
# OmegaFold's column view taken from the rank's own rows (sp.column_view's
# all-to-all hands each rank its own block in every rank's place: phase
# 10a). 'keys'
# is not run: at the release init IPA's projections take gradients at the
# rounding level (a zero-initialised output projection), which two honest
# runs already differ on, so its reading stays with the split's (PERF.md
# §6); phase 2's rectangular dk/dv and the CPU tests hold that path.
SP_FAULTS = ("halo",)
PLANTED_FAULT = r'''
import runpy, sys
import torch.distributed as dist
from dynamicpdb_tpu_torch.parallel import mesh, sp
fault = sys.argv.pop(1)
if fault == "halo":
    def backward(ctx, g):
        w, d = ctx.width, ctx.dim
        return g.narrow(d, w, g.shape[d] - 2 * w).contiguous(), None, None
    sp._HaloExchange.backward = staticmethod(backward)
elif fault == "keys":
    def reduce_scatter(t, group, dim):
        rows = t.shape[dim] // dist.get_world_size(group)
        return t.narrow(dim, dist.get_rank(group) * rows, rows).contiguous()
    mesh.reduce_scatter = reduce_scatter
elif fault == "column":
    import torch
    def all_to_all(t, group):
        part = t.chunk(dist.get_world_size(group))[dist.get_rank(group)]
        return torch.cat([part] * dist.get_world_size(group))
    mesh.all_to_all = all_to_all
else:
    raise SystemExit("no planted fault " + fault)
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
'''
# 9c runs the release compute (bfloat16) for its memory and time; its loss
# is held to bfloat16's precision (2^-8 relative) against one process's.
SP_BF16_LOSS_RTOL = 2.0 ** -8
SP_LONG_N = 1024  # 9c's window


def resolved_update_gap(torch, got: dict, want: dict, start: dict,
                        names: list[str]) -> tuple[float, float, list]:
    """The distance of ``got``'s update from ``want``'s over the elements
    ``want``'s gradient resolves (sqrt(nu) > SP_RESOLVED x its tensor's
    RMS), over the norm of ``want``'s there; the share of the elements
    kept; and the 4 tensors that carry most of the whole update's distance,
    each (name, its share of the distance squared, the share of its
    elements whose update changed sign). ``names``: the parameters in the
    optimizer's order."""
    diff2 = norm2 = whole2 = 0.0
    kept = total = 0
    leaves = []
    state = want["optimizer"]["state"]
    for i, name in enumerate(names):
        if i not in state:  # never a gradient
            continue
        g = state[i]["nu"].double().sqrt()
        keep = g > SP_RESOLVED * g.pow(2).mean().sqrt()
        w = want["params"][name].double() - start[name].double()
        u = got["params"][name].double() - start[name].double()
        d2 = (u - w).pow(2)
        diff2 += float(d2[keep].sum())
        norm2 += float(w[keep].pow(2).sum())
        kept += int(keep.sum())
        total += keep.numel()
        leaves.append((name, float(d2.sum()),
                       float((u.sign() * w.sign() < 0).double().mean())))
        whole2 += leaves[-1][1]
    top = [(n, round(d / max(whole2, 1e-300), 4), round(f, 4)) for n, d, f
           in sorted(leaves, key=lambda x: -x[1])[:4]]
    return math.sqrt(diff2) / max(math.sqrt(norm2), 1e-30), kept / total, top


def sp_gaps(torch, label: str, got: dict, want: dict, start: dict,
            names: list[str]) -> dict:
    """``got`` against ``want`` (each params, optimizer with whole moments,
    per-step aux): each step's loss and grad norm (relative), the moments
    and the whole update (``state_gaps``), and the resolved update."""
    out = {f"{k} {i + 1}": abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
           for k in ("total_loss", "grad_norm")
           for i, (g, w) in enumerate(zip(got["aux"], want["aux"]))}
    out.update(state_gaps(torch, label, got, dict(
        model=want["params"], optimizer=want["optimizer"]), start))
    out["resolved"], out["kept"], out["leaves"] = resolved_update_gap(
        torch, got, want, start, names)
    return out


def sp_against_one_process(torch, label: str, split: dict, one: dict,
                           start: dict, names: list[str],
                           controls: dict | None = None):
    """A float32 split run against one process's: every step's loss and
    the first step's grad norm within DP_LOSS_RTOL (later grad norms follow
    parameters the unresolved elements moved apart, and are printed), each
    moment within phase 8's bounds, the resolved update within
    SP_UPDATE_BOUND; each planted fault in ``controls`` must read past
    that bound."""
    got = sp_gaps(torch, label, split, one, start, names)
    held = [k for k in got if k.startswith("total_loss")] + ["grad_norm 1"]
    for k in held:
        check(got[k] <= DP_LOSS_RTOL, f"sp {label}: {k} {got[k]:.3e} from "
              f"one process's (relative; bound {DP_LOSS_RTOL})")
    for k in ("mu", "nu", "nu_max"):
        check(got[k] <= DP_GAP_BOUNDS[k], f"sp {label}: {k} is {got[k]:.3e} "
              f"of its norm from one process's (bound {DP_GAP_BOUNDS[k]})")
    check(got["resolved"] <= SP_UPDATE_BOUND, f"sp {label}: the resolved "
          f"update is {got['resolved']:.3e} of its norm from one process's "
          f"(bound {SP_UPDATE_BOUND})")
    leaves = got.pop("leaves")
    print(f"sp {label}: against one process, float32: "
          f"{ {k: float(f'{v:.4g}') for k, v in got.items()} } (bounds: "
          f"losses and the first grad norm {DP_LOSS_RTOL}, moments "
          f"{ {k: DP_GAP_BOUNDS[k] for k in ('mu', 'nu', 'nu_max')} }, "
          f"resolved update {SP_UPDATE_BOUND}; 'kept': the share of elements "
          f"whose gradient one process resolves); losses "
          f"{[a['total_loss'] for a in split['aux']]} against "
          f"{[a['total_loss'] for a in one['aux']]}; the whole update's "
          f"distance by tensor (share of its square, share of the tensor's "
          f"elements that changed sign): {leaves}")
    for fault, run in (controls or {}).items():
        far = sp_gaps(torch, f"{label} {fault}", run, one, start, names)
        check(far["resolved"] > SP_UPDATE_BOUND, f"sp {label}: with the "
              f"planted fault '{fault}' the resolved update reads "
              f"{far['resolved']:.3e}, within the bound {SP_UPDATE_BOUND}: "
              "the bound would not catch it")
        print(f"sp {label}: planted fault '{fault}': resolved update "
              f"{far['resolved']:.4g}, whole update {far['update']:.4g}, mu "
              f"{far['mu']:.4g} of their norms from one process's (must "
              f"exceed {SP_UPDATE_BOUND})")


def module_command(module: str, nproc: int, fault: str | None = None
                   ) -> list[str]:
    """``module`` in one process without a launcher (``nproc`` 1), or on
    ``nproc`` ranks of the launcher, with ``fault`` planted
    (PLANTED_FAULT)."""
    if nproc == 1:
        return [sys.executable, "-m", module]
    if fault is None:
        return LAUNCHER + [f"--nproc_per_node={nproc}", "-m", module]
    return LAUNCHER + [f"--nproc_per_node={nproc}", "--no-python",
                       sys.executable, "-c", PLANTED_FAULT, fault, module]


def dp_step_command(tmp: str, label: str, nproc: int, args: list[str],
                    fault: str | None = None) -> tuple[list[str], str]:
    """The command of tools/dp_step.py on ``nproc`` ranks (1: without a
    launcher; more: gloo ranks, rank 0 alone writing the whole state), with
    ``fault`` planted (PLANTED_FAULT), and its output directory."""
    out = os.path.join(tmp, label.replace(" ", "_"))
    cmd = module_command("dynamicpdb_tpu_torch.tools.dp_step", nproc, fault)
    more = [] if nproc == 1 else ["--backend", "gloo", "--rank0-state"]
    return cmd + args + ["--out", out] + more, out


def load_ranks(torch, out: str, nproc: int) -> list[dict]:
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
            for r in range(nproc)]


def sp_dp_step_job(torch, label: str, nproc: int, tmp: str,
                   args: list[str], fault: str | None = None) -> Job:
    """``dp_step_command``'s run; its finish returns every rank's
    result."""
    cmd, out = dp_step_command(tmp, label, nproc, args, fault)

    def finish(_, wall: float) -> list[dict]:
        print(f"sp {label}: {nproc} rank(s) in {wall:.2f} s of wall")
        return load_ranks(torch, out, nproc)

    return Job(cmd, f"sp {label}", finish)


def sp_dp_step(*args, **kwargs) -> list[dict]:
    """``sp_dp_step_job``'s run, alone; every rank's result."""
    return run_jobs([sp_dp_step_job(*args, **kwargs)])[0]


def sp_train_phase(torch, config: str, train: dict, tmp: str, card: str,
                   device: str = "cuda", extra: tuple = ()) -> Generator:
    """9a, in float32 compute and moments: train_cli on two gloo ranks
    sharing cuda:0 on a ('data', 'seq') = (1, 2) mesh, on phase 4's
    manifest, batch (each rank its rows of every window), seed and steps,
    against one process through tools/dp_step.py (whose steps equal
    train_cli's bit for bit, phase 8a); and the same split steps through
    dp_step with each planted fault of SP_FAULTS. The ranks' generator
    must be phase 4's. A phase of ``run_phases``: the runs side by side;
    returns train_cli's result."""
    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib
    from dynamicpdb_tpu_torch.weights import init_like_jax_

    extra = list(extra) + F32_TRAIN
    cfg = load_yaml(config, extra)
    rank_device = "cuda:0" if device == "cuda" else device
    steps = len(train["steps"])
    model = DFoldScoreNetwork(cfg.model, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    start = init_like_jax_(model, cfg.experiment.seed).state_dict()
    del model
    args = ["--config", config, "--device", rank_device, "--steps",
            str(steps), "--csv", train["csv"], *extra]
    # train_cli, the reference and the planted faults side by side: only
    # the last two's states are read
    cli, (one,), *faults = yield [
        dp_train_cli_job(torch, "9a", 2, tmp, train["csv"], config,
                         extra + SP_MESH, steps, card, rank_device, "gloo",
                         data_ranks=1),
        sp_dp_step_job(torch, "9a one process", 1, tmp, args),
        *[sp_dp_step_job(torch, f"9a fault {f}", 2, tmp, args + SP_MESH,
                         fault=f) for f in SP_FAULTS]]
    controls = {f: ranks[0] for f, ranks in zip(SP_FAULTS, faults)}
    check(torch.equal(cli["rng"], ckpt_lib.load(train["ckpt"])["rng"]),
          "sp 9a: the ranks' noise generator left one process's")
    rates = [round(a["steps_per_sec"], 4) for a in cli["aux"]]
    print(f"sp 9a: rank 0's steps at {rates} steps/s (train_cli's log; "
          f"phase 4: {[round(a['seconds'], 4) for a in train['steps']]} s a "
          f"step) [float32, {card}]")
    sp_against_one_process(torch, "9a (1, 2) data x seq", cli, one, start,
                           names, controls)
    return cli


def sp_rollout_phase(torch, batched: dict, tmp: str, card: str,
                     overrides: list[str], device: str = "cuda") -> Generator:
    """9b: tools/sp_run.py's rollout on two gloo ranks sharing cuda:0,
    ('seq',) = 2, of phase 3c's first window (256 residues) with its
    weights, full sampler and fast_x0. In float32, from phase 3c's
    generator seed, against one process's float32 rollout (SP_RTOL_F32).
    At ``overrides`` (the release compute, bfloat16), on SP_BF16_WINDOWS
    windows (phase 3c's first, then synthetic windows of its length from
    SP_BF16_WINDOW_SEED on): the split's distance from one process's
    float32 frames, averaged over the windows, within SP_BF16_FACTOR times
    that of one process's bfloat16 frames (phase 3c's for the first).
    Each rank's IPA launches (blocks x forwards a frame x frames, at Nq =
    128 of Nk = 256). A phase of ``run_phases``: one run, and one process's
    rollouts once it has ended; returns a rank's launches."""
    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.sampling.reverse import rollout

    first, spec = batched["first"], batched["first"]["rollout"]
    bf16 = "model.compute_dtype=bfloat16" in overrides
    n_res = spec["init_feats"]["res_mask"].shape[-1]
    # the rollout's frames do not depend on the sampler's noise (they are
    # the x0 predictions), so each further draw is a window of its own
    more = (sampling_setup(device, overrides, (n_res,) * (SP_BF16_WINDOWS - 1),
                           n_res, seed=SP_BF16_WINDOW_SEED)[3] if bf16 else [])
    specs = [spec] + [dict(spec, init_feats={k: v.cpu() for k, v in f.items()})
                      for f in more]

    def one_process(dtype: str, spec_i: dict):
        cfg = config_lib.apply_overrides(config_lib.Config(), [
            o for o in overrides if not o.startswith("model.compute_dtype")]
            + [f"model.compute_dtype={dtype}"])
        model = DFoldScoreNetwork(cfg.model, device=device).eval()
        model.load_state_dict(batched["state_dict"])
        with torch.no_grad():
            return rollout(model, SE3Diffuser(cfg.diffuser, device=device),
                           {k: v.to(device) for k, v in
                            spec_i["init_feats"].items()},
                           n_steps=spec_i["n_steps"],
                           num_t=spec_i["num_t"],
                           noise_scale=spec_i["noise_scale"],
                           generator=torch.Generator(device=device)
                           .manual_seed(spec_i["seed"]))

    per_rank = (spec["n_steps"] * (spec["num_t"] + 1) * batched["blocks"]
                if device == "cuda" else 0)
    rank_device = "cuda:0" if device == "cuda" else device
    payload = os.path.join(tmp, "sp_rollout.pt")
    # one launch: the float32 rollout, and the release compute's beside it
    parts = {"rollout_float32": "float32"}
    if bf16:
        parts["rollout"] = "bfloat16"
    torch.save(dict(state_dict=batched["state_dict"], rollout_float32=spec,
                    rollout=specs), payload)
    out = os.path.join(tmp, "sp_rollout")
    wall, = yield [Job(LAUNCHER + [
        "--nproc_per_node=2", "-m", "dynamicpdb_tpu_torch.tools.sp_run",
        "--device", rank_device, "--backend", "gloo", "--payload", payload,
        "--out", out, *overrides], "sp 9b rollout", lambda _, s: s)]
    names = ("atom37", "rigids")
    one32 = [one_process("float32", x) for x in specs]
    one16 = [(first["atoms"], first["rigids"])] + [
        one_process("bfloat16", x) for x in specs[1:]]

    def dist_(a, b):
        return float((a.float().cpu() - b.float().cpu()).abs().max())

    floor = [{n: dist_(a, b) for n, a, b in zip(names, o16, o32)}
             for o16, o32 in zip(one16, one32)]
    for r in range(2):
        res = torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
        check(res["mesh"] == {"seq": 2}, f"sp 9b: mesh {res['mesh']}")
        for mode in ("full", "fast_x0"):
            for name, got, want in zip(names, res["rollout_float32"][mode],
                                       one32[0]):
                err = dist_(got, want)
                tol = SP_RTOL_F32 * max(1.0, float(want.abs().max()))
                print(f"sp 9b float32: rank {r} {mode} {name} against one "
                      f"process's float32 frames: max_abs_err {err:.3e} tol "
                      f"{tol:.3e}")
                check(err <= tol, f"sp 9b float32 rank {r} {mode} {name}: "
                      f"{err} > {tol}")
            if not bf16:
                continue
            for k, name in enumerate(names):
                errs = [dist_(res["rollout"][i][mode][k], one32[i][k])
                        for i in range(len(specs))]
                floors = [f[name] for f in floor]
                pairs = [(round(e, 4), round(f, 4))
                         for e, f in zip(errs, floors)]
                mean_err, mean_floor = np.mean(errs), np.mean(floors)
                print(f"sp 9b bfloat16: rank {r} {mode} {name}, window by "
                      f"window, the split's / one process's max_abs_diff from "
                      f"one process's float32 frames: "
                      f"{pairs}; means {mean_err:.4f} / {mean_floor:.4f}, ratio "
                      f"{mean_err / mean_floor:.3f} (bound {SP_BF16_FACTOR})")
                check(mean_err <= SP_BF16_FACTOR * mean_floor, f"sp 9b "
                      f"bfloat16 rank {r} {mode} {name}: mean {mean_err} > "
                      f"{SP_BF16_FACTOR} x {mean_floor}")
        for part, dtype in parts.items():
            got = res["launches"][part]
            n = len(specs) if part == "rollout" else 1
            check(got["launches"] == n * per_rank
                  and got["wide_launches"] == got["wide_tc_launches"] == 0,
                  f"sp 9b: rank {r} IPA "
                  f"forward launches {got}, expected {n * per_rank} on the "
                  "tensor-core route")
            print(f"sp 9b {dtype}: rank {r}: {n} x ({spec['n_steps']} frames "
                  f"full and {spec['n_steps']} fast_x0) in "
                  f"{res['seconds'][part]:.3f} s, {got['launches']} IPA "
                  f"forward launches, {res['sp_calls'][part]} SP "
                  f"collectives [{card}]")
        print(f"sp 9b: rank {r} peak {res['peak_bytes'] / 2**30:.3f} GiB "
              f"[{card}]")
    print(f"sp 9b: 2 ranks in {wall:.2f} s of launcher wall [{card}]")
    return dict(launches=per_rank)


def sp_long_phase(torch, config: str, tmp: str, card: str,
                  device: str = "cuda", extra: tuple = (),
                  n_res: int = SP_LONG_N) -> Generator:
    """9c: one train step of an ``n_res``-residue window at release widths
    (B = 1, remat, bfloat16) through tools/dp_step.py: one process, and two
    'seq' ranks sharing cuda:0 with the collectives timed; each rank's
    peak memory beside the one process's, the ranks' states equal, the
    step's loss against one process's within bfloat16's precision
    (SP_BF16_LOSS_RTOL), each rank's IPA launches. A phase of
    ``run_phases``: the two runs side by side (peak memory is each
    process's own; the seconds are taken under the wave's load)."""
    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.data.dataset import pad_window
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.serve_cli import RAW_KEYS

    extra = list(extra) + ["experiment.batch_size=1",
                           f"data.filtering.max_len={n_res}"]
    cfg = load_yaml(config, extra)
    w = make_window(n_res=n_res, frame_time=cfg.data.frame_time,
                    node_dim=cfg.model.node_repr_dim,
                    edge_dim=cfg.model.edge_repr_dim, seed=7, rot_wiggle=0.1)
    raw = pad_window({k: w[k] for k in RAW_KEYS}, n_res)
    payload = os.path.join(tmp, "sp_long.pt")
    torch.save(dict(batches={k: torch.as_tensor(np.asarray(v))[None, None]
                             for k, v in raw.items()}), payload)
    rank_device = "cuda:0" if device == "cuda" else device
    args = ["--config", config, "--device", rank_device, "--steps", "1",
            "--payload", payload, *extra]
    runs = dict(zip(("one", "seq"), (yield [
        sp_dp_step_job(torch, "9c one", 1, tmp, args),
        sp_dp_step_job(torch, "9c seq", 2, tmp,
                       args + ["--time-sp"] + SP_MESH)])))
    for label, results in runs.items():
        for res in results:
            sp_s = res["sp_seconds"][0]
            print(f"sp 9c: {label} rank {res['rank']} ({res['mesh']}), "
                  f"N={n_res}, B=1: step {res['seconds'][0]:.4f} s, "
                  f"all-reduce {res['comm_seconds'][0]:.4f} s, SP "
                  f"collectives {res['sp_calls'][0]} taking "
                  f"{'not timed' if sp_s is None else f'{sp_s:.4f} s'}, "
                  f"peak {res['peak_bytes'] / 2**30:.3f} GiB, IPA launches "
                  f"{res['launches']} [{card}]")
    one, seq = runs["one"][0], runs["seq"]
    blocks = cfg.model.ipa.num_blocks if device == "cuda" else 0
    for res in runs["one"] + seq:
        check(res["launches"]["launches"] == 2 * blocks
              and res["launches"]["bwd_dkv_launches"] == blocks,
              f"sp 9c: rank {res['rank']} launches {res['launches']}")
    check(seq[0]["digest"] == seq[1]["digest"], "sp 9c: the two 'seq' "
          "ranks' parameters or moments differ")
    got, want = seq[0]["aux"][0]["total_loss"], one["aux"][0]["total_loss"]
    err = abs(got - want) / abs(want)
    check(math.isfinite(got) and err <= SP_BF16_LOSS_RTOL, f"sp 9c: loss "
          f"{got} against one process's {want} (relative {err:.3e}, bound "
          f"{SP_BF16_LOSS_RTOL})")
    peaks = [r["peak_bytes"] / 2**30 for r in seq]
    print(f"sp 9c: loss {got} against one process's {want} (relative "
          f"{err:.3e}, bound {SP_BF16_LOSS_RTOL:.3e}); N={n_res} peak "
          f"torch.cuda.max_memory_allocated per rank "
          f"{[round(p, 3) for p in peaks]} GiB against one process's "
          f"{one['peak_bytes'] / 2**30:.3f} GiB [{card}]")
    check(device != "cuda" or max(peaks) < one["peak_bytes"] / 2**30,
          "sp 9c: a 'seq' rank's peak memory is not below one process's")
    return dict(one=one, seq=seq)


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
    check(counts["ipa_attention_fwd"] == (expect, 0, 0), f"eval: IPA forward "
          f"launches {counts['ipa_attention_fwd']}, expected ({expect}, 0, 0)")
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
    check(launched == (n_prot * 4 * num_t * blocks, 0, 0), f"eval extension: "
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
            check(launched == (n_fwd, 0, 0), f"evaluate {label}: IPA forward "
                  f"launches {launched}, expected ({n_fwd}, 0, 0)")
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


def random_sequences(lengths, seed: int) -> list[str]:
    """Phase 5's random sequences of ``lengths`` from ``seed``."""
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(RESTYPES), n)) for n in lengths]


def extract_phase(device: str, cfg, *, lengths, num_cycles: int,
                  num_pseudo_msa: int, pad_multiple: int, tmp: str,
                  seed: int = 0, dtype: str = "float32", tag: str = "") -> dict:
    """Seeded random weights at ``cfg`` -> torch.save -> the extraction
    CLI's main on random sequences of ``lengths``. Checks every npz against
    the DFOLD contract (validate) and the kernel launch counts (every
    cycle runs each GeoFormer block's attention with edge bias once and its
    geom_count geometric attentions, each of those also running the
    triangle route's three kernels; none on the CPU). Returns the records,
    counts, parameter count, peak device memory and the npz arrays."""
    import torch

    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
    from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod
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
    fasta = os.path.join(tmp, "seqs.fasta")
    with open(fasta, "w") as f:
        for i, seq in enumerate(random_sequences(lengths, seed)):
            f.write(f">seq{i}_{len(seq)}\n{seq}\n")
    out_dir = os.path.join(tmp, f"npz_{device}_{dtype}")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    geom_mod.geom_launches = geom_mod.node_launches = 0  # the path starts
    reset_triangle_counts(tri_mod)
    t0 = time.perf_counter()
    records = cli.main(["--fasta", fasta, "--out-dir", out_dir, "--weights",
                        ckpt, "--num-cycles", str(num_cycles),
                        "--num-pseudo-msa", str(num_pseudo_msa),
                        "--pad-multiple", str(pad_multiple), "--device",
                        device, "--dtype", dtype])
    wall = time.perf_counter() - t0
    launched = {"geom_attention": geom_mod.geom_launches,
                "node_attention": geom_mod.node_launches,
                **triangle_counts(tri_mod)}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    per_cycle = cfg.geo_num_blocks if on_card else 0
    geom = len(lengths) * num_cycles * per_cycle * cfg.geom_count
    expect = {"geom_attention": geom,
              "node_attention": len(lengths) * num_cycles * per_cycle,
              **{k: geom for k in ("geom_triangle",) + TRI_KERNELS}}
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
    from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod

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
    reset_triangle_counts(tri_mod)
    t0 = time.perf_counter()
    records = fold_cli.main(["--fasta", fasta, "--out-dir", out_dir,
                             "--weights", ckpt, "--num-cycles",
                             str(num_cycles), "--num-pseudo-msa",
                             str(num_pseudo_msa), "--pad-multiple",
                             str(pad_multiple), "--device", device])
    wall = time.perf_counter() - t0
    launched = {"geom_attention": geom_mod.geom_launches,
                "node_attention": geom_mod.node_launches,
                **triangle_counts(tri_mod)}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    per_cycle = cfg.geo_num_blocks if on_card else 0
    geom = len(lengths) * num_cycles * per_cycle * cfg.geom_count
    expect = {"geom_attention": geom,
              "node_attention": len(lengths) * num_cycles * per_cycle,
              **{k: geom for k in ("geom_triangle",) + TRI_KERNELS}}
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


# ---------------------------------------------------------------------------
# phase 10: OmegaFold under sequence parallelism
# ---------------------------------------------------------------------------
# Two gloo ranks share cuda:0 on a ('data', 'seq') = (1, 2) mesh; each
# holds its rows of every [L, L, .] tensor of the PLM, the embedders and
# the GeoFormer (tools/sp_run.py's "omegafold" part). 10a: the release
# OmegaFold on phase 5's sequences (256 and 203 residues, the second
# padded to 224), 2 cycles each with the structure (one recycle: the
# depth the smoke's time limit leaves room for), against one process on
# the same weights and inputs, beside a planted fault ('column'); 10b: one
# cycle of a 512-residue sequence, one process and a 'seq' rank, each
# one's peak memory, seconds and collectives.
SP_OF_LENGTHS = (256, 203)
SP_OF_CYCLES = 2
SP_OF_LONG_N = 512
# The split against one process, in float32: every residue's arithmetic is
# one process's, in matmuls over a rank's rows instead of all L, so sums
# run in another order; the recycle and the structure module then carry
# the differences. Every output (each cycle's node and edge, the
# confidences, the selected pos14 and pLDDT) is held to SP_OF_RTOL of its
# scale (its largest magnitude, at least 1). On the CPU (the tiny
# configuration, tests/test_torch_sp_omegafold.py) the readings were at
# most 1.5e-6 of the scale; the card's kernels sum on the tensor cores in
# another order again, and the card against the CPU is held to 1e-3
# (EXTRACT_RTOL) over these depths, so the bound sits between: 1e-4.
SP_OF_RTOL = 1e-4
# The planted fault must read past the bound by this factor on cycle 0's
# edge.
SP_OF_FAULT_FACTOR = 10.0


def sp_run_command(tmp: str, label: str, nproc: int, payload: str,
                   device: str, fault: str | None = None
                   ) -> tuple[list[str], str]:
    """tools/sp_run.py on ``payload``: one process without a launcher
    (``nproc`` 1), else ``nproc`` gloo ranks on a ('data', 'seq') = (1,
    nproc) mesh sharing ``device`` (cuda: cuda:0), with ``fault`` planted
    (PLANTED_FAULT). Returns the command and its output directory."""
    out = os.path.join(tmp, label.replace(" ", "_"))
    cmd = module_command("dynamicpdb_tpu_torch.tools.sp_run", nproc, fault)
    rank_device = "cuda:0" if device == "cuda" else device
    more = [] if nproc == 1 else [
        "--backend", "gloo", "experiment.mesh_shape=(1,%d)" % nproc,
        "experiment.mesh_axes=(data,seq)"]
    return cmd + ["--device", rank_device, "--payload", payload, "--out",
                  out] + more, out


def sp_of_gap(got, want) -> tuple[float, float]:
    """(max_abs_err, scale): the scale is want's largest magnitude, at
    least 1."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"shapes {tuple(got.shape)} and "
          f"{tuple(want.shape)}")
    return (float((got - want).abs().max()),
            max(1.0, float(want.abs().max())))


def sp_of_compare(torch, label: str, ranks: list[dict], one: dict,
                  rtol: float) -> float:
    """Every output of the split run ``ranks`` (each rank's sp_run result
    for one sequence) against one process's ``one``: each cycle's node
    (rank 0's) and edge (every rank's rows), confidence, the selected cycle
    (equal), the Embedding's node, edge, pos14, pLDDT, each within ``rtol``
    of its scale; every rank's Embedding equal to rank 0's bit for bit.
    Returns the largest relative reading."""
    r0, L = ranks[0], one["edge"].shape[0]
    worst = 0.0

    def held(name, got, want):
        nonlocal worst
        err, scale = sp_of_gap(torch.as_tensor(got), torch.as_tensor(want))
        worst = max(worst, err / scale)
        print(f"sp 10 {label}: {name} max_abs_err {err:.3e} (scale "
              f"{scale:.3f}, tol {rtol * scale:.3e})")
        check(err <= rtol * scale, f"sp 10 {label}: {name} {err} > "
              f"{rtol} x {scale}")

    check(len(r0["cycles"]) == len(one["cycles"]), f"sp 10 {label}: "
          f"{len(r0['cycles'])} cycles, one process ran "
          f"{len(one['cycles'])}")
    for c, want in enumerate(one["cycles"]):
        edge = torch.cat([r["cycles"][c]["edge_rows"] for r in ranks])[:L]
        held(f"cycle {c} node", r0["cycles"][c]["node"], want["node"])
        held(f"cycle {c} edge", edge, want["edge_rows"])
        held(f"cycle {c} confidence", r0["cycles"][c]["confidence"],
             want["confidence"])
    check(r0["cycle"] == one["cycle"], f"sp 10 {label}: cycle "
          f"{r0['cycle']} selected, one process selected {one['cycle']}")
    for name in ("node", "edge", "pos14", "plddt"):
        if one[name] is not None:
            held(f"selected {name}", r0[name], one[name])
    for r in ranks[1:]:
        for name in ("node", "edge", "pos14", "plddt"):
            check(r[name] is None or torch.equal(r[name], r0[name]),
                  f"sp 10 {label}: rank's {name} differs from rank 0's")
    return worst


def sp_of_inputs(lengths, seed: int, num_cycles: int, num_pseudo_msa: int,
                 pad_multiple: int) -> list:
    """The pipeline's cycle inputs of phase 5's sequences of ``lengths``."""
    from dynamicpdb_tpu_torch.models.omegafold import pipeline

    lines = []
    for i, seq in enumerate(random_sequences(lengths, seed)):
        lines += [f">seq{i}\n", seq + "\n"]
    got = dict(pipeline.fasta2inputs(lines, num_pseudo_msa=num_pseudo_msa,
                                     num_cycle=num_cycles,
                                     pad_multiple=pad_multiple))
    return [got[f"seq{i}"] for i in range(len(lengths))]


def sp_omegafold_phase(torch, tmp: str, card: str, *, weights: str | None,
                       cfg=None, lengths=SP_OF_LENGTHS,
                       num_cycles: int = SP_OF_CYCLES,
                       num_pseudo_msa: int = 15, pad_multiple: int = 32,
                       long_n: int | None = SP_OF_LONG_N,
                       device: str = "cuda", seed: int = 0) -> dict:
    """10a and 10b (above). ``weights``: a reference-layout OmegaFold
    checkpoint of ``cfg`` (phase 5's); None writes seeded random ones of
    ``cfg`` into ``tmp`` (the CPU rehearsal passes a tiny cfg). Returns the
    split and one-process results, the relative readings and the launches
    a 'seq' rank made per cycle."""
    from dynamicpdb_tpu_torch.models.omegafold.model import OmegaFoldConfig
    from dynamicpdb_tpu_torch.ops.geom_attention import tile_rows
    from dynamicpdb_tpu_torch.tools.sp_run import GEOM_COUNTERS
    from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict

    cfg = cfg or OmegaFoldConfig()
    if weights is None:
        weights = os.path.join(tmp, "sp_omegafold.pt")
        torch.save({k: torch.from_numpy(v) for k, v in
                    random_omegafold_state_dict(cfg, seed).items()}, weights)
    seqs = sp_of_inputs(lengths, seed, num_cycles, num_pseudo_msa,
                        pad_multiple)
    spec = dict(weights=weights, return_structure=True, pad_safe=True)
    main = os.path.join(tmp, "sp_of_10a.pt")
    torch.save({"omegafold": dict(spec, sequences=seqs)}, main)
    fault = os.path.join(tmp, "sp_of_fault.pt")
    torch.save({"omegafold": dict(spec, sequences=[seqs[0][:1]])}, fault)
    jobs = {"10a one": sp_run_command(tmp, "10a one", 1, main, device),
            "10a seq": sp_run_command(tmp, "10a seq", 2, main, device),
            "10a fault": sp_run_command(tmp, "10a fault", 2, fault, device,
                                        fault="column")}
    if long_n:  # 10b: one cycle at long_n, one process and a 'seq' rank
        long = os.path.join(tmp, "sp_of_10b.pt")
        torch.save({"omegafold": dict(
            spec, time_sp=True, sequences=sp_of_inputs(
                (long_n,), seed + 1, 1, num_pseudo_msa, 0))}, long)
        jobs.update({f"10b {k}": sp_run_command(tmp, f"10b {k}", nproc, long,
                                                device)
                     for k, nproc in (("one", 1), ("seq", 2))})
    # every run side by side (the seconds below are taken under the wave's
    # load; peak memory is each process's own)
    seconds = run_jobs([Job(cmd, f"sp {k}", lambda _, s: s)
                        for k, (cmd, _) in jobs.items()])
    for k, s in zip(jobs, seconds):
        print(f"sp {k}: {s:.2f} s of wall [{card}]")
    res = {k: load_ranks(torch, out, 1 if k.endswith("one") else 2)
           for k, (_, out) in jobs.items()}
    on_card = device == "cuda"
    blocks = cfg.geo_num_blocks if on_card else 0
    readings = []
    for i, one in enumerate(res["10a one"][0]["omegafold"]):
        L = one["edge"].shape[0]
        ranks = [r["omegafold"][i] for r in res["10a seq"]]
        readings.append(sp_of_compare(torch, f"10a L={L}", ranks, one,
                                      SP_OF_RTOL))
        for r, got in enumerate(ranks):
            n = len(got["cycles"])
            # a rank's node_attention takes its block of query rows (at
            # most 128 at 10a's lengths: the 128-row instance), its
            # geom_attention every row of the window (the 256-row one)
            _, rows, window = got["rows"]
            want = {"geom_launches": n * blocks * cfg.geom_count,
                    "triangle_launches": n * blocks * cfg.geom_count,
                    "node_launches": n * blocks,
                    "geom_launches_128": (n * blocks * cfg.geom_count
                                          if tile_rows(window) == 128 else 0),
                    "node_launches_128": (n * blocks if tile_rows(rows) == 128
                                          else 0)}
            launched = {k: got["launches"][k] for k in want}
            check(launched == want, f"sp 10a L={L}: rank {r} launches "
                  f"{launched}, expected {want}")
            print(f"sp 10a L={L}: rank {r} rows {got['rows'][:2]} of "
                  f"{got['rows'][2]}: {n} cycles in {got['seconds']:.3f} s "
                  f"(one process {one['seconds']:.3f} s; side by side), "
                  f"cycle {got['cycle']} selected (one process "
                  f"{one['cycle']}), launches {launched}, "
                  f"{got['sp_calls']} collectives, peak "
                  f"{got['peak_bytes'] / 2**30:.3f} GiB (one process "
                  f"{one['peak_bytes'] / 2**30:.3f} GiB) [{card}]")
    # the planted fault: cycle 0's edge of the first sequence
    one0 = res["10a one"][0]["omegafold"][0]
    L = one0["edge"].shape[0]
    edge = torch.cat([r["omegafold"][0]["cycles"][0]["edge_rows"]
                      for r in res["10a fault"]])[:L]
    err, scale = sp_of_gap(edge, one0["cycles"][0]["edge_rows"])
    print(f"sp 10a planted fault 'column' (the column view from the rank's "
          f"own rows): cycle 0 edge max_abs_err {err:.3e} = "
          f"{err / scale:.3e} of its scale; the split's worst reading "
          f"{max(readings):.3e}; it must read past {SP_OF_FAULT_FACTOR} x "
          f"the bound {SP_OF_RTOL}")
    check(err / scale > SP_OF_FAULT_FACTOR * SP_OF_RTOL, "sp 10a: the "
          f"planted fault reads {err / scale:.3e}, within "
          f"{SP_OF_FAULT_FACTOR} x the bound: the check cannot see it")
    first = res["10a seq"][0]["omegafold"][0]  # rank 0, the first sequence
    out = dict(one=res["10a one"], seq=res["10a seq"], readings=readings,
               fault=err / scale,
               launches={k: sum(s["launches"][k] for s in
                                res["10a seq"][0]["omegafold"])
                         for k in GEOM_COUNTERS},
               per_cycle={k: first["launches"][k] // len(first["cycles"])
                          for k in GEOM_COUNTERS})
    if not long_n:
        return out
    one = res["10b one"][0]["omegafold"][0]
    ranks = [r["omegafold"][0] for r in res["10b seq"]]
    out["long"] = sp_of_compare(torch, f"10b L={long_n}", ranks, one,
                                SP_OF_RTOL)
    for label, got in [("one process", one)] + [
            (f"'seq' rank {r}", g) for r, g in enumerate(ranks)]:
        print(f"sp 10b L={long_n}, 1 cycle: {label}: {got['seconds']:.3f} s,"
              f" peak torch.cuda.max_memory_allocated "
              f"{got['peak_bytes'] / 2**30:.3f} GiB, {got['sp_calls']} "
              f"collectives taking {got['sp_seconds']:.3f} s (timed between "
              f"device synchronises), launches "
              f"{ {k: got['launches'][k] for k in GEOM_COUNTERS} }"
              f" [{card}]")
    check(not on_card or max(g["peak_bytes"] for g in ranks)
          < one["peak_bytes"], "sp 10b: a 'seq' rank's peak memory is not "
          "below one process's")
    out["long_runs"] = dict(one=one, seq=ranks)
    return out


# ---------------------------------------------------------------------------
# phase 11: ingest -> train with the aatype embedding -> export -> score
# ---------------------------------------------------------------------------
AATYPE_ON = "model.embed.use_aatype_embedding=true"
AATYPE_KEY = "score_model.aatype_embed.weight"
# 11a's synthetic release protein: a small domain's length, 16 frames
RELEASE_PROTEIN = dict(pid="1syn_A", n_res=96, n_frames=16)
# the key sets of the JAX package's analysis functions (tests hold the
# port's to them on the CPU): compute_violation_metrics, protein_metrics
VIOLATION_KEYS = {
    "violations_extreme_ca_ca_distance", "violations_between_residue_bond",
    "violations_between_residue_clash", "violations_within_residue",
    "violations_per_residue", "residue_violations", "num_residue_violations",
    "structural_violations"}
PROTEIN_METRIC_KEYS = {
    "ca_ca_bond_dev", "ca_ca_valid_percent", "num_ca_steric_clashes",
    "ca_steric_clash_percent", "radius_of_gyration", "helix_percent",
    "strand_percent", "coil_percent", "tm_score",
    *(VIOLATION_KEYS - {"residue_violations", "structural_violations"})}


def ingest_phase(torch, tmp: str, weights: str, of_cfg, *,
                 tag: str = "", device: str = "cuda") -> dict:
    """11a: a synthetic dynamicPDB release directory of one protein
    (``data/synthetic.write_release_protein``: segment pickles wrapped by
    one box length, a gzipped State XML, an ``_npt_sim.dat``) through
    ``tools/ingest_release`` with ``--unwrap`` and ``--weights``: one
    manifest row, the unwrapped frames, node and edge reprs equal to a
    direct ``omegafold_embed`` of the sequence, every GeoFormer launch of
    its 10 cycles; then the state table through ``preprocess/energies``."""
    from dynamicpdb_tpu_torch.data.synthetic import write_release_protein
    from dynamicpdb_tpu_torch.models.omegafold.model import omegafold_embed
    from dynamicpdb_tpu_torch.models.omegafold.pipeline import fasta2inputs
    from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
    from dynamicpdb_tpu_torch.preprocess import energies
    from dynamicpdb_tpu_torch.preprocess.extract_embeddings import (
        load_release_weights,
    )
    from dynamicpdb_tpu_torch.tools import ingest_release

    pid, n_res = RELEASE_PROTEIN["pid"], RELEASE_PROTEIN["n_res"]
    root = os.path.join(tmp, "release")
    prot = write_release_protein(root, pid, n_res=n_res,
                                 n_frames=RELEASE_PROTEIN["n_frames"], seed=11)
    out_dir = os.path.join(tmp, "ingested")
    geom_mod.geom_launches = geom_mod.node_launches = 0  # the path starts
    geom_mod.geom_launches_128 = geom_mod.node_launches_128 = 0
    t0 = time.perf_counter()
    rc = ingest_release.main(["--data-root", root, "--out-dir", out_dir,
                              "--unwrap", "--weights", weights, "--device",
                              device])
    wall = time.perf_counter() - t0
    launched = {"geom_attention": geom_mod.geom_launches,
                "node_attention": geom_mod.node_launches}
    tiled = {"geom_attention": geom_mod.geom_launches_128,
             "node_attention": geom_mod.node_launches_128}
    check(rc == 0, f"ingest: exit code {rc}")
    manifest = os.path.join(out_dir, "manifest.csv")
    with open(manifest) as f:
        rows = f.read().splitlines()
    check(len(rows) == 2 and rows[1].startswith(f"{pid},")
          and rows[1].endswith(f",{n_res}"),
          f"ingest: manifest rows {rows[1:]}, expected one for {pid}")
    bundle = os.path.join(out_dir, f"{pid}.npz")
    cycles_run = 10  # extract_embeddings' default, as the JAX tool runs it
    on_card = device == "cuda"
    per_cycle = of_cfg.geo_num_blocks if on_card else 0
    expect = {"geom_attention": cycles_run * per_cycle * of_cfg.geom_count,
              "node_attention": cycles_run * per_cycle}
    check(launched == expect, f"ingest: GeoFormer launches {launched}, "
          f"expected {expect}")
    # the square calls of n_res <= 128 residues: the 128-row instance
    short = geom_mod.tile_rows(n_res) == 128
    check(tiled == {k: n if short else 0 for k, n in expect.items()},
          f"ingest: {tiled} launches in the 128-row instance, of {launched}")

    model = load_release_weights(weights, device=device)
    seq = ingest_release.pdb_sequence(pid, prot["dir"])
    (_, cycles), = fasta2inputs([f">{pid}", seq])
    emb = omegafold_embed(model, cycles)
    del model
    with np.load(bundle) as z:
        node, edge = z["node_repr"], z["edge_repr"]
        pos = z["all_atom_positions"]
    direct = (emb.node.cpu().numpy(), emb.edge.cpu().numpy())
    node_err = float(np.abs(node - direct[0]).max())
    edge_err = float(np.abs(edge - direct[1]).max())
    check(node.shape == (n_res, 256) and edge.shape == (n_res, n_res, 128),
          f"ingest: reprs {node.shape} {edge.shape}")
    check(node_err == 0.0 and edge_err == 0.0, "ingest: the bundle's reprs "
          f"differ from a direct omegafold_embed by {node_err}, {edge_err}")
    unwrap_err = float(np.abs(pos - prot["atom37"]).max())
    check(unwrap_err < 1e-3, f"ingest: unwrapped frames {unwrap_err} A from "
          "the written ones")
    table = energies.read_statedata(os.path.join(prot["dir"],
                                                 f"{pid}_npt_sim.dat"))
    summary = energies.energy_summary(table)
    check(len(table["potential_kj_mol"]) == RELEASE_PROTEIN["n_frames"]
          and all(math.isfinite(v) for v in summary.values()),
          f"energies: {len(table['potential_kj_mol'])} rows")
    print(f"ingest: {pid} {n_res} residues x {RELEASE_PROTEIN['n_frames']} "
          f"frames, --unwrap --weights (release OmegaFold, {cycles_run} "
          f"cycles): 1 manifest row, frames within {unwrap_err:.2e} A of the "
          f"unwrapped ones, reprs equal to a direct omegafold_embed (max "
          f"diff {node_err}, {edge_err}), GeoFormer launches {launched} "
          f"({tiled} in the 128-row instance); "
          f"{wall:.2f} s of the CLI (weights loaded included){tag}")
    print("energies: " + ", ".join(
        f"{k} {summary[k]:.4f}" for k in (
            "potential_kj_mol_mean", "potential_kj_mol_std",
            "total_kj_mol_mean", "temperature_k_mean", "temperature_k_std",
            "box_volume_nm3_mean")))
    return dict(csv=manifest, launches=launched, launches_128=tiled,
                wall=wall)


def aatype_card_vs_cpu(seed: int = 0, n_res: int = 12, pad_to: int = 16):
    """11c: the aatype embedding at the small width, randomised weights:
    the forward and every gradient (the embedding's among them) of the sum
    of the outputs times seeded cotangents on the card against the CPU,
    at phase 4's grad-flow bar; zeroing the embedding on the card must move
    the outputs past that bar."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.data.dataset import pad_window
    from dynamicpdb_tpu_torch.data.featurize import featurize_window
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.train.experiment import RAW_KEYS
    from dynamicpdb_tpu_torch.weights import randomize_

    cfg = config_lib.apply_overrides(config_lib.Config(),
                                     SMALL_OVERRIDES + [AATYPE_ON])
    w = pad_window(make_window(n_res=n_res, frame_time=2,
                               node_dim=cfg.model.node_repr_dim,
                               edge_dim=cfg.model.edge_repr_dim, seed=seed,
                               rot_wiggle=0.1), pad_to)
    feats = featurize_window({k: torch.as_tensor(np.asarray(w[k]))
                              for k in RAW_KEYS})
    runs = {}
    for dev in ("cpu", "cuda"):
        model = randomize_(DFoldScoreNetwork(cfg.model, device=dev), seed)
        f = _to(feats, dev)
        reset_ipa_counts(ipa_mod)
        out = model(f)
        g = torch.Generator().manual_seed(seed)
        cots = {k: torch.randn(v.shape, generator=g).to(dev)
                for k, v in sorted(out.items())}
        sum(torch.sum(out[k] * c) for k, c in cots.items()).backward()
        runs[dev] = ({k: v.detach().cpu() for k, v in out.items()},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = ipa_counts(ipa_mod)
            with torch.no_grad():
                model.score_model.aatype_embed.weight.zero_()
                zeroed = {k: v.cpu() for k, v in model(f).items()}
    (out_cpu, g_cpu), (out_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    worst_out = 0.0
    for k, want in out_cpu.items():
        tol = GRAD_FLOW_RTOL * max(float(want.abs().max()), 1.0)
        err = float((out_gpu[k] - want).abs().max())
        check(err <= tol, f"aatype: output {k} card vs CPU {err} > {tol}")
        worst_out = max(worst_out, err / tol)
    check(sorted(g_cpu) == sorted(g_gpu) and AATYPE_KEY in g_cpu,
          "aatype: different parameters received gradients")
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
    worst = 0.0
    for name, want in g_cpu.items():
        tol = GRAD_FLOW_RTOL * max(float(want.abs().max()),
                                   floor / GRAD_FLOW_RTOL)
        err = float((g_gpu[name] - want).abs().max())
        check(err <= tol, f"aatype: {name} gradient card vs CPU {err} > {tol}")
        worst = max(worst, err / tol)
    emb_err = float((g_gpu[AATYPE_KEY] - g_cpu[AATYPE_KEY]).abs().max())
    moved = max(float((zeroed[k] - out_gpu[k]).abs().max())
                / (GRAD_FLOW_RTOL * max(float(out_cpu[k].abs().max()), 1.0))
                for k in out_cpu)
    check(moved > 10.0, f"aatype: zeroing the embedding moved the outputs "
          f"by only {moved:.2f} x the bar")
    check(launched["ipa_attention_fwd"][0] == cfg.model.ipa.num_blocks,
          f"aatype: IPA launches {launched}")
    print(f"aatype (11c): small width, randomised weights, card vs CPU: "
          f"outputs within {worst_out:.3f} of the bar, {len(g_cpu)} "
          f"gradients within {worst:.3f} (the embedding's max diff "
          f"{emb_err:.3e}, max |g| {float(g_cpu[AATYPE_KEY].abs().max()):.3e}"
          f"); the embedding zeroed moves the outputs {moved:.1f} x the bar")


def export_phase(torch, ckpt: str, tmp: str, *, n_res: int = 200,
                 pad_to: int = 256, device: str = "cuda", tag: str = ""):
    """11d: ``train/export_torch``'s CLI on a train_cli checkpoint (phase
    4's), ``train/import_torch`` reading the pickle back into a fresh
    network, and one forward of each on the card, bit-equal."""
    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.data.dataset import pad_window
    from dynamicpdb_tpu_torch.data.featurize import featurize_window
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.eval_cli import _model_overrides
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib
    from dynamicpdb_tpu_torch.train import export_torch, import_torch
    from dynamicpdb_tpu_torch.train.experiment import RAW_KEYS

    t0 = time.perf_counter()
    out = export_torch.main(["--ckpt", ckpt, "--out",
                             os.path.join(tmp, "reference.pth")])
    saved = ckpt_lib.load(ckpt)
    cfg = config_lib.apply_overrides(config_lib.Config(), _model_overrides(
        saved["config"]["model"]))
    original = DFoldScoreNetwork(cfg.model, device=device)
    original.load_state_dict(saved["model"], strict=True)
    imported = DFoldScoreNetwork(cfg.model, device=device)
    extras = import_torch.import_reference_checkpoint(out, imported)
    check(extras["step"] == saved["step"], f"export: step {extras['step']}")
    w = pad_window(make_window(n_res=n_res, frame_time=cfg.data.frame_time,
                               node_dim=cfg.model.node_repr_dim,
                               edge_dim=cfg.model.edge_repr_dim, seed=3,
                               rot_wiggle=0.1), pad_to)
    feats = _to(featurize_window({k: torch.as_tensor(np.asarray(w[k]))
                                  for k in RAW_KEYS}), device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            a, b = original(feats), imported(feats)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k in a:
        check(torch.equal(a[k], b[k]), f"export: the imported network's {k} "
              "differs from the original's")
    print(f"export (11d): {os.path.basename(ckpt)} (step {saved['step']}) -> "
          f"{os.path.getsize(out) / 1e6:.1f} MB reference pickle, read back "
          f"by import_torch, one forward at n_res={n_res} bit-equal "
          f"({len(a)} outputs) in {time.perf_counter() - t0:.2f} s{tag}")


def export_refusal(ckpt: str, tmp: str):
    """11d: the strict export of a checkpoint with the aatype embedding
    raises; ``--no-strict`` writes the file without it."""
    import torch

    from dynamicpdb_tpu_torch.train import export_torch

    out = os.path.join(tmp, "aatype_reference.pth")
    try:
        export_torch.main(["--ckpt", ckpt, "--out", out])
        check(False, "export: a strict export of the aatype embedding passed")
    except ValueError as e:
        check("aatype_embed" in str(e), f"export: refused with {e}")
    export_torch.main(["--ckpt", ckpt, "--out", out, "--no-strict"])
    keys = torch.load(out, map_location="cpu", weights_only=False)["model"]
    check(AATYPE_KEY not in keys and "expand_node.weight" in keys,
          "export: --no-strict kept the embedding or lost the network")
    print(f"export (11d): strict export of {os.path.basename(ckpt)} refused "
          f"the aatype embedding; --no-strict wrote {len(keys)} keys without "
          "it")


def score_phase(torch, results: list, device: str = "cuda", tag: str = "",
                lengths=(256, 97)):
    """11e: phase 3's served release frames (the full sampler's requests
    of ``lengths`` residues) scored by ``analysis/violations``,
    ``analysis/structure_checks`` (the first served frame as the reference
    of the TM-score) and ``analysis/contact_order`` on the card."""
    from dynamicpdb_tpu_torch.analysis.contact_order import contact_order
    from dynamicpdb_tpu_torch.analysis.structure_checks import protein_metrics
    from dynamicpdb_tpu_torch.analysis.violations import (
        compute_violation_metrics,
    )
    from dynamicpdb_tpu_torch.chem import constants as chem

    t0 = time.perf_counter()
    for res in results:
        if res["fast_x0"] or res["n"] not in lengths:
            continue
        traj, aatype = res["out"]["atom_traj"], np.asarray(res["aatype"])
        n = len(aatype)
        mask = np.asarray(chem.restype_atom37_mask, np.float32)[aatype]
        ridx = np.arange(n)
        atom37 = traj[-1] * mask[..., None]
        vm = compute_violation_metrics(atom37, mask, aatype, ridx)
        pm = protein_metrics(atom37, mask, traj[0] * mask[..., None], aatype,
                             ridx)
        ca = torch.as_tensor(traj[:, :, 1], device=device)
        co = contact_order(ca)
        check(co.device.type == torch.device(device).type
              and co.shape == (len(traj),), f"score: contact order {co}")
        co = co.cpu().numpy()
        check(set(vm) == VIOLATION_KEYS and set(pm) == PROTEIN_METRIC_KEYS,
              f"score: keys {sorted(vm)} {sorted(pm)}")
        scalars = {**{k: v for k, v in vm.items()
                      if isinstance(v, (int, float))}, **pm}
        check(all(math.isfinite(float(v)) for v in scalars.values())
              and np.isfinite(co).all(), f"score: non-finite {scalars} {co}")
        print(f"score (11e): n_res={n} last served frame: " + ", ".join(
            f"{k} {float(v):.4f}" for k, v in sorted(scalars.items()))
            + f"; contact order per frame {[round(float(c), 4) for c in co]}"
            f"{tag}")
    print(f"score (11e): in {time.perf_counter() - t0:.2f} s")


def pipeline_phase(torch, tmp: str, card: str, weights: str, of_cfg, serve,
                   release: str, export_seconds: float) -> dict:
    """Phase 11 (inside phase 5's directory, on its OmegaFold checkpoint):
    11a ingest, 11b train_cli with the aatype embedding on the ingested
    manifest and serve_cli from its checkpoint, 11c the embedding card vs
    CPU, 11d the strict refusal (11d's export of phase 4's checkpoint ran
    beside phase 4), 11e scoring phase 3's frames. Returns 11a's and
    11b's launch counts."""
    t0 = time.perf_counter()
    ing = ingest_phase(torch, tmp, weights, of_cfg, tag=f" [{card}]")
    extra = [AATYPE_ON]
    # 3 steps, as phase 4: from the JAX init (zero out-projections and
    # backbone updates) block b's q/k/v first move at step 3, which
    # train_phase checks
    train = train_phase("cuda", release, extra, lengths=None, n_frames=None,
                        max_steps=3, tmp=tmp, csv=ing["csv"],
                        tag=f" [aatype, {card}]")
    check(AATYPE_KEY in train["moved"], f"train: {AATYPE_KEY} did not move")
    for m in train["steps"]:
        check(math.isfinite(m["total_loss"]), f"train: loss {m}")
    serve_checkpoint("cuda", release, train["ckpt"], extra,
                     n_res=RELEASE_PROTEIN["n_res"], pad_to=256,
                     tag=f" [aatype, {card}]")
    aatype_card_vs_cpu()
    export_refusal(train["ckpt"], tmp)
    score_phase(torch, serve["results"], tag=f" [{card}]")
    seconds = time.perf_counter() - t0
    print(f"pipeline: phase 11 in {seconds:.2f} s, {seconds + export_seconds:.2f}"
          f" s with 11d's export beside phase 4 [{card}]")
    return dict(ingest=ing["launches"], ingest_128=ing["launches_128"],
                train=train["launched"])


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
    faulthandler.dump_traceback_later(1150, exit=True)
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
        if b.name == "geom_attention":  # each instance by name
            for fn, use in sorted(ptxas_usage(b.log).items()):
                print(f"build: geom_attention: {geom_instance(fn)}: {use}")
            continue
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
    for kname in ipa_mod.WRAPPERS:
        need = ipa_mod.wide_smem(kname, w["C"], 3 * w["Pq"], 3 * w["Pv"],
                                 w["Dz"])
        print(f"build: {kname} wide route: {need} bytes of dynamic shared "
              f"memory per block at the wide case (limit "
              f"{ipa_mod.wide_smem_limit()})")
        need = ipa_mod.wide_smem(kname, w["C"], 3 * w["Pq"], 3 * w["Pv"],
                                 w["Dz"], kernels=ipa_mod.WIDE_TC_KERNELS)
        print(f"build: {ipa_mod.launcher(kname, 'wide_tc')[1]}: {need} bytes "
              "of dynamic shared memory per block at the wide case")
    for rows in geom_mod.TILE_ROWS:
        print(f"build: geom_attention, node_attention: "
              f"{geom_mod._lib().geom_attention_smem(rows)} bytes of dynamic "
              f"shared memory per block in the {rows}-row instance")
    mma = sass_mma_counts(_build.nvcc(), built["geom_attention"].path)
    for fn, n in sorted(mma.items()):
        print(f"build: geom_attention.cu SASS: {n} tensor-core instructions "
              f"in {geom_instance(fn)}")
    # 2 kernels (masked or not) x 3 (float32, bf16 with float32 weights,
    # bf16 with bf16 weights) in each instance
    for rows in geom_mod.TILE_ROWS:
        got = [n for fn, n in mma.items()
               if geom_instance(fn).endswith(f"rows={rows}>")]
        check(len(got) == 6 and all(got), f"geom_attention.cu: the "
              f"{rows}-row instance has {len(got)} kernels, or one without "
              f"tensor-core instructions: {mma}")
    check(len(mma) == 6 * len(geom_mod.TILE_ROWS), "geom_attention.cu: "
          f"kernels beside the instances: {mma}")
    tc_kernels = (("ipa_attention_fwd", "ipa_attn_fwd_kernel"),
                  ("ipa_attention_bwd", "ipa_bwd_dq_kernel"),
                  ("ipa_attention_bwd", "ipa_bwd_dkv_kernel"),
                  ("ipa_attention_bwd", "ipa_bwd_pair_kernel"),
                  ("ipa_attention_wide_tc_fwd", "ipa_wtc_fwd_kernel"),
                  ("ipa_attention_wide_tc_bwd", "ipa_wtc_bwd_dq_kernel"),
                  ("ipa_attention_wide_tc_bwd", "ipa_wtc_bwd_dkv_kernel"),
                  ("ipa_attention_wide_tc_bwd", "ipa_wtc_bwd_pair_kernel"))
    ipa_sass = {src: sass_mma_counts(_build.nvcc(), built[src].path)
                for src in {src for src, _ in tc_kernels}}
    for src_name, kernel in tc_kernels:
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
    rect_kernel_phase(torch, device, card, {
        r["name"]: r for r in [fwd_report, wide_fwd_report] + bwd_reports})
    geom_reports = geom_kernel_phase(torch, device, card)
    geom_rect_reports = geom_rect_phase(torch, device, card)
    tri_reports = triangle_phase(torch, device, card)
    view_report = triangle_view_phase(torch, device, card)
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
        check(set(train["routes"].values()) == {"tc"}, "train: the release "
              f"widths left the tensor-core kernels: {train['routes']}")
        # phase 11d's export of this checkpoint (its directory closes
        # before phase 11 runs)
        t0 = time.perf_counter()
        export_phase(torch, train["ckpt"], tmp, tag=f" [{card}]")
        export_seconds = time.perf_counter() - t0
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
        torch.cuda.empty_cache()  # the card's memory for the ranks
        dp_phase(torch, release, train, tmp, card)
        print(f"dp: phase in {time.perf_counter() - t0:.2f} s [{card}]")

        # phase 9: sequence parallelism, against phase 4's one process, phase
        # 3c's rollout and one process at N = 1024
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        _, sp_roll, sp_long = run_phases(
            sp_train_phase(torch, release, train, tmp, card),
            sp_rollout_phase(torch, batched, tmp, card, RELEASE_OVERRIDES),
            sp_long_phase(torch, release, tmp, card))
        fwd_report["launches_sp_rollout_per_rank"] = sp_roll["launches"]
        for rep, key in zip([fwd_report] + bwd_reports[:3],
                            ("launches", "bwd_dq_launches",
                             "bwd_dkv_launches", "bwd_pair_launches")):
            rep["launches_sp_step_per_rank"] = sp_long["seq"][0][
                "launches"][key]
        print(f"sp: phase in {time.perf_counter() - t0:.2f} s [{card}]")

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
    want = {k: "wide_tc" for k in ipa_mod.WRAPPERS}
    check(wide["routes"] == want, f"train wide: ran the routes "
          f"{wide['routes']}, expected {want}")
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

        # phase 10: OmegaFold under sequence parallelism, on the same
        # checkpoint
        t0 = time.perf_counter()
        sp_of = sp_omegafold_phase(torch, tmp, card, weights=ext["ckpt"])
        for rep in geom_rect_reports:
            key = ("geom_launches" if rep["name"].startswith("geom")
                   else "node_launches")
            rep["launches"] = sp_of["launches"][key]
            rep["launches_per_cycle"] = sp_of["per_cycle"][key]
            # of them in the 128-row instance
            rep["launches_128"] = sp_of["launches"][key + "_128"]
        print(f"sp omegafold: phase in {time.perf_counter() - t0:.2f} s "
              f"[{card}]")

        # phase 11: ingest -> train with the aatype embedding -> export ->
        # score, on the same checkpoint
        pipe = pipeline_phase(torch, tmp, card, ext["ckpt"],
                              OmegaFoldConfig(), serve, release,
                              export_seconds)
        for rep, key in zip([fwd_report] + bwd_reports[:3],
                            ("fwd", "dq", "dkv", "pair")):
            rep["launches_pipeline_train"] = pipe["train"][key]
    check(ext["params"] == 795_074_210, f"extract: the release model has "
          f"{ext['params']:,} parameters, not 795,074,210")
    for rep in tri_reports:
        rep["launches"] = ext["launches"][rep["name"]]
        rep["launches_fold"] = fold["launches"][rep["name"]]
    for rep in geom_reports:
        rep["launches"] = ext["launches"][rep["name"]]
        rep["launches_fold"] = fold["launches"][rep["name"]]
        rep["launches_ingest"] = pipe["ingest"][rep["name"]]
        # 11a's 96 residues: the 128-row instance
        rep["launches_ingest_128"] = pipe["ingest_128"][rep["name"]]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        extract_card_vs_cpu(tmp)
    print(f"extract: card vs CPU in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fold_card_vs_cpu()
    print(f"fold: card vs CPU in {time.perf_counter() - t0:.2f} s")

    # phase 12: AlphaFold2 extraction from a 4,096-row MSA at model_5's
    # widths and depth, then at a tiny size on the CPU
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        af2 = alphafold_phase(torch, "cuda", tmp, card)
        view_report["launches"] = af2["launches"]["tri_view_launches"]
        alphafold_phase(torch, "cpu", tmp, card, cfg=alphafold_tiny_cfg(),
                        length=14, rows=600)
    print(f"alphafold: phase in {time.perf_counter() - t0:.2f} s [{card}]")

    reports = ([fwd_report, wide_fwd_report] + bwd_reports + geom_reports
               + geom_rect_reports + tri_reports + [view_report])
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
    modes = {"--dp-cards": dp_cards_main, "--alphafold": alphafold_main}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes
             else main())
