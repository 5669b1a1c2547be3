"""Time the IPA forward and dq kernels on the card, and measure where their
float32 error comes from.

    python dynamicpdb_tpu_torch/tools/bench_ipa.py [--package DIR] \
        [--rounds 3] [--reps 50] [--precision] [--ablate]

Times the forward (``csrc/ipa_attention_fwd.cu``) and the dq kernel of the
backward (``csrc/ipa_attention_bwd.cu``) at the release shapes (F=2, N=256,
H=8, C=256, Pq=8, Pv=12, Dz=32, last 56 residues masked), through their
public wrappers (``ms``) and alone (``ms_kernel``, outputs allocated once,
``chip_smoke.ipa_kernel_ms``), in ``--rounds`` interleaved rounds of
``--reps`` launches (CUDA events, inputs warm in L2), and prints one JSON
line per kernel. Inputs, timer and loader are ``chip_smoke.py``'s and
``tools/bench_geom.py``'s, from this checkout.

``--package DIR`` times the ``dynamicpdb_tpu_torch`` package under DIR
instead of this checkout's, so that two versions of the kernels can be
timed on one card in one run: run this script (as a script, not with
``-m``) once against each, e.g. parent, change, change, parent.

``--ablate`` builds copies of this checkout's forward kernel with one part
of its key-step loop removed (the pair-stream loop, all pair_z work, p.v,
q.k^T, the point distances, p.vp, the key fetches after the first; loads
alone; math alone) and times each alone, interleaved with the whole
kernel: where the forward's time goes. The copies compute wrong results;
they are timed, never checked. The edits are made on the source text and
fail loudly when the kernel no longer has the lines they expect.

``--precision`` runs both kernels in float32 at the release widths with one
frame and two heads, and holds them, the float32 plain versions and the
emulations below (every product through ``bench_geom.mm_3xtf32`` with the
tensor cores' round-toward-zero accumulation, or through one TF32 pass,
``mm_one_pass``) against the same functions in float64, on real rows.
Runs only on a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import torch

if __package__:
    from . import bench_geom
else:  # run as a script
    import bench_geom

KERNELS = ("ipa_attention_fwd", "ipa_attention_bwd_dq")
C_B, INF = math.sqrt(1.0 / 3), 1e5


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in torch (also run by the CPU tests)
# ---------------------------------------------------------------------------
def _heads(t):
    """[F, N, H, ...] -> [F, H, N, prod(...)]"""
    return t.reshape(t.shape[:3] + (-1,)).transpose(1, 2)


def _logits(q, k, q_pts, k_pts, bias, mask, head_weights, c_qk, mm):
    """The logits [F, H, N, N] with q.k^T and qp.kp^T through ``mm``, the
    terms added in the kernels' order."""
    qp, kp = _heads(q_pts), _heads(k_pts)
    qk = mm(_heads(q), _heads(k).transpose(-1, -2))
    dist = ((qp * qp).sum(-1)[..., :, None] + (kp * kp).sum(-1)[..., None, :]
            - 2 * mm(qp, kp.transpose(-1, -2)))
    l = c_qk * qk
    l = l + C_B * bias.permute(2, 0, 1)[None]
    l = l + (-0.5) * head_weights[None, :, None, None] * dist
    return l + INF * (mask[:, :, None] * mask[:, None, :] - 1.0)[:, None]


def ipa_fwd_mm(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
               head_weights, c_qk, mm):
    """The forward kernel's arithmetic: q.k^T, qp.kp^T, p.v and p.vp
    through ``mm``, the pair stream in plain sums, the probabilities
    unnormalised until the end. Returns (o [F, N, H, C], o_pt
    [F, N, H, Pv*3], o_pair [F, N, H, Dz])."""
    l = _logits(q, k, q_pts, k_pts, bias, mask, head_weights, c_qk, mm)
    p = torch.exp(l - l.amax(-1, keepdim=True))
    s = p.sum(-1, keepdim=True)
    o = mm(p, _heads(v)) / s
    o_pt = mm(p, _heads(v_pts)) / s
    o_pair = torch.einsum("fhij,ijd->fhid", p, pair_z) / s
    return tuple(t.transpose(1, 2) for t in (o, o_pt, o_pair))


def ipa_dq_mm(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
              lse, dvec, g_o, g_opt, g_pair, c_qk, mm):
    """The dq kernel's arithmetic on the 15 backward inputs
    (``ops.ipa_attention.backward_inputs``): q.k^T, qp.kp^T, g_o.v^T,
    g_opt.vp^T and dl.k through ``mm``, the pair term in plain sums.
    Returns dq [F, N, H, C]."""
    l = _logits(q, k, q_pts, k_pts, bias, mask, head_weights, c_qk, mm)
    a = torch.exp(l - lse[..., None])
    ds = (mm(_heads(g_o), _heads(v).transpose(-1, -2))
          + mm(_heads(g_opt), _heads(v_pts).transpose(-1, -2))
          + torch.einsum("fihd,ijd->fhij", g_pair, pair_z))
    dl = a * (ds - dvec[..., None])
    return (c_qk * mm(dl, _heads(k))).transpose(1, 2)


def precision_inputs(smoke, device, dtype=torch.float32):
    """Release widths, F = 1, H = 2, N = 256, last 56 residues masked
    (``chip_smoke.ipa_inputs``): the forward's inputs in ``dtype``, and the
    dq kernel's 15 inputs with seeded cotangents zero on pad rows, lse and
    D from the float64 forward (so that every dq below starts from the same
    values)."""
    args, c_qk = smoke.ipa_inputs(torch, device, F=1, H=2, seed=0)
    args64 = [a.double() for a in args]
    exact = lambda a, b: a @ b  # noqa: E731
    l = _logits(*(args64[i] for i in (0, 1, 3, 4, 6, 8, 9)), c_qk, exact)
    lse = torch.logsumexp(l, -1)
    out = ipa_fwd_mm(*args64, c_qk, exact)
    g = torch.Generator(device=device).manual_seed(3)
    mask = args64[8]
    cots = [torch.randn(o.shape, generator=g, device=device,
                        dtype=torch.float64) * mask[..., None, None]
            for o in out]
    dvec = sum((c * o).sum(-1) for c, o in zip(cots, out)).transpose(1, 2)
    pts = [args64[i].reshape(args64[i].shape[:3] + (-1,)) for i in (3, 4, 5)]
    bwd = (args64[0], args64[1], args64[2], *pts, *args64[6:], lse, dvec,
           *cots)
    return ([a.to(dtype) for a in args],
            [t.to(dtype).contiguous() for t in bwd], c_qk)


NAMES = ("o", "o_pt", "o_pair", "dq")


def emulate(mm, fwd_args, bwd_inputs, c_qk):
    """(o, o_pt, o_pair, dq) with every product through ``mm``."""
    return (ipa_fwd_mm(*fwd_args, c_qk, mm)
            + (ipa_dq_mm(*bwd_inputs, c_qk, mm),))


def errors_vs_float64(fwd_args, bwd_inputs, c_qk, results: dict) -> dict:
    """{scheme: {output: max abs error on real rows against float64}} for
    each scheme's (o, o_pt, o_pair, dq) in ``results`` (points flattened),
    and "scale": each float64 output's largest magnitude."""
    real = fwd_args[8].bool()[..., None, None]  # [F, N, 1, 1]
    exact = emulate(lambda a, b: a @ b, [a.double() for a in fwd_args],
                    [t.double() for t in bwd_inputs], c_qk)
    out = {"scale": {n: float(e.abs().max()) for n, e in zip(NAMES, exact)}}
    for scheme, got in results.items():
        out[scheme] = {n: float(((g.double() - e) * real).abs().max())
                       for n, g, e in zip(NAMES, got, exact)}
    return out


def emulations() -> dict:
    """The float32 schemes: one TF32 pass, 3xTF32 with the accumulator
    rounded toward zero after each 8-deep step (the model of the tensor
    cores' accumulation that tools/bench_geom.py --precision fitted to the
    GeoFormer kernels), and plain float32."""
    return {
        "one_pass": bench_geom.mm_one_pass,
        "3xtf32_toward_zero": lambda a, b: bench_geom.mm_3xtf32(
            a, b, accumulate="toward_zero"),
        "plain_float32": lambda a, b: a @ b,
    }


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def timings(smoke, mod, device, rounds: int, reps: int) -> list[dict]:
    args, c_qk = smoke.ipa_inputs(torch, device, seed=20)
    inputs, _ = smoke.ipa_bwd_inputs(torch, args, c_qk, zero_pad=False,
                                     seed=4)
    kw = dict(c_qk=c_qk, c_b=C_B, inf=INF)
    calls = {"ipa_attention_fwd": (args, lambda: mod.ipa_attention_fwd(
                 *args, c_qk)),
             "ipa_attention_bwd_dq": (inputs, lambda: mod.ipa_attention_bwd_dq(
                 *inputs, **kw))}
    times = {k: {"ms_kernel": [], "ms": []} for k in KERNELS}
    for _ in range(rounds):
        for kind in KERNELS:
            operands, call = calls[kind]
            times[kind]["ms_kernel"].append(
                smoke.ipa_kernel_ms(torch, mod, kind, operands, c_qk, reps))
            times[kind]["ms"].append(smoke.time_ms(torch, call, reps))
    return [{"kernel": k, **t} for k, t in times.items()]


def precision(smoke, mod, device) -> dict:
    fwd_args, bwd_inputs, c_qk = precision_inputs(smoke, device)
    o, o_pt, o_pair, _ = mod.ipa_attention_fwd(*fwd_args, c_qk)
    dq = mod.ipa_attention_bwd_dq(*bwd_inputs, c_qk=c_qk, c_b=C_B,
                                  inf=INF)[0]
    results = {name: emulate(mm, fwd_args, bwd_inputs, c_qk)
               for name, mm in emulations().items()}
    results["kernel"] = (o, o_pt.flatten(3), o_pair, dq)
    return errors_vs_float64(fwd_args, bwd_inputs, c_qk, results)


# the forward's key-step loop, part by part: (anchor, replacement) edits
_SKIP_PAIR_LOOP = (
    ("      cp_async_wait<1>();  // this step's pair_z rows (the key tile may "
     "wait)\n      __syncwarp();\n", "@@cut_start"),
    ("      __syncwarp();  // every lane has read the rows", "@@cut_end"))
_SKIP_PZ = (
    ("  if (pair_warp) fetch_pz(spz, pz, r0 + 8 * rr, 0, L);", ""),
    ("      if (step + 1 < n_steps) fetch_pz(spz, pz, r0 + 8 * rr, j0 + kKeys, "
     "L);", ""),
    ("    if (pair_warp)\n      cp_async_wait<1>();\n    else\n      "
     "cp_async_wait<0>();", "    cp_async_wait<0>();"))
_SKIP_PV = (("        mma3(o_acc[n], ph[ks], pl[ks], bh, bl);", ""),)
_SKIP_QK = (("    qk_partial<NT>(", "    if (0) qk_partial<NT>("),
            ("    float sc[2][4];\n", "    float sc[2][4] = {};\n"))
_SKIP_DIST = (("      point_dist(dist, qpa, qsq, sksq, kt, L);",
               "      for (int e = 0; e < 8; ++e) dist[e >> 2][e & 3] = 0.f;"),)
_SKIP_PT = (("          mma3(opt[n], ph[ks], pl[ks], bh, bl);", ""),)
_SKIP_FETCH = (("               j0 + kKeys, step + 1 < n_steps, L);",
                "               j0 + kKeys, false, L);"),)
ABLATIONS = {
    "all": (),
    "no pair-stream loop": _SKIP_PAIR_LOOP,
    "no pair_z work": _SKIP_PAIR_LOOP + _SKIP_PZ,
    "no p.v": _SKIP_PV,
    "no q.k^T": _SKIP_QK,
    "no point distances": _SKIP_DIST,
    "no p.vp": _SKIP_PT,
    "no key fetch after the first": _SKIP_FETCH,
    "loads only": (_SKIP_PAIR_LOOP + _SKIP_PV + _SKIP_QK + _SKIP_DIST
                   + _SKIP_PT),
    "math only": _SKIP_FETCH + _SKIP_PAIR_LOOP + _SKIP_PZ,
}


def ablated_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation: the forward no longer has {old!r}")
        if new == "@@cut_start":
            src = src.replace(old, old + "#if 0\n")
        elif new == "@@cut_end":
            src = src.replace(old, "#endif\n" + old)
        else:
            src = src.replace(old, new)
    return src


def ablation(smoke, device, rounds: int, reps: int) -> dict:
    """{variant: [ms alone per round]} of the forward at the release shapes."""
    from dynamicpdb_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC_DIR, "ipa_attention_fwd.cu")).read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ablate_", dir=_build.BUILD_DIR)
    try:
        for rel in _build.sources("ipa_attention_fwd")[1:]:
            shutil.copy(os.path.join(_build.CSRC_DIR, rel), work)
        procs = {}
        for i, (name, edits) in enumerate(ABLATIONS.items()):
            cu = os.path.join(work, f"v{i}.cu")
            with open(cu, "w") as f:
                f.write(ablated_source(src, edits))
            procs[name] = (os.path.join(work, f"libv{i}.so"), subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(work, f"libv{i}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"ablation {name}: nvcc failed:\n{log}")
            lib = ctypes.CDLL(so)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ipa_attention_fwd.argtypes = ([p] * 14 + [i] * 7 + [f] * 3
                                              + [i, p])
            lib.ipa_attention_fwd.restype = i
            libs[name] = lib
        args, c_qk = smoke.ipa_inputs(torch, device, seed=20)
        F, N, H, C = args[0].shape
        Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
        outs = [torch.empty(s, device=device) for s in (
            (F, N, H, C), (F, N, H, Pv, 3), (F, N, H, Dz), (F, H, N))]
        ptrs = [t.data_ptr() for t in list(args) + outs]
        stream = torch.cuda.current_stream(device).cuda_stream
        times = {name: [] for name in libs}
        for _ in range(rounds):
            for name, lib in libs.items():
                call = functools.partial(
                    lib.ipa_attention_fwd, *ptrs, F, N, H, C, Pq, Pv, Dz, c_qk,
                    C_B, INF, device.index or 0, stream)
                if call() != 0:
                    raise RuntimeError(f"ablation {name}: launch refused")
                times[name].append(smoke.time_ms(torch, call, reps))
        return times
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=bench_geom.ROOT,
                    help="directory holding the dynamicpdb_tpu_torch to time")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ipa: torch sees no CUDA device", file=sys.stderr)
        return 1
    smoke, mod = bench_geom._load(args.package, "ipa_attention")
    card = smoke.card_line()
    device = torch.device("cuda")
    label = os.path.relpath(os.path.abspath(args.package), bench_geom.ROOT)
    for row in timings(smoke, mod, device, args.rounds, args.reps):
        print(json.dumps({"package": label, "card": card, **row}))
    if args.precision:
        print(json.dumps({"package": label, "card": card,
                          "max_abs_err_vs_float64_real_rows":
                          precision(smoke, mod, device)}))
    if args.ablate:
        for name, t in ablation(smoke, device, args.rounds, args.reps).items():
            print(json.dumps({"package": label, "card": card,
                              "forward without": name, "ms_kernel": t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
