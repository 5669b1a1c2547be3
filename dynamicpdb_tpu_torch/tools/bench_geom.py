"""Time the GeoFormer attention kernels on the card, and measure where their
float32 error comes from.

    python dynamicpdb_tpu_torch/tools/bench_geom.py [--package DIR] \
        [--case CASE [CASE ...]] [--rounds 3] [--reps 20] [--precision] \
        [--save-outputs FILE | --compare-outputs FILE] [--ablate]

Times both kernels (``csrc/geom_attention.cu``) alone (operands prepared
once by the wrapper's ``kernel_inputs``) and through their public
wrappers, in ``--rounds`` interleaved rounds of ``--reps`` launches (CUDA
events, inputs warm in L2), beside the SDPA core on the same query rows
(``chip_smoke.sdpa_core_ms``, float32), and prints one JSON line per case,
kernel and dtype, naming the instance the wrapper took (``tile_rows``:
query rows a block). ``--case`` (default: release) picks the calls:
"release", both kernels at their release shapes in float32 and bfloat16;
or a call of phase 2b's ``chip_smoke.GEOM_RECT_CASES`` by its label with
hyphens, in float32: "rows-128-255" (node_attention on a 'seq' rank's
rows 128-255 of the release window), "rows-0-127", "ragged-rows-102-203",
"rows-256-511" (rank 1 of a 512-residue window), "B-128"
(geom_attention on a rank's 128 batch rows), "L-96" (both kernels'
square calls at 96 residues). The inputs and the timer are
``chip_smoke.py``'s (``geom_inputs``, ``time_ms``), from this checkout.

``--case triangle`` times GeometricAttention's triangle-multiplicative
branch instead (``ops/geom_triangle.py`` of the package), at the release
shapes in float32 (L 256, d 128, ``chip_smoke.triangle_inputs``): in each
round the einsum branch it replaced (``geom_triangle_plain`` on the card),
the route through its wrapper, the route again and the einsum branch
again, then each of its three kernels alone, each against its bound
max(3 x products / 495 TFLOP/s, compulsory bytes / 3.35 TB/s)
(``chip_smoke.triangle_cost``, ``chip_smoke.bounds``' tensor-core bound).

``--case triangle-view`` times the route's single-view form
(``geom_triangle_view``, AlphaFold2's triangle multiplications) the same
way at the release shapes, both views, against its bound
(``chip_smoke.triangle_view_cost``): in each round the einsums
(``geom_triangle_view_plain`` on the card), the route, the route, the
einsums.

``--package DIR`` times the ``dynamicpdb_tpu_torch`` package under DIR
instead of this checkout's, so that two versions of the kernels can be
timed on one card in one session: run this script (as a script, not with
``-m``) once against each, e.g. parent, change, change, parent.

``--save-outputs FILE`` writes both kernels' outputs at phase 2b's cases
of ``chip_smoke.py`` (``GEOM_CASES``: release, ragged and long ragged L;
``GEOM_RECT_CASES``: the rectangular and short calls; float32 and
bfloat16) and the two-view triangle route's at ``TRI_CASES`` (float32
and bfloat16) to FILE; ``--compare-outputs FILE`` computes them again and
prints, per output, whether it equals FILE's bit for bit and its largest
difference: run another checkout's package with the first and this one
with the second to show that a change left the kernels' arithmetic as it
was.

``--ablate`` builds copies of this checkout's kernel with one part removed
(``ABLATIONS``: the q|gate projection, the k|v projection, the attention
steps) and times node_attention alone in each at ``ABLATE_CASE`` (rows
128-255 of the release window, float32), in both instances (256 and 128
query rows a block), interleaved with the whole kernel: where the
rectangular call's time goes in each tile. The copies compute wrong
results; they are timed, never checked. Run it without ``--package``.

``--precision`` runs each kernel in float32 at its release widths with two
batch rows, and holds it, the float32 plain version and two emulations of
the kernels' 3xTF32 arithmetic (``gated_attention_mm`` with
``mm_3xtf32``) against the same function in float64: one emulation sums in
float32 rounded to nearest, the other rounds the accumulator toward zero
after every 8-deep step of every pass, a model of the tensor cores'
accumulators. Whichever emulation lands at the kernel's error is the
better model of the card. Runs only on a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in torch (also run by the CPU tests)
# ---------------------------------------------------------------------------
def tf32_round(t):
    """t rounded to TF32 (10 mantissa bits): round to nearest, ties away
    from zero, on the 13 low bits, as cvt.rna.tf32.f32 does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(t):
    """t cut to TF32: the 13 low mantissa bits cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def round_toward_zero(x64):
    """float64 x to float32, rounded toward zero."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mm_one_pass(a, b):
    """a @ b in one TF32 pass, float32 sums."""
    return tf32_round(a) @ tf32_round(b)


def mm_3xtf32(a, b, *, cut: bool = True, accumulate: str = "nearest"):
    """a @ b as hi.hi + hi.lo + lo.hi, float32 operands. ``cut``: hi is a
    cut to TF32 and lo = a - hi is read cut in turn (the kernels' split,
    csrc/geom_attention.cu), else both rounded to nearest. ``accumulate``:
    "nearest" sums in float32; "toward_zero" runs the kernels' mma order,
    per 8-deep step of the contraction lo.hi, hi.lo, hi.hi, each step's
    exact sum added to the accumulator and the result rounded toward zero."""
    tf32 = tf32_cut if cut else tf32_round
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    if accumulate == "nearest":
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    acc = None
    for k0 in range(0, a.shape[-1], 8):
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            step = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = round_toward_zero(step if acc is None
                                    else acc.double() + step)
    return acc


def gated_attention_mm(x, qg_w, qg_b, kv_w, kv_b, bias, c, scale, mm,
                       kmask=None):
    """The kernels' arithmetic with every product through ``mm``: x
    [B, R, L, d]; weights [d, R, H, 2c]; biases [R, H, 1, 2c]; bias
    [R, H, L, L]; kmask [B, L] or None. The probabilities enter p.v
    unnormalised, as in the kernels' online softmax. Returns
    [B, R, H, L, c] in the operands' dtype."""
    w_qg = qg_w.permute(1, 2, 0, 3)[None]  # [1, R, H, d, 2c]
    w_kv = kv_w.permute(1, 2, 0, 3)[None]
    xx = x[:, :, None]  # [B, R, 1, L, d]
    qg, kv = mm(xx, w_qg) + qg_b, mm(xx, w_kv) + kv_b
    q, gate, k, v = qg[..., :c] * scale, qg[..., c:], kv[..., :c], kv[..., c:]
    s = mm(q, k.transpose(-1, -2)) + bias
    if kmask is not None:
        s = s + (kmask[:, None, None, None, :] - 1.0) * 1e9
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True) * torch.sigmoid(gate)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _load(package: str, module: str = "geom_attention"):
    """(chip_smoke of this checkout, ops.``module`` of ``package``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(package))
    mod = importlib.import_module(f"dynamicpdb_tpu_torch.ops.{module}")
    return smoke, mod


# --case: the release square calls, or a call of chip_smoke.GEOM_RECT_CASES
# by its label, spaces as hyphens (both kernels where two share a label)
CASES = ("release", "rows-128-255", "rows-0-127", "ragged-rows-102-203",
         "rows-256-511", "B-128", "L-96", "triangle", "triangle-view")


def case_inputs(smoke, device, case: str, dtype) -> list[tuple]:
    """[(kind, inputs)] of ``case`` in ``dtype``: the release square calls
    at phase 2b's timed seed, or phase 2b's rectangular and short calls on
    its own inputs (``chip_smoke.geom_rect_phase``)."""
    if case == "release":
        return [(kind, smoke.geom_inputs(torch, device, kind, 256, dtype,
                                         seed=7))
                for kind in smoke.GEOM_SHAPES]
    out = [(kind, smoke.geom_inputs(
                torch, device, kind, L, dtype,
                seed=40 + L + (dtype == torch.bfloat16), B=B, rows=rows,
                masked_suffix=smoke.GEOM_RECT_MASKED))
           for label, kind, L, rows, B in smoke.GEOM_RECT_CASES
           if label.replace(" ", "-") == case]
    if not out:
        raise ValueError(f"bench_geom: no case {case!r} in "
                         "chip_smoke.GEOM_RECT_CASES")
    return out


def _tile_rows(mod, inp: dict) -> int:
    """The instance the wrapper of package ``mod`` takes for ``inp``; a
    package before the instances has only the 256-row one."""
    if not hasattr(mod, "tile_rows"):
        return 256
    return mod.tile_rows(inp["bias"].shape[-2])


def timings(smoke, mod, device, rounds: int, reps: int,
            cases=("release",)) -> list[dict]:
    """Per case, kernel and dtype: ``ms_kernel`` (alone), ``ms`` (through
    the wrapper) and, in float32, ``library_ms`` (the SDPA core on the same
    rows), one value a round. The release calls in float32 and bfloat16,
    the others in float32."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    inputs = {}
    for case in cases:
        for name, dt in dtypes.items():
            if case != "release" and name != "float32":
                continue
            for kind, inp in case_inputs(smoke, device, case, dt):
                inputs[(case, kind, name)] = inp
    times = {key: {"ms_kernel": [], "ms": []} for key in inputs}
    for key in inputs:
        if key[2] == "float32":
            times[key]["library_ms"] = []
    for _ in range(rounds):
        for (case, kind, name), inp in inputs.items():
            t = times[(case, kind, name)]
            t["ms_kernel"].append(smoke.geom_kernel_ms(torch, mod, kind, inp,
                                                       reps))
            t["ms"].append(smoke.time_ms(
                torch, lambda: smoke.geom_call(mod, kind, inp, plain=False),
                reps))
            if "library_ms" in t:
                t["library_ms"].append(smoke.sdpa_core_ms(torch, mod, kind,
                                                          inp))
    return [{"case": case, "kernel": kind, "dtype": name,
             "tile_rows": _tile_rows(mod, inputs[(case, kind, name)]), **t}
            for (case, kind, name), t in times.items()]


def triangle_timings(smoke, tri, device, rounds: int, reps: int) -> list:
    """The triangle branch at the release shapes, float32: ``plain_ms``
    (the einsum branch) and ``ms`` (the route through its wrapper), in the
    order plain, route, route, plain each round, and each kernel alone
    (``ms_kernel``), one value a round, beside its bounds."""
    inp = smoke.triangle_inputs(torch, device, 256, torch.float32, seed=7)
    t = {"plain_ms": [], "ms": []}
    kernels = {k: [] for k in smoke.TRI_KERNELS}

    def run(plain):
        return smoke.time_ms(torch, lambda: smoke.triangle_call(
            tri, inp, False, plain=plain), reps)
    for _ in range(rounds):
        for key, plain in (("plain_ms", True), ("ms", False), ("ms", False),
                           ("plain_ms", True)):
            t[key].append(run(plain))
        for k, ms in kernels.items():
            ms.append(smoke.triangle_kernel_ms(torch, tri, inp, k, reps))
    rows = [{"case": "triangle", "kernel": "geom_triangle",
             "dtype": "float32", **t}]
    for k, (prods, nbytes) in smoke.triangle_cost(256).items():
        b = smoke.bounds(prods, 0.0, nbytes)
        rows.append({"case": "triangle", "kernel": k, "dtype": "float32",
                     "ms_kernel": kernels[k], "bound_ms": b["tc_bound_ms"],
                     "bound_by": b["tc_bound_by"],
                     "gflop_products": prods / 1e9, "mb": nbytes / 1e6})
    return rows


def triangle_view_timings(smoke, tri, device, rounds: int, reps: int
                          ) -> list:
    """The single-view route at the release shapes, float32, each view:
    ``plain_ms`` (its einsums) and ``ms`` (the route), plain, route,
    route, plain each round, beside its bound."""
    inp = smoke.triangle_view_inputs(torch, device, 256, seed=7)
    prods, nbytes = smoke.triangle_view_cost(256)
    b = smoke.bounds(prods, 0.0, nbytes)
    rows = []
    for view in (0, 1):
        t = {"plain_ms": [], "ms": []}
        for _ in range(rounds):
            for key, plain in (("plain_ms", True), ("ms", False),
                               ("ms", False), ("plain_ms", True)):
                t[key].append(smoke.time_ms(torch, lambda: (
                    smoke.triangle_view_call(tri, inp, view, plain)), reps))
        rows.append({"case": "triangle-view", "kernel": "geom_triangle_view",
                     "view": view, "dtype": "float32", **t,
                     "bound_ms": b["tc_bound_ms"],
                     "bound_by": b["tc_bound_by"],
                     "gflop_products": prods / 1e9, "mb": nbytes / 1e6})
    return rows


def triangle_outputs(smoke, device) -> dict:
    """{"geom_triangle label dtype": output} of the two-view route at
    phase 2c's cases (``TRI_CASES``), on phase 2c's inputs; none for a
    package without the route."""
    try:
        tri = importlib.import_module("dynamicpdb_tpu_torch.ops.geom_triangle")
    except ImportError:
        return {}
    out = {}
    for label, L, rows, masked, pad_safe in smoke.TRI_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            inp = smoke.triangle_inputs(
                torch, device, L, dtype, 60 + L + (dtype == torch.bfloat16),
                rows=rows, masked=masked)
            out[f"geom_triangle {label} {str(dtype)[6:]}"] = (
                smoke.triangle_call(tri, inp, pad_safe, plain=False).cpu())
    return out


def kernel_outputs(smoke, mod, device) -> dict:
    """{"kind label dtype": output} at phase 2b's square cases and at its
    rectangular and short cases (GEOM_RECT_CASES), on phase 2b's inputs,
    and the two-view triangle route's (``triangle_outputs``)."""
    out = triangle_outputs(smoke, device)
    for kind in smoke.GEOM_SHAPES:
        for label, L, pad, B, prefix in smoke.GEOM_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                inp = smoke.geom_inputs(
                    torch, device, kind, L, dtype,
                    seed=L + (dtype == torch.bfloat16), pad=pad,
                    B=B if kind == "geom_attention" else None,
                    masked_prefix=prefix)
                out[f"{kind} {label} {str(dtype)[6:]}"] = smoke.geom_call(
                    mod, kind, inp, plain=False).cpu()
    for label, kind, L, rows, B in smoke.GEOM_RECT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            inp = smoke.geom_inputs(
                torch, device, kind, L, dtype,
                seed=40 + L + (dtype == torch.bfloat16), B=B, rows=rows,
                masked_suffix=smoke.GEOM_RECT_MASKED)
            out[f"{kind} {label} {str(dtype)[6:]}"] = smoke.geom_call(
                mod, kind, inp, plain=False).cpu()
    return out


# --ablate: copies of node_attention's kernel with one part removed (edits
# of the source text, bench_ipa.ablated_source), timed alone at ABLATE_CASE
# in each instance. The copies compute wrong results; they are timed, never
# checked.
_ZERO_ACC = "for (auto& a : acc) for (auto& b : a) for (float& e : b) e = 0.f;"
_NO_QG = (("    project<T, kRows, kMT, kC2, PP>(acc, xg, q0 + row0, "
           "min(q0 + Lq, L), d,\n"
           "                                    wqg + gi * kC2, G * kC2, "
           "stage);", "    " + _ZERO_ACC),)
_NO_KV = (("      project<T, kChunk, kKvMT, kKvWN, PP>(acc, xg, kc0, L, d,\n"
           "                                           wkv + gi * kC2, "
           "G * kC2, stage);", "      " + _ZERO_ACC + "\n      __syncthreads();"),)
# the bias fetches and the 32-key steps of every chunk (with them go q's
# split and the q columns of the q|gate product, which nothing reads then)
_NO_STEPS = (("        sMask[tid] = kc0 + tid < L ? "
              "kmask[(size_t)b * L + kc0 + tid] : 0.f;\n    }\n",
              "@@cut_start"),
             ("    // the next chunk's project() starts with a barrier",
              "@@cut_end"))
ABLATIONS = {
    "all": (),
    "no q|gate projection": _NO_QG,
    "no k|v projection": _NO_KV,
    "no attention steps": _NO_STEPS,
}
ABLATE_CASE = "rows-128-255"


def ablation(smoke, mod, device, rounds: int, reps: int) -> dict:
    """{(variant, tile rows): [ms alone per round]} of node_attention at
    ABLATE_CASE, float32, each variant of ABLATIONS in each instance."""
    from dynamicpdb_tpu_torch.ops import _build

    if __package__:
        from .bench_ipa import ablated_source
    else:  # run as a script
        from bench_ipa import ablated_source

    src = open(os.path.join(_build.CSRC_DIR, "geom_attention.cu")).read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ablate_geom_", dir=_build.BUILD_DIR)
    try:
        for rel in _build.sources("geom_attention")[1:]:
            shutil.copy(os.path.join(_build.CSRC_DIR, rel), work)
        procs = {}
        for i, (name, edits) in enumerate(ABLATIONS.items()):
            cu = os.path.join(work, f"v{i}.cu")
            with open(cu, "w") as f:
                f.write(ablated_source(src, edits))
            so = os.path.join(work, f"libv{i}.so")
            procs[name] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"ablation {name}: nvcc failed:\n{log}")
            libs[name] = mod._typed(ctypes.CDLL(so))
        (kind, inp), = case_inputs(smoke, device, ABLATE_CASE, torch.float32)
        times = {(name, rows): [] for name in libs for rows in mod.TILE_ROWS}
        for _ in range(rounds):
            for name, lib in libs.items():
                variant = types.SimpleNamespace(
                    _lib=lambda lib=lib: lib, kernel_inputs=mod.kernel_inputs,
                    launch=mod.launch)
                for rows in mod.TILE_ROWS:
                    times[(name, rows)].append(smoke.geom_kernel_ms(
                        torch, variant, kind, inp, reps, rows=rows))
        return times
    finally:
        shutil.rmtree(work, ignore_errors=True)


def precision(smoke, mod, device) -> list[dict]:
    out = []
    c, scale = smoke.GEOM_C, smoke.GEOM_C ** -0.5
    for kind in smoke.GEOM_SHAPES:
        inp = smoke.geom_inputs(torch, device, kind, 256, torch.float32,
                                seed=5, B=2)
        got = smoke.geom_call(mod, kind, inp, plain=False).float()
        plain = smoke.geom_call(mod, kind, inp, plain=True).float()
        x, bias, kmask = inp["x"], inp["bias"], inp["kmask"]
        if kind == "node_attention":
            x, bias = x[:, None], bias[None]
            got, plain = got[:, None], plain[:, None]
        w = [inp[k] for k in ("qg_w", "qg_b", "kv_w", "kv_b")]

        def emulate(mm, dtype=torch.float32):
            return gated_attention_mm(
                x.to(dtype), *(t.to(dtype) for t in w), bias.to(dtype), c,
                scale, mm, None if kmask is None else kmask.to(dtype))

        exact = emulate(lambda a, b: a @ b, torch.float64)
        rows = {"kernel": got, "plain": plain,
                "nearest": emulate(mm_3xtf32),
                "toward_zero": emulate(lambda a, b: mm_3xtf32(
                    a, b, accumulate="toward_zero"))}
        errs = {name: float((t.double() - exact).abs().max())
                for name, t in rows.items()}
        # signed drift of the kernel and of each emulation from float64,
        # along the exact value's sign: < 0 means magnitudes come out small
        drift = {name: float(((t.double() - exact) * exact.sign()).mean())
                 for name, t in rows.items()}
        out.append({"kernel": kind, "max_abs_err_vs_float64": errs,
                    "mean_signed_err_vs_float64": drift,
                    "kernel_vs_plain": float((got - plain).abs().max())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT,
                    help="directory holding the dynamicpdb_tpu_torch to time")
    ap.add_argument("--case", nargs="+", choices=CASES, default=["release"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--save-outputs", metavar="FILE")
    ap.add_argument("--compare-outputs", metavar="FILE")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_geom: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.ablate and os.path.abspath(args.package) != ROOT:
        print("bench_geom: --ablate edits this checkout's kernel; run it "
              "without --package", file=sys.stderr)
        return 1
    smoke, mod = _load(args.package)
    card = smoke.card_line()
    device = torch.device("cuda")
    label = os.path.relpath(os.path.abspath(args.package), ROOT)
    geom_cases = [c for c in args.case
                  if c not in ("triangle", "triangle-view")]
    if geom_cases:
        for row in timings(smoke, mod, device, args.rounds, args.reps,
                           geom_cases):
            print(json.dumps({"package": label, "card": card, **row}))
    if "triangle" in args.case:
        tri = importlib.import_module("dynamicpdb_tpu_torch.ops.geom_triangle")
        for row in triangle_timings(smoke, tri, device, args.rounds,
                                    args.reps):
            print(json.dumps({"package": label, "card": card, **row}))
    if "triangle-view" in args.case:
        tri = importlib.import_module("dynamicpdb_tpu_torch.ops.geom_triangle")
        for row in triangle_view_timings(smoke, tri, device, args.rounds,
                                         args.reps):
            print(json.dumps({"package": label, "card": card, **row}))
    if args.save_outputs:
        torch.save(kernel_outputs(smoke, mod, device), args.save_outputs)
    if args.compare_outputs:
        got = kernel_outputs(smoke, mod, device)
        want = torch.load(args.compare_outputs, weights_only=True)
        print(json.dumps({"package": label, "card": card,
                          "against": args.compare_outputs,
                          "bit_identical": {k: bool(k in got and torch.equal(
                              got[k], w)) for k, w in want.items()},
                          "max_abs_diff": {k: float((got[k].float()
                                                     - w.float()).abs().max())
                                           for k, w in want.items()
                                           if k in got}}))
    if args.precision:
        for row in precision(smoke, mod, device):
            print(json.dumps({"package": label, "card": card, **row}))
    if args.ablate:
        for (name, rows), t in ablation(smoke, mod, device, args.rounds,
                                        args.reps).items():
            print(json.dumps({"package": label, "card": card,
                              "kernel": "node_attention",
                              "case": ABLATE_CASE, "tile_rows": rows,
                              "without": name, "ms_kernel": t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
