"""Time the GeoFormer attention kernels on the card, and measure where their
float32 error comes from.

    python dynamicpdb_tpu_torch/tools/bench_geom.py [--package DIR] \
        [--rounds 3] [--reps 20] [--precision]

Times both kernels (``csrc/geom_attention.cu``) at their release shapes in
float32 and bfloat16, alone (operands prepared once by the wrapper's
``kernel_inputs``) and through their public wrappers, in ``--rounds``
interleaved rounds of ``--reps`` launches (CUDA events, inputs warm in L2),
and prints one JSON line per kernel and dtype. The inputs and the timer are
``chip_smoke.py``'s (``geom_inputs``, ``time_ms``), from this checkout.

``--package DIR`` times the ``dynamicpdb_tpu_torch`` package under DIR
instead of this checkout's, so that two versions of the kernels can be
timed on one card in one session: run this script (as a script, not with
``-m``) once against each, e.g. parent, change, change, parent.

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
import importlib
import importlib.util
import json
import os
import subprocess
import sys

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


def timings(smoke, mod, device, rounds: int, reps: int) -> list[dict]:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    inputs = {(kind, name): smoke.geom_inputs(torch, device, kind, 256, dt,
                                              seed=7)
              for kind in smoke.GEOM_SHAPES for name, dt in dtypes.items()}
    times = {key: {"ms_kernel": [], "ms": []} for key in inputs}
    for _ in range(rounds):
        for (kind, name), inp in inputs.items():
            t = times[(kind, name)]
            t["ms_kernel"].append(smoke.geom_kernel_ms(torch, mod, kind, inp,
                                                       reps))
            t["ms"].append(smoke.time_ms(
                torch, lambda: smoke.geom_call(mod, kind, inp, plain=False),
                reps))
    return [{"kernel": kind, "dtype": name, **t}
            for (kind, name), t in times.items()]


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
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--precision", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_geom: torch sees no CUDA device", file=sys.stderr)
        return 1
    smoke, mod = _load(args.package)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    label = os.path.relpath(os.path.abspath(args.package), ROOT)
    for row in timings(smoke, mod, device, args.rounds, args.reps):
        print(json.dumps({"package": label, "card": card, **row}))
    if args.precision:
        for row in precision(smoke, mod, device):
            print(json.dumps({"package": label, "card": card, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
