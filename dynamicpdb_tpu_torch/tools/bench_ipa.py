"""Time the IPA forward and backward kernels on the card, and measure where
their float32 error comes from.

    python dynamicpdb_tpu_torch/tools/bench_ipa.py [--package DIR] \
        [--case {release,wide-model,wide}] [--rounds 3] [--reps 50] \
        [--library [{square,rect}]] [--precision] [--ablate [KERNEL]]

Times the IPA forward and the three kernels of its backward (dq, dk/dv,
pair) at ``--case``'s shapes: "release" (F=2, N=256, H=8, C=256, Pq=8,
Pv=12, Dz=32, last 56 residues masked: the tensor-core kernels,
``csrc/ipa_attention_fwd.cu``, ``csrc/ipa_attention_bwd.cu``),
"wide-model" (C=384, Pq=12, Dz=64 on the same window,
``chip_smoke.WIDE_MODEL_CASE``) or "wide" (N=203, H=4, C=384, Pq=12,
Pv=18, Dz=64, ``chip_smoke.WIDE_CASE``), where each wrapper runs the
kernel its route gives it (``ops.ipa_attention.kernel_route``: the wide
tensor-core kernels; a package without a wrapper's wide tensor-core
kernel runs its CUDA-core one).
Each through its public wrapper (``ms``) and alone (``ms_kernel``, outputs
allocated once, ``chip_smoke.ipa_kernel_ms``), in ``--rounds`` interleaved
rounds of ``--reps`` launches (CUDA events, inputs warm in L2); one JSON
line per kernel, naming its route and launcher. Inputs, timer and loader
are ``chip_smoke.py``'s and ``tools/bench_geom.py``'s, from this checkout.

``--package DIR`` times the ``dynamicpdb_tpu_torch`` package under DIR
instead of this checkout's, so that two versions of the kernels can be
timed on one card in one run: run this script (as a script, not with
``-m``) once against each, e.g. parent, change, change, parent.

``--ablate [KERNEL]`` builds copies of this checkout's kernel KERNEL (a
launcher: ``ipa_attention_fwd``, the default, ``ipa_attention_bwd_dkv``,
``ipa_attention_bwd_pair``, ``ipa_attention_wide_tc_fwd``,
``ipa_attention_wide_tc_bwd_dq``, ``ipa_attention_wide_tc_bwd_dkv`` or
``ipa_attention_wide_tc_bwd_pair``) with one part of its loop removed
(``ABLATIONS``: for the forwards the pair-stream loop, all pair_z work,
p.v, q.k^T, the point distances, p.vp, the key fetches after the first,
loads alone, math alone; for the backward kernels the key or row fetches
after the first, the pair_z refetches, the tile's products, the
accumulation products (dq, dk and dv, the point sums), the pair term, the
dpz update, math alone) and times each alone, interleaved with the whole
kernel, at ``--case`` (default: "wide-model" for the wide kernels,
"release" for the others): where the kernel's time goes. The copies
compute wrong results; they are timed, never checked. The edits are made on
the source text and fail loudly when the kernel no longer has the lines
they expect.

``--save-outputs FILE`` writes the four kernels' outputs at the timed
inputs of ``--case`` (the forward's o, o_pt, o_pair and lse; dq, dqp, dhw rows; dk,
dkp, dv, dvp; dbias, dpz) to FILE; ``--compare-outputs FILE`` computes
them again and prints, per output, whether it equals FILE's bit for bit
and its largest difference: run the parent with the first and this
checkout with the second to show that a change left the kernels'
arithmetic as it was.

``--library`` times the library call beside the kernels at the same
inputs (any ``--case``): torch's ``scaled_dot_product_attention`` on the same logits
(``sdpa_operands``: the points folded into the dot product, q|qp . k|kp,
the pair bias and the two norm terms with the mask as a float
``attn_mask``, v|vp as the values), its forward for the forward kernel's
o and o_pt (o_pair has no library call) and its one backward call (dq, dk,
dv of those operands) for the dq and dk/dv kernels (the pair kernel has
none). Its outputs are held against the plain version's o and o_pt first.
``--library rect`` makes the call rectangular, as sequence parallelism
makes the kernels': query rows ``chip_smoke.RECT_ROWS`` (128-255) of the
window against all its keys, the float mask built from the query rows'
mask and the keys' mask.

``--precision`` runs the four kernels in float32 at ``--case``'s widths
(release unless stated) with one frame and two heads, and holds them, the float32 plain versions and the
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
import types

import torch

if __package__:
    from . import bench_geom
else:  # run as a script
    import bench_geom

KERNELS = ("ipa_attention_fwd", "ipa_attention_bwd_dq",
           "ipa_attention_bwd_dkv", "ipa_attention_bwd_pair")
C_B, INF = math.sqrt(1.0 / 3), 1e5
CASES = ("release", "wide-model", "wide")


def case_shape(smoke, case: str) -> dict:
    """``chip_smoke.ipa_inputs``' keywords of ``case`` (CASES)."""
    return {"release": {}, "wide-model": smoke.WIDE_MODEL_CASE,
            "wide": smoke.WIDE_CASE}[case]


def route_launcher(mod, fn: str, shape: dict) -> tuple[str, str]:
    """(route, launcher) of wrapper ``fn`` of package ``mod`` at ``shape``'s
    widths (release unless stated)."""
    w = dict(dict(C=256, Pq=8, Pv=12, Dz=32), **shape)
    route = mod.kernel_route(fn, w["C"], 3 * w["Pq"], 3 * w["Pv"], w["Dz"])
    prefix = {"tc": "ipa_attention_", "wide_tc": "ipa_attention_wide_tc_",
              "wide": "ipa_attention_wide_"}[route]
    return route, fn.replace("ipa_attention_", prefix)


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


def _a_dl(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
          lse, dvec, g_o, g_opt, g_pair, c_qk, mm):
    """The backward kernels' tile recompute on the 15 backward inputs
    (``ops.ipa_attention.backward_inputs``): a and dl [F, H, N, N] with
    q.k^T, qp.kp^T, g_o.v^T and g_opt.vp^T through ``mm``, the pair term in
    plain sums."""
    l = _logits(q, k, q_pts, k_pts, bias, mask, head_weights, c_qk, mm)
    a = torch.exp(l - lse[..., None])
    ds = (mm(_heads(g_o), _heads(v).transpose(-1, -2))
          + mm(_heads(g_opt), _heads(v_pts).transpose(-1, -2))
          + torch.einsum("fihd,ijd->fhij", g_pair, pair_z))
    return a, a * (ds - dvec[..., None])


def ipa_dq_mm(*inputs, c_qk, mm):
    """The dq kernel's arithmetic: the recompute, then dl.k through ``mm``.
    Returns dq [F, N, H, C]."""
    _, dl = _a_dl(*inputs, c_qk, mm)
    return (c_qk * mm(dl, _heads(inputs[1]))).transpose(1, 2)


def ipa_dkv_mm(*inputs, c_qk, mm):
    """The dk/dv kernel's arithmetic: the recompute, then dl^T.q, dl^T.qp,
    a^T.g_o and a^T.g_opt through ``mm``. Returns (dk, dkp, dv, dvp) in the
    layouts of k, k_pts, v, v_pts (points flattened)."""
    q, k_pts, q_pts, hw = inputs[0], inputs[4], inputs[3], inputs[9]
    g_o, g_opt = inputs[12], inputs[13]
    a, dl = _a_dl(*inputs, c_qk, mm)
    a_t, dl_t = a.transpose(-1, -2), dl.transpose(-1, -2)
    colsum = dl.sum(-2)[..., None]  # [F, H, N, 1] over query rows
    dk = c_qk * mm(dl_t, _heads(q))
    dkp = -hw[None, :, None, None] * (colsum * _heads(k_pts)
                                      - mm(dl_t, _heads(q_pts)))
    dv = mm(a_t, _heads(g_o))
    dvp = mm(a_t, _heads(g_opt))
    return tuple(t.transpose(1, 2) for t in (dk, dkp, dv, dvp))


def ipa_pair_mm(*inputs, c_qk, mm):
    """The pair kernel's arithmetic: the recompute, then dbias = c_b sum_f dl
    and dpz = sum_{f,h} a g_pair in plain sums. Returns (dbias [N, N, H],
    dpz [N, N, Dz])."""
    a, dl = _a_dl(*inputs, c_qk, mm)
    return (C_B * dl.sum(0).permute(1, 2, 0),
            torch.einsum("fhij,fihd->ijd", a, inputs[14]))


def precision_inputs(smoke, device, dtype=torch.float32, **widths):
    """Release widths unless ``widths`` (``chip_smoke.ipa_inputs``' C, Pq,
    Pv, Dz) say otherwise, F = 1, H = 2, N = 256, last 56 residues masked:
    the forward's inputs in ``dtype``, and the backward kernels' 15 inputs
    with seeded cotangents zero on pad rows, lse and D from the float64
    forward (so that every gradient below starts from the same values)."""
    args, c_qk = smoke.ipa_inputs(torch, device, F=1, H=2, seed=0, **widths)
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


NAMES = ("o", "o_pt", "o_pair", "dq", "dk", "dkp", "dv", "dvp", "dbias",
         "dpz")
REAL_ROWS = ("o", "o_pt", "o_pair", "dq")  # compared on real query rows


def emulate(mm, fwd_args, bwd_inputs, c_qk):
    """The outputs of ``NAMES`` with every product through ``mm``."""
    kw = dict(c_qk=c_qk, mm=mm)
    return (ipa_fwd_mm(*fwd_args, c_qk, mm)
            + (ipa_dq_mm(*bwd_inputs, **kw),)
            + ipa_dkv_mm(*bwd_inputs, **kw) + ipa_pair_mm(*bwd_inputs, **kw))


def errors_vs_float64(fwd_args, bwd_inputs, c_qk, results: dict) -> dict:
    """{scheme: {output: max abs error against float64}} for each scheme's
    outputs of ``NAMES`` in ``results`` (points flattened): those of
    ``REAL_ROWS`` on real query rows, the key-side and pair gradients over
    all their rows; and "scale": each float64 output's largest magnitude."""
    real = fwd_args[8].bool()[..., None, None]  # [F, N, 1, 1]
    exact = emulate(lambda a, b: a @ b, [a.double() for a in fwd_args],
                    [t.double() for t in bwd_inputs], c_qk)
    out = {"scale": {n: float(e.abs().max()) for n, e in zip(NAMES, exact)}}
    for scheme, got in results.items():
        out[scheme] = {n: float(((g.double() - e)
                                 * (real if n in REAL_ROWS else 1)).abs().max())
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
def timings(smoke, mod, device, rounds: int, reps: int,
            shape: dict) -> list[dict]:
    args, c_qk = smoke.ipa_inputs(torch, device, seed=20, **shape)
    inputs, _ = smoke.ipa_bwd_inputs(torch, args, c_qk, zero_pad=False,
                                     seed=4)
    kw = dict(c_qk=c_qk, c_b=C_B, inf=INF)
    calls = {"ipa_attention_fwd": (args, lambda: mod.ipa_attention_fwd(
        *args, c_qk))}
    for kind in KERNELS[1:]:
        calls[kind] = (inputs, functools.partial(getattr(mod, kind), *inputs,
                                                 **kw))
    routes = {k: route_launcher(mod, k, shape) for k in KERNELS}
    times = {k: {"ms_kernel": [], "ms": []} for k in KERNELS}
    for _ in range(rounds):
        for kind in KERNELS:
            operands, call = calls[kind]
            times[kind]["ms_kernel"].append(smoke.ipa_kernel_ms(
                torch, mod, routes[kind][1], operands, c_qk, reps))
            times[kind]["ms"].append(smoke.time_ms(torch, call, reps))
    return [{"kernel": k, "route": routes[k][0], "launcher": routes[k][1],
             **t} for k, t in times.items()]


def sdpa_operands(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                  head_weights, c_qk, c_b=C_B, inf=INF, key_mask=None):
    """The forward's logits as one scaled dot product: q' = [sqrt(c_qk) q |
    sqrt(w_h) qp], k' likewise (q'.k' = c_qk q.k + w_h qp.kp), the float
    mask c_b bias - w_h (|qp|^2 + |kp|^2) / 2 + inf (m_i m_j - 1), values
    [v | vp]; each [F, H, rows, .] (the mask [F, H, Nq, Nk]), with scale
    1. ``key_mask`` [F, Nk]: a rectangular call's (None: ``mask`` for
    both)."""
    key_mask = mask if key_mask is None else key_mask
    sw = head_weights.sqrt()[None, None, :, None]
    qp, kp = q_pts.flatten(-2), k_pts.flatten(-2)
    q2 = torch.cat([q * math.sqrt(c_qk), qp * sw], -1).transpose(1, 2)
    k2 = torch.cat([k * math.sqrt(c_qk), kp * sw], -1).transpose(1, 2)
    v2 = torch.cat([v, v_pts.flatten(-2)], -1).transpose(1, 2)
    hw = head_weights[None, :, None]
    qn = (-0.5 * hw * qp.pow(2).sum(-1).transpose(1, 2))[..., :, None]
    kn = (-0.5 * hw * kp.pow(2).sum(-1).transpose(1, 2))[..., None, :]
    m = inf * (mask[:, :, None] * key_mask[:, None, :] - 1.0)
    attn = c_b * bias.permute(2, 0, 1)[None] + qn + kn + m[:, None]
    return (q2.contiguous(), k2.contiguous(), v2.contiguous(),
            attn.contiguous())


def sdpa_outputs(operands, C: int):
    """(o [F, N, H, C], o_pt [F, N, H, Pv, 3]) of the library call."""
    q2, k2, v2, attn = operands
    out = torch.nn.functional.scaled_dot_product_attention(
        q2, k2, v2, attn_mask=attn, scale=1.0).transpose(1, 2)
    return out[..., :C], out[..., C:].unflatten(-1, (-1, 3))


def library_inputs(smoke, device, shape: dict, rect: bool):
    """(forward inputs, key mask, c_qk) at ``timings``' inputs; ``rect``:
    the query side cut to rows ``smoke.RECT_ROWS``, the keys whole."""
    args, c_qk = smoke.ipa_inputs(torch, device, seed=20, **shape)
    if not rect:
        return args, args[8], c_qk
    args, key_mask = smoke.rect_block(args, smoke.RECT_ROWS)
    return args, key_mask, c_qk


def library_timings(smoke, device, rounds: int, reps: int, shape: dict,
                    rect: bool = False) -> list[dict]:
    """The SDPA call's forward and its one backward at ``timings``'
    inputs (``rect``: rows ``smoke.RECT_ROWS`` against every key), after
    holding its o and o_pt against the plain version's."""
    args, key_mask, c_qk = library_inputs(smoke, device, shape, rect)
    C = args[0].shape[-1]
    from dynamicpdb_tpu_torch.ops.ipa_attention import ipa_attention_plain

    operands = sdpa_operands(*args, c_qk, key_mask=key_mask)
    o, o_pt = sdpa_outputs(operands, C)
    want = ipa_attention_plain(*args, c_qk, key_mask=key_mask)
    real = args[8].bool()  # the real query rows
    errs = [float((got - w)[real].abs().max())
            for got, w in ((o, want[0]), (o_pt, want[1]))]
    leaves = [t.detach().requires_grad_(True) for t in operands[:3]]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=operands[3], scale=1.0)
    g = torch.randn(out.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(5))

    def backward():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    fwd = [smoke.time_ms(torch, lambda: sdpa_outputs(operands, C), reps)
           for _ in range(rounds)]
    bwd = [smoke.time_ms(torch, backward, reps) for _ in range(rounds)]
    call = (f"rows {smoke.RECT_ROWS[0]}-{smoke.RECT_ROWS[1] - 1} against "
            f"{args[1].shape[1]} keys" if rect else "square")
    return [{"library": "scaled_dot_product_attention forward (o, o_pt)",
             "call": call, "for": ["ipa_attention_fwd"], "ms": fwd,
             "max_abs_err_vs_plain": errs},
            {"library": "scaled_dot_product_attention backward (dq, dk, dv)",
             "call": call,
             "for": ["ipa_attention_bwd_dq", "ipa_attention_bwd_dkv"],
             "ms": bwd}]


def kernel_outputs(smoke, mod, device, shape: dict) -> dict:
    """The four kernels' outputs at ``timings``' inputs, on the host."""
    args, c_qk = smoke.ipa_inputs(torch, device, seed=20, **shape)
    inputs, _ = smoke.ipa_bwd_inputs(torch, args, c_qk, zero_pad=False,
                                     seed=4)
    kw = dict(c_qk=c_qk, c_b=C_B, inf=INF)
    names = {"ipa_attention_fwd": ("o", "o_pt", "o_pair", "lse"),
             "ipa_attention_bwd_dq": ("dq", "dqp", "dhw_rows"),
             "ipa_attention_bwd_dkv": ("dk", "dkp", "dv", "dvp"),
             "ipa_attention_bwd_pair": ("dbias", "dpz")}
    out = {}
    for kind, outs in names.items():
        got = (mod.ipa_attention_fwd(*args, c_qk) if kind == KERNELS[0]
               else getattr(mod, kind)(*inputs, **kw))
        out.update({n: t.cpu() for n, t in zip(outs, got)})
    return out


def precision(smoke, mod, device, shape: dict) -> dict:
    widths = {k: v for k, v in shape.items() if k in ("C", "Pq", "Pv", "Dz")}
    fwd_args, bwd_inputs, c_qk = precision_inputs(smoke, device, **widths)
    o, o_pt, o_pair, _ = mod.ipa_attention_fwd(*fwd_args, c_qk)
    kw = dict(c_qk=c_qk, c_b=C_B, inf=INF)
    dq = mod.ipa_attention_bwd_dq(*bwd_inputs, **kw)[0]
    results = {name: emulate(mm, fwd_args, bwd_inputs, c_qk)
               for name, mm in emulations().items()}
    results["kernel"] = ((o, o_pt.flatten(3), o_pair, dq)
                         + mod.ipa_attention_bwd_dkv(*bwd_inputs, **kw)
                         + mod.ipa_attention_bwd_pair(*bwd_inputs, **kw))
    return errors_vs_float64(fwd_args, bwd_inputs, c_qk, results)


# each kernel's loop, part by part: (anchor, replacement) edits of its source
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
_ZERO_X = "      for (int e = 0; e < 8; ++e) x[e >> 2][e & 3] = 0.f;\n"
_DKV_NO_ROWS = (("i0 + kStep, j0,\n                   step + 1 < n_steps, L);",
                 "i0 + kStep, j0,\n                   false, L);"),)
_DKV_NO_PZ = (
    ("      if (step + 1 < n_steps)\n        fetch_pz_keys(spz, in.pz, "
     "i0 + kStep, j0 + k0 + 8 * rr, L);", ""),
    ("    if (pair_warp)\n      cp_async_wait<1>();\n    else\n      "
     "cp_async_wait<0>();\n    __syncthreads();\n    fetch_row_step(",
     "    cp_async_wait<0>();\n    __syncthreads();\n    fetch_row_step("))
_DKV_NO_TILE = (("          rs.q, col, L);\n", "          rs.q, col, L);\n"
                 + _ZERO_X),
                ("          rs.go, col, L);\n", "          rs.go, col, L);\n"
                 + _ZERO_X))
_DKV_NO_DKDV = (("        mma3(dka[n], dh[ks], dlo[ks], bh, bl);", ""),
                ("        mma3(dva[n], ah[ks], alo[ks], bh, bl);", ""))
_PAIR_NO_RELOAD = (("                        if (more) load_q(", "                        if (0) load_q("),
                   ("    if (more) load_small(it + 1);", ""))
_PAIR_NO_FETCH = (("    fetch(it + 1, it + 1 < n_it);",
                   "    fetch(it + 1, false);"),)
_PAIR_NO_DPZ = (("          dpa[n][e][m] = fmaf(a[n][e], gq[e >> 1][m], "
                 "dpa[n][e][m]);", "          ;"),)
# the same parts of the wide tensor-core forward and pair kernel
_W_SKIP_PAIR_LOOP = (
    ("      cp_async_wait<1>();  // this step's pair_z (the next key tile may "
     "wait)\n      __syncwarp();\n", "@@cut_start"),
    ("      __syncwarp();  // every lane has read the rows", "@@cut_end"))
_W_SKIP_PZ = (
    ("  if (pair_warp) fetch_pz(spz, pz, i0 + 8 * rr, 0, c0, L);", ""),
    ("      if (step + 1 < n_steps)\n        fetch_pz(spz, pz, i0 + 8 * rr, "
     "j0 + kKeys, c0, L);", ""),
    ("    if (pair_warp)\n      cp_async_wait<1>();\n    else\n      "
     "cp_async_wait<0>();", "    cp_async_wait<0>();"))
_W_SKIP_DIST = (("      point_dist(dist, qpa, qsq, s.c.ksq, kt);",
                 "      for (int e = 0; e < 8; ++e) dist[e >> 2][e & 3] = 0.f;"),)
_W_SKIP_FETCH = (("                   f, h, i0, j0 + kKeys, step + 1 < n_steps, "
                  "L);", "                   f, h, i0, j0 + kKeys, false, L);"),)
_WP_NO_TILE = (("        kt.k, col, L);\n    read(0);\n",
                "        kt.k, col, L);\n" + _ZERO_X + "    read(0);\n"),
               ("        kt.v, col, L);\n    read(1);\n",
                "        kt.v, col, L);\n" + _ZERO_X + "    read(1);\n"))
_WP_NO_PAIR_TERM = (("        a = fmaf(gp[m], z[jj * kMaxDz + 4 * m], a);",
                     "        ;"),)
# the wide tensor-core dq and dk/dv kernels
_WQ_NO_FETCH = (("                   in.kmask, in.bias, f, h, i0, j0 + kKeys,\n"
                 "                   step + 1 < n_steps, L);",
                 "                   in.kmask, in.bias, f, h, i0, j0 + kKeys,\n"
                 "                   false, L);"),)
_WQ_NO_PZ = (("      if (step + 1 < n_steps)\n        fetch_pz(spz, in.pz, "
              "i0 + 8 * rr, j0 + kKeys, c0, L);", ""),)
_WQ_NO_TILE = (("          kt.k, col, L);\n      xput(s.c.xch, kQK + w, x);",
                "          kt.k, col, L);\n" + _ZERO_X
                + "      xput(s.c.xch, kQK + w, x);"),
               ("          kt.v, col, L);\n      xput(s.c.xch, kGV + w, x);",
                "          kt.v, col, L);\n" + _ZERO_X
                + "      xput(s.c.xch, kGV + w, x);"))
_WQ_NO_ACC = (("        mma3(acc[n], dh[ks], dlo[ks], bh, bl);", ""),
              ("          mma3(pts[n], dh[ks], dlo[ks], bh, bl);", ""))
_WQ_NO_PAIR_TERM = (("        for (int m = 0; m < 8; ++m) a = fmaf(gp[m], "
                     "z[jj * 32 + 4 * m], a);", ""),)
_WK_NO_ROWS = (("i0 + kRows, j0,\n                   step + 1 < n_steps, L);",
                "i0 + kRows, j0,\n                   false, L);"),)
_WK_NO_PZ = (("      if (step + 1 < n_steps)\n        fetch_pz_keys(spz, in.pz, "
              "i0 + kRows, j0 + 8 * rr, 32 * half, L);", ""),)
_WK_NO_TILE = (("          rs.q, col, L);\n      xput(s.xch, kQK + w, x);",
                "          rs.q, col, L);\n" + _ZERO_X
                + "      xput(s.xch, kQK + w, x);"),
               ("          rs.go, col, L);\n      xput(s.xch, kGV + w, x);",
                "          rs.go, col, L);\n" + _ZERO_X
                + "      xput(s.xch, kGV + w, x);"))
_WK_NO_ACC = _DKV_NO_DKDV + (
    ("          mma3(pacc[n], dh[ks], dlo[ks], bh, bl);", ""),
    ("          mma3(pacc[n], ah[ks], alo[ks], bh, bl);", ""))
_WK_NO_PAIR_TERM = (("            acc = fmaf(p.x, q.x, acc);\n"
                     "            acc = fmaf(p.y, q.y, acc);\n"
                     "            acc = fmaf(p.z, q.z, acc);\n"
                     "            acc = fmaf(p.w, q.w, acc);\n", ""),)
ABLATIONS = {
    "ipa_attention_wide_tc_bwd_dq": {
        "all": (),
        "no key fetch after the first": _WQ_NO_FETCH,
        "no pair_z refetch": _WQ_NO_PZ,
        "math only": _WQ_NO_FETCH + _WQ_NO_PZ,
        "no q.k^T, g_o.v^T": _WQ_NO_TILE,
        "no dq, dl.kp products": _WQ_NO_ACC,
        "no pair term": _WQ_NO_PAIR_TERM,
    },
    "ipa_attention_wide_tc_bwd_dkv": {
        "all": (),
        "no row-step fetch after the first": _WK_NO_ROWS,
        "no pair_z refetch": _WK_NO_PZ,
        "math only": _WK_NO_ROWS + _WK_NO_PZ,
        "no k.q^T, v.g_o^T": _WK_NO_TILE,
        "no dk, dv, point products": _WK_NO_ACC,
        "no pair term": _WK_NO_PAIR_TERM,
    },
    "ipa_attention_wide_tc_fwd": {
        "all": (),
        "no pair-stream loop": _W_SKIP_PAIR_LOOP,
        "no pair_z work": _W_SKIP_PAIR_LOOP + _W_SKIP_PZ,
        "no p.v": _SKIP_PV,
        "no q.k^T": _SKIP_QK,
        "no point distances": _W_SKIP_DIST,
        "no p.vp": _SKIP_PT,
        "no key fetch after the first": _W_SKIP_FETCH,
        "loads only": (_W_SKIP_PAIR_LOOP + _SKIP_PV + _SKIP_QK + _W_SKIP_DIST
                       + _SKIP_PT),
        "math only": _W_SKIP_FETCH + _W_SKIP_PAIR_LOOP + _W_SKIP_PZ,
    },
    "ipa_attention_wide_tc_bwd_pair": {
        "all": (),
        "no q, g_o reload": _PAIR_NO_RELOAD,
        "no key-tile fetch after the first": _PAIR_NO_FETCH,
        "math only": _PAIR_NO_RELOAD + _PAIR_NO_FETCH,
        "no q.k^T, g_o.v^T": _WP_NO_TILE,
        "no pair term": _WP_NO_PAIR_TERM,
        "no dpz update": _PAIR_NO_DPZ,
    },
    "ipa_attention_fwd": {
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
    },
    "ipa_attention_bwd_dkv": {
        "all": (),
        "no row-step fetch after the first": _DKV_NO_ROWS,
        "no pair_z refetch": _DKV_NO_PZ,
        "math only": _DKV_NO_ROWS + _DKV_NO_PZ,
        "no k.q^T, v.g_o^T": _DKV_NO_TILE,
        "no dk, dv products": _DKV_NO_DKDV,
    },
    "ipa_attention_bwd_pair": {
        "all": (),
        "no q, g_o reload": _PAIR_NO_RELOAD,
        "no key-tile fetch after the first": _PAIR_NO_FETCH,
        "math only": _PAIR_NO_RELOAD + _PAIR_NO_FETCH,
        "no dpz update": _PAIR_NO_DPZ,
    },
}


def ablated_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation: the kernel no longer has {old!r}")
        if new == "@@cut_start":
            src = src.replace(old, old + "#if 0\n")
        elif new == "@@cut_end":
            src = src.replace(old, "#endif\n" + old)
        else:
            src = src.replace(old, new)
    return src


def ablation(smoke, device, rounds: int, reps: int, kind: str,
             shape: dict) -> dict:
    """{variant: [ms alone per round]} of launcher ``kind`` at ``shape``'s
    inputs."""
    from dynamicpdb_tpu_torch.ops import _build, ipa_attention

    lib_name = kind if kind.endswith("_fwd") else kind[:kind.rindex("_")]
    src = open(os.path.join(_build.CSRC_DIR, lib_name + ".cu")).read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ablate_", dir=_build.BUILD_DIR)
    try:
        for rel in _build.sources(lib_name)[1:]:
            shutil.copy(os.path.join(_build.CSRC_DIR, rel), work)
        procs = {}
        for i, (name, edits) in enumerate(ABLATIONS[kind].items()):
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
            libs[name] = ipa_attention._typed(ctypes.CDLL(so), lib_name)
        args, c_qk = smoke.ipa_inputs(torch, device, seed=20, **shape)
        operands = args
        if not kind.endswith("_fwd"):
            operands, _ = smoke.ipa_bwd_inputs(torch, args, c_qk,
                                               zero_pad=False, seed=4)
        times = {name: [] for name in libs}
        for _ in range(rounds):
            for name, lib in libs.items():
                variant = types.SimpleNamespace(
                    _lib=lambda _, lib=lib: lib,
                    input_shapes=ipa_attention.input_shapes)
                times[name].append(smoke.ipa_kernel_ms(
                    torch, variant, kind, operands, c_qk, reps))
        return times
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=bench_geom.ROOT,
                    help="directory holding the dynamicpdb_tpu_torch to time")
    ap.add_argument("--case", choices=CASES, default=None,
                    help="the shapes (default release; for --ablate of a "
                    "wide kernel, wide-model)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--library", nargs="?", const="square",
                    choices=("square", "rect"))
    ap.add_argument("--save-outputs", metavar="FILE")
    ap.add_argument("--compare-outputs", metavar="FILE")
    ap.add_argument("--ablate", nargs="?", const="ipa_attention_fwd",
                    choices=list(ABLATIONS), metavar="KERNEL")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ipa: torch sees no CUDA device", file=sys.stderr)
        return 1
    smoke, mod = bench_geom._load(args.package, "ipa_attention")
    card = smoke.card_line()
    device = torch.device("cuda")
    label = os.path.relpath(os.path.abspath(args.package), bench_geom.ROOT)
    case = args.case or ("wide-model" if "_wide" in (args.ablate or "")
                         else "release")
    shape = case_shape(smoke, case)
    head = {"package": label, "card": card, "case": case}
    for row in timings(smoke, mod, device, args.rounds, args.reps, shape):
        print(json.dumps({**head, **row}))
    if args.library:
        for row in library_timings(smoke, device, args.rounds, args.reps,
                                   shape, rect=args.library == "rect"):
            print(json.dumps({**head, **row}))
    if args.save_outputs:
        torch.save(kernel_outputs(smoke, mod, device, shape),
                   args.save_outputs)
    if args.compare_outputs:
        got = kernel_outputs(smoke, mod, device, shape)
        want = torch.load(args.compare_outputs, weights_only=True)
        print(json.dumps({**head, "against": args.compare_outputs,
                          "bit_identical": {k: bool(torch.equal(got[k], w))
                                            for k, w in want.items()},
                          "max_abs_diff": {k: float((got[k] - w).abs().max())
                                           for k, w in want.items()}}))
    if args.precision:
        print(json.dumps({**head, "max_abs_err_vs_float64":
                          precision(smoke, mod, device, shape)}))
    if args.ablate:
        for name, t in ablation(smoke, device, args.rounds, args.reps,
                                args.ablate, shape).items():
            print(json.dumps({**head, "kernel": args.ablate, "without": name,
                              "ms_kernel": t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
