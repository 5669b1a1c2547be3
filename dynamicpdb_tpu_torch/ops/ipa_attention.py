"""Invariant Point Attention: the CUDA kernels, their plain versions, and
the autograd function that ties them together.

``ipa_attention`` is a ``torch.autograd.Function``, the counterpart of the
JAX custom VJP ``dynamicpdb_tpu/ops/pallas/ipa_attention.py:530
ipa_attention``. Its forward is ``ipa_attention_fwd``, which replaces the
Pallas kernel ``_ipa_attn_kernel`` (:39). Its backward computes the row
constant D with torch ops, as ``_ipa_attention_bwd`` (:563) does, then
runs three kernels that replace the Pallas backward kernels:

  ``ipa_attention_bwd_dq``   <- ``_bwd_dq_kernel`` (:259):   dq, dqp, dhw rows
  ``ipa_attention_bwd_dkv``  <- ``_bwd_dkv_kernel`` (:297):  dk, dkp, dv, dvp
  ``ipa_attention_bwd_pair`` <- ``_bwd_pair_kernel`` (:338): dbias, dpz

For CUDA tensors each wrapper launches its hand-written kernel
(``csrc/ipa_attention_fwd.cu``, ``csrc/ipa_attention_bwd.cu``, built by
``nvcc``, loaded with ``ctypes``); for CPU tensors it runs its plain
version, the same function in plain PyTorch. Nothing falls back from one
to the other: a CUDA call that a kernel cannot take raises. Because the CPU
runs the same autograd function with the plain inner calls, the CPU tests
reach all of the wiring the card runs (D, the layouts, the dhw reduction).

Bounds on an H100 (float32 outside the tensor cores, 67 TFLOP/s): the
forward does about 1.2 kFLOP per (frame, head, query, key), the three
backward kernels about 1.8, 2.4 and 1.3 kFLOP, each against 30-40 MB of
compulsory traffic at the release shapes, so arithmetic bounds all four
(about 19, 28, 37 and 20 us); with the products on the TF32 tensor cores
in three passes, about 9 (the bytes), 12, 15 and 12 us. The kernels keep
every N x N quantity in shared memory and registers, so traffic stays near
the compulsory bytes. The forward and dq run their products on the tensor
cores (3xTF32, float32 accuracy), which bounds their widths: C <= 256,
Pq*3 <= 32, Pv*3 <= 48, Dz <= 32 (``TILE_LIMITS``; the wrappers raise
past them); dk/dv and the pair kernel run on the CUDA cores in float32.

``launches``, ``bwd_dq_launches``, ``bwd_dkv_launches`` and
``bwd_pair_launches`` count the kernel launches of this process; a run
that must show the kernels were on its path sets them to 0 before and
reads them after.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
bwd_pair_launches = 0

INPUT_NAMES = ("q", "k", "v", "q_pts", "k_pts", "v_pts", "bias", "pair_z",
               "mask", "head_weights")


def ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                        head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Dense IPA attention in float32, the semantics of record
    (``dynamicpdb_tpu/models/ipa.py:55 dense_ipa_attention``) plus the row
    log-sum-exp. Shapes as in ``ipa_attention``."""
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    bias, pair_z = bias.to(f32), pair_z.to(f32)
    a = torch.einsum("fihc,fjhc->fhij", q, k) * c_qk
    a = a + c_b * bias.permute(2, 0, 1)[None]
    qp_sq = torch.sum(q_pts**2, dim=(-1, -2))  # [F, N, H]
    kp_sq = torch.sum(k_pts**2, dim=(-1, -2))
    cross = torch.einsum("fihpx,fjhpx->fhij", q_pts, k_pts)
    pt_att = (
        qp_sq.transpose(1, 2)[..., :, None]
        + kp_sq.transpose(1, 2)[..., None, :]
        - 2 * cross
    )  # [F, H, N, N]
    a = a + (-0.5) * head_weights[None, :, None, None] * pt_att
    a = a + inf * (mask[:, :, None] * mask[:, None, :] - 1.0)[:, None]
    lse = torch.logsumexp(a, dim=-1)  # [F, H, N]
    a = torch.softmax(a, dim=-1)
    return (
        torch.einsum("fhij,fjhc->fihc", a, v),
        torch.einsum("fhij,fjhpx->fihpx", a, v_pts),
        torch.einsum("fhij,ijd->fihd", a, pair_z),
        lse,
    )


# ---------------------------------------------------------------------------
# plain versions of the three backward kernels
# ---------------------------------------------------------------------------
def _recompute(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
               lse, dvec, g_o, g_opt, g_pair, c_qk, c_b, inf):
    """The backward's tile recompute (``_tile_a_dl`` :240) over all (i, j)
    at once: a, dl and dist, each [F, H, N, N]. Points are [F, N, H, P*3];
    lse and dvec [F, H, N]."""
    hw = head_weights[None, :, None, None]
    logits = c_qk * torch.einsum("fihc,fjhc->fhij", q, k)
    logits = logits + c_b * bias.permute(2, 0, 1)[None]
    qp_sq = torch.sum(q_pts * q_pts, -1).transpose(1, 2)[..., :, None]
    kp_sq = torch.sum(k_pts * k_pts, -1).transpose(1, 2)[..., None, :]
    dist = qp_sq + kp_sq - 2.0 * torch.einsum("fihx,fjhx->fhij", q_pts, k_pts)
    logits = logits + (-0.5) * hw * dist
    logits = logits + inf * (mask[:, :, None] * mask[:, None, :] - 1.0)[:, None]
    a = torch.exp(logits - lse[..., None])
    ds = (torch.einsum("fihc,fjhc->fhij", g_o, v)
          + torch.einsum("fihx,fjhx->fhij", g_opt, v_pts)
          + torch.einsum("fihd,ijd->fhij", g_pair, pair_z))
    return a, a * (ds - dvec[..., None]), dist


def ipa_bwd_dq_plain(*inputs, c_qk, c_b, inf):
    """Kernel A's function: (dq [F,N,H,C], dqp [F,N,H,Pq*3],
    dhw_rows [F,H,N])."""
    k, qp, kp, hw = inputs[1], inputs[3], inputs[4], inputs[9]
    _, dl, dist = _recompute(*inputs, c_qk, c_b, inf)
    dq = c_qk * torch.einsum("fhij,fjhc->fihc", dl, k)
    rowsum = dl.sum(-1).transpose(1, 2)[..., None]  # [F, N, H, 1]
    dlkp = torch.einsum("fhij,fjhx->fihx", dl, kp)
    dqp = -hw[:, None] * (rowsum * qp - dlkp)
    return dq, dqp, torch.sum(-0.5 * dist * dl, -1)


def ipa_bwd_dkv_plain(*inputs, c_qk, c_b, inf):
    """Kernel B's function: (dk, dkp, dv, dvp) in the layouts of k, k_pts,
    v, v_pts (points flattened to P*3)."""
    q, kp, qp, hw = inputs[0], inputs[4], inputs[3], inputs[9]
    g_o, g_opt = inputs[12], inputs[13]
    a, dl, _ = _recompute(*inputs, c_qk, c_b, inf)
    dk = c_qk * torch.einsum("fhij,fihc->fjhc", dl, q)
    colsum = dl.sum(-2).transpose(1, 2)[..., None]  # [F, N, H, 1]
    dlqp = torch.einsum("fhij,fihx->fjhx", dl, qp)
    dkp = -hw[:, None] * (colsum * kp - dlqp)
    dv = torch.einsum("fhij,fihc->fjhc", a, g_o)
    dvp = torch.einsum("fhij,fihx->fjhx", a, g_opt)
    return dk, dkp, dv, dvp


def ipa_bwd_pair_plain(*inputs, c_qk, c_b, inf):
    """Kernel C's function: (dbias [N,N,H], dpz [N,N,Dz])."""
    g_pair = inputs[14]
    a, dl, _ = _recompute(*inputs, c_qk, c_b, inf)
    dbias = c_b * dl.sum(0).permute(1, 2, 0)
    dpz = torch.einsum("fhij,fihd->ijd", a, g_pair)
    return dbias, dpz


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """A kernel library, built and loaded on first use, with every argument
    typed (pointers and the stream as c_void_p)."""
    from dynamicpdb_tpu_torch.ops import _build

    lib = _build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shapes = [i] * 7 + [f] * 3 + [i, p]
    if name == "ipa_attention_fwd":
        lib.ipa_attention_fwd.argtypes = [p] * 14 + shapes
        lib.ipa_attention_fwd.restype = i
        lib.ipa_attention_error_string.argtypes = [i]
        lib.ipa_attention_error_string.restype = ctypes.c_char_p
        lib.ipa_attention_fwd_smem.argtypes = [i] * 4
        lib.ipa_attention_fwd_smem.restype = ctypes.c_longlong
    else:
        for fn, n_out in (("ipa_attention_bwd_dq", 3),
                          ("ipa_attention_bwd_dkv", 4),
                          ("ipa_attention_bwd_pair", 2)):
            getattr(lib, fn).argtypes = [p] * (15 + n_out) + shapes
            getattr(lib, fn).restype = i
        lib.ipa_attention_bwd_error_string.argtypes = [i]
        lib.ipa_attention_bwd_error_string.restype = ctypes.c_char_p
        lib.ipa_attention_bwd_smem.argtypes = [i] * 5
        lib.ipa_attention_bwd_smem.restype = ctypes.c_longlong
    return lib


def _device_of(fn: str, tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{fn}: tensors on several devices {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {device}")
    return device


def _check_kernel_inputs(fn: str, named: dict, expected: dict, C: int):
    for name, t in named.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {expected[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    if C % 4:
        raise ValueError(f"{fn}: C={C} is not a multiple of 4")


# the widest operands the tensor-core kernels (forward, dq) take: C, Pq*3,
# Pv*3 and Dz (csrc/ipa_tile.cuh kMaxC, kMaxP3q, kMaxP3v, kMaxDz)
TILE_LIMITS = {"C": 256, "Pq*3": 32, "Pv*3": 48, "Dz": 32}


def _check_tile_limits(fn: str, C: int, P3q: int, P3v: int, Dz: int):
    for name, val in zip(TILE_LIMITS, (C, P3q, P3v, Dz)):
        if val > TILE_LIMITS[name]:
            raise ValueError(f"{fn}: {name}={val} is above "
                             f"{TILE_LIMITS[name]}, the most the kernel takes")


def _launch(lib, fn: str, error_string, ptrs, F, N, H, C, Pq, Pv, Dz, c_qk,
            c_b, inf, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn)(
        *ptrs, F, N, H, C, Pq, Pv, Dz, float(c_qk), float(c_b), float(inf),
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{error_string(rc).decode()} (code {rc})")


def ipa_attention_fwd(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                      head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Fused IPA attention forward (no autograd).

    q, k, v [F, N, H, C]; q_pts, k_pts [F, N, H, Pq, 3] and v_pts
    [F, N, H, Pv, 3] in the global frame; bias [N, N, H] and pair_z
    [N, N, Dz] shared by the frames; mask [F, N]; head_weights [H] (already
    softplus'ed and scaled). Returns (o [F, N, H, C], o_pt [F, N, H, Pv, 3],
    o_pair [F, N, H, Dz], lse [F, H, N]), all float32.
    """
    global launches
    args = (q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights)
    device = _device_of("ipa_attention", args)
    if device.type == "cpu":
        return ipa_attention_plain(*args, c_qk, c_b=c_b, inf=inf)

    F, N, H, C = q.shape
    Pq, Pv, Dz = q_pts.shape[-2], v_pts.shape[-2], pair_z.shape[-1]
    expected = {
        "q": (F, N, H, C), "k": (F, N, H, C), "v": (F, N, H, C),
        "q_pts": (F, N, H, Pq, 3), "k_pts": (F, N, H, Pq, 3),
        "v_pts": (F, N, H, Pv, 3), "bias": (N, N, H), "pair_z": (N, N, Dz),
        "mask": (F, N), "head_weights": (H,),
    }
    _check_kernel_inputs("ipa_attention", dict(zip(INPUT_NAMES, args)),
                         expected, C)
    _check_tile_limits("ipa_attention", C, 3 * Pq, 3 * Pv, Dz)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("ipa_attention: q, k and v must be 16-byte aligned")

    o = torch.empty((F, N, H, C), dtype=torch.float32, device=device)
    o_pt = torch.empty((F, N, H, Pv, 3), dtype=torch.float32, device=device)
    o_pair = torch.empty((F, N, H, Dz), dtype=torch.float32, device=device)
    lse = torch.empty((F, H, N), dtype=torch.float32, device=device)
    lib = _lib("ipa_attention_fwd")
    _launch(lib, "ipa_attention_fwd", lib.ipa_attention_error_string,
            [t.data_ptr() for t in args + (o, o_pt, o_pair, lse)],
            F, N, H, C, Pq, Pv, Dz, c_qk, c_b, inf, device)
    launches += 1
    return o, o_pt, o_pair, lse


BWD_INPUT_NAMES = INPUT_NAMES + ("lse", "dvec", "g_o", "g_opt", "g_pair")


def _bwd_call(fn: str, plain, out_shapes, inputs, c_qk, c_b, inf,
              tiled=False):
    """Run backward kernel ``fn`` (or ``plain`` on the CPU) on the 15
    backward inputs (points flattened to P*3); ``out_shapes(F, N, H, C,
    P3q, P3v, Dz)`` gives the shapes of its outputs; ``tiled``: the kernel
    has the tensor-core kernels' width limits."""
    device = _device_of(fn, inputs)
    if device.type == "cpu":
        return plain(*inputs, c_qk=c_qk, c_b=c_b, inf=inf)
    q, q_pts, v_pts, pair_z = inputs[0], inputs[3], inputs[5], inputs[7]
    F, N, H, C = q.shape
    P3q, P3v, Dz = q_pts.shape[-1], v_pts.shape[-1], pair_z.shape[-1]
    if P3q % 3 or P3v % 3:
        raise ValueError(f"{fn}: point widths {P3q}, {P3v} are not P*3")
    expected = {
        "q": (F, N, H, C), "k": (F, N, H, C), "v": (F, N, H, C),
        "q_pts": (F, N, H, P3q), "k_pts": (F, N, H, P3q),
        "v_pts": (F, N, H, P3v), "bias": (N, N, H), "pair_z": (N, N, Dz),
        "mask": (F, N), "head_weights": (H,), "lse": (F, H, N),
        "dvec": (F, H, N), "g_o": (F, N, H, C), "g_opt": (F, N, H, P3v),
        "g_pair": (F, N, H, Dz),
    }
    named = dict(zip(BWD_INPUT_NAMES, inputs))
    _check_kernel_inputs(fn, named, expected, C)
    if tiled:
        _check_tile_limits(fn, C, P3q, P3v, Dz)
    if any(named[n].data_ptr() % 16 for n in ("q", "k", "v", "g_o")):
        raise ValueError(f"{fn}: q, k, v and g_o must be 16-byte aligned")
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in out_shapes(F, N, H, C, P3q, P3v, Dz)]
    lib = _lib("ipa_attention_bwd")
    _launch(lib, fn, lib.ipa_attention_bwd_error_string,
            [t.data_ptr() for t in tuple(inputs) + tuple(outs)],
            F, N, H, C, P3q // 3, P3v // 3, Dz, c_qk, c_b, inf, device)
    return tuple(outs)


def ipa_attention_bwd_dq(*inputs, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Kernel A on the backward inputs (``BWD_INPUT_NAMES``, points
    [F, N, H, P*3], lse and dvec [F, H, N]): (dq, dqp, dhw_rows [F, H, N])."""
    global bwd_dq_launches
    out = _bwd_call(
        "ipa_attention_bwd_dq", ipa_bwd_dq_plain,
        lambda F, N, H, C, P3q, P3v, Dz: ((F, N, H, C), (F, N, H, P3q),
                                          (F, H, N)),
        inputs, c_qk, c_b, inf, tiled=True)
    if inputs[0].is_cuda:
        bwd_dq_launches += 1
    return out


def ipa_attention_bwd_dkv(*inputs, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Kernel B on the backward inputs: (dk, dkp, dv, dvp)."""
    global bwd_dkv_launches
    out = _bwd_call(
        "ipa_attention_bwd_dkv", ipa_bwd_dkv_plain,
        lambda F, N, H, C, P3q, P3v, Dz: ((F, N, H, C), (F, N, H, P3q),
                                          (F, N, H, C), (F, N, H, P3v)),
        inputs, c_qk, c_b, inf)
    if inputs[0].is_cuda:
        bwd_dkv_launches += 1
    return out


def ipa_attention_bwd_pair(*inputs, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Kernel C on the backward inputs: (dbias [N, N, H], dpz [N, N, Dz])."""
    global bwd_pair_launches
    out = _bwd_call(
        "ipa_attention_bwd_pair", ipa_bwd_pair_plain,
        lambda F, N, H, C, P3q, P3v, Dz: ((N, N, H), (N, N, Dz)),
        inputs, c_qk, c_b, inf)
    if inputs[0].is_cuda:
        bwd_pair_launches += 1
    return out


def backward_inputs(saved, g_o, g_opt, g_pair):
    """The 15 backward-kernel inputs from the forward's saved tensors
    (the 10 inputs, then o, o_pt, o_pair, lse) and the output cotangents:
    every cotangent made contiguous float32 (those reaching o_pt through
    the model's xyz unbinding arrive as strided views), points flattened to
    P*3, and D = <g, out> per (f, h, i) as ``_ipa_attention_bwd``
    (:583-587) computes it."""
    (q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
     o, o_pt, o_pair, lse) = saved
    F, N, H = q.shape[:3]
    g_o = g_o.float().contiguous()
    g_opt = g_opt.float().reshape(F, N, H, -1).contiguous()
    g_pair = g_pair.float().contiguous()
    dvec = (torch.sum(g_o * o, -1)
            + torch.sum(g_opt * o_pt.reshape(F, N, H, -1), -1)
            + torch.sum(g_pair * o_pair, -1))  # [F, N, H]
    return (q, k, v, q_pts.reshape(F, N, H, -1), k_pts.reshape(F, N, H, -1),
            v_pts.reshape(F, N, H, -1), bias, pair_z, mask, head_weights,
            lse, dvec.transpose(1, 2).contiguous(), g_o, g_opt, g_pair)


class IPAAttention(torch.autograd.Function):
    """Differentiable fused IPA attention: ``ipa_attention_fwd`` forward,
    the three backward kernels from the saved row LSE, so training memory
    stays O(tile), never O(F·H·N²)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                head_weights, c_qk, c_b, inf):
        o, o_pt, o_pair, lse = ipa_attention_fwd(
            q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
            c_qk, c_b=c_b, inf=inf)
        ctx.save_for_backward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z,
                              mask, head_weights, o, o_pt, o_pair, lse)
        ctx.consts = (c_qk, c_b, inf)
        ctx.mark_non_differentiable(lse)
        return o, o_pt, o_pair, lse

    @staticmethod
    def backward(ctx, g_o, g_opt, g_pair, _g_lse):
        c_qk, c_b, inf = ctx.consts
        saved = ctx.saved_tensors
        inputs = backward_inputs(saved, g_o, g_opt, g_pair)
        kw = dict(c_qk=c_qk, c_b=c_b, inf=inf)
        dq, dqp, dhw_rows = ipa_attention_bwd_dq(*inputs, **kw)
        dk, dkp, dv, dvp = ipa_attention_bwd_dkv(*inputs, **kw)
        dbias, dpz = ipa_attention_bwd_pair(*inputs, **kw)
        dhw = torch.sum(dhw_rows, dim=(0, 2))  # :511
        q, k, v, q_pts, k_pts, v_pts, bias, pair_z, _, head_weights = saved[:10]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dqp.reshape(q_pts.shape).to(q_pts.dtype),
                dkp.reshape(k_pts.shape).to(k_pts.dtype),
                dvp.reshape(v_pts.shape).to(v_pts.dtype),
                dbias.to(bias.dtype), dpz.to(pair_z.dtype), None,
                dhw.to(head_weights.dtype), None, None, None)


def ipa_attention(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                  head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Differentiable fused IPA attention (``IPAAttention``); arguments and
    results as ``ipa_attention_fwd``. The lse output carries no gradient."""
    return IPAAttention.apply(q, k, v, q_pts, k_pts, v_pts, bias, pair_z,
                              mask, head_weights, c_qk, c_b, inf)
