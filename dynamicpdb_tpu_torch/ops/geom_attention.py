"""Gated geometric attention of the OmegaFold GeoFormer: the CUDA kernels,
their plain versions, and their wrappers.

Two wrappers, each the counterpart of a JAX entry point of
``dynamicpdb_tpu/ops/pallas/geom_attention.py`` with its layouts:

  ``fused_gated_geom_attention_t`` <- ``_kernel`` (:50, launched at :190 by
      ``fused_gated_geom_attention_t`` :152): GeometricAttention's two-axis
      gated attention over the stacked edge tensor;
  ``fused_gated_node_attention``   <- ``_kernel_masked`` (:76, launched at
      :125 by ``fused_gated_node_attention`` :105): AttentionWEdgeBias's
      gated attention with a per-row key mask.

Each computes, per (axis, head, row), q|gate = x Wqg + b, k|v = x Wkv + b,
softmax(scale q k^T + bias [+ (kmask - 1) 1e9]) v * sigmoid(gate), to
float32 accuracy, returning the input's dtype (float32 or bfloat16). For a
CUDA tensor each launches its hand-written kernel (``csrc/geom_attention.cu``,
built by ``nvcc``, loaded with ``ctypes``); for a CPU tensor it runs its
plain version. Nothing falls back from one to the other: a CUDA call that
the kernel cannot take raises. The kernels tile the keys, so unlike the
TPU kernels they take every length L (no ``MAX_FLASH_RES``).

The kernels run all four products (the q|gate and k|v projections, q k^T
and p v) on the TF32 tensor cores (``mma.sync`` m16n8k8) in a
flash-attention layout: 32 query rows per warp (two 16-row mma tiles), 256
per block, scores and output in accumulator fragments, k|v of 128 keys at
a time resident in shared memory (projected once per head and batch row at
L <= 256), x, weight and bias tiles brought in by double-buffered
``cp.async``. One TF32 pass misses the float32 tolerance, so each float32
operand is split into a TF32 high and low part and a product takes three
passes (3xTF32); the projections take one pass when x and the weights are
both bfloat16 (the ``--dtype bfloat16`` path).

Bounds on an H100 (chip_smoke.geom_cost): the geometric attention does
34.4 GFLOP of products per launch at the release shapes against ~137 MB,
the node attention 3.2 GFLOP against ~12 MB; arithmetic bounds both. On
the CUDA cores (67 TFLOP/s float32) that is 0.52 and 0.049 ms; on the
tensor cores, three TF32 passes at 495 TFLOP/s plus the elementwise work,
~0.22 and ~0.020 ms (``tc_bound_ms`` in chip_smoke's reports).

``geom_launches`` and ``node_launches`` count the kernel launches of this
process; a run that must show the kernels were on its path sets them to 0
before and reads them after.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dynamicpdb_tpu_torch.ops.ipa_attention import _device_of

geom_launches = 0
node_launches = 0

KERNEL_C = 32  # the head width the kernels are compiled for


def _gated_attention_plain(x, qg_w, qg_b, kv_w, kv_b, bias, kmask, c, scale):
    """x [B, R, L, d]; weights [d, R, H, 2c], biases [R, H, 1, 2c]; bias
    broadcastable to [B, R, H, L, L]; kmask [B, L] or None. Returns
    [B, R, H, L, c] in float32."""
    f32 = torch.float32
    x = x.to(f32)
    qg = torch.einsum("brld,drhe->brhle", x, qg_w.to(f32)) + qg_b.to(f32)
    kv = torch.einsum("brld,drhe->brhle", x, kv_w.to(f32)) + kv_b.to(f32)
    q, gate, k, v = qg[..., :c], qg[..., c:], kv[..., :c], kv[..., c:]
    logits = torch.einsum("...ic,...jc->...ij", q * scale, k) + bias.to(f32)
    if kmask is not None:
        logits = logits + (kmask.to(f32)[:, None, None, None, :] - 1.0) * 1e9
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("...ij,...jc->...ic", p, v) / p.sum(-1, keepdim=True)
    return out * torch.sigmoid(gate)


def geom_attention_plain(stacked_t, qg_w, qg_b, kv_w, kv_b, bias, *, c: int,
                         scale: float):
    """``fused_gated_geom_attention_t`` in plain PyTorch (float32 math)."""
    out = _gated_attention_plain(stacked_t, qg_w, qg_b, kv_w, kv_b,
                                 bias[None], None, c, scale)
    return out.to(stacked_t.dtype)


def node_attention_plain(node, qg_w, qg_b, kv_w, kv_b, bias, kmask, *,
                         c: int, scale: float):
    """``fused_gated_node_attention`` in plain PyTorch (float32 math)."""
    out = _gated_attention_plain(node[:, None], qg_w, qg_b, kv_w, kv_b,
                                 bias[None, None], kmask, c, scale)
    return out[:, 0].to(node.dtype)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, with every
    argument typed (pointers and the stream as c_void_p)."""
    from dynamicpdb_tpu_torch.ops import _build

    lib = _build.load("geom_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.geom_attention.argtypes = [p] * 7 + [i] * 6 + [f, i, i, i, p]
    lib.geom_attention.restype = i
    lib.node_attention.argtypes = [p] * 8 + [i] * 5 + [f, i, i, i, p]
    lib.node_attention.restype = i
    lib.geom_attention_smem.argtypes = [i]
    lib.geom_attention_smem.restype = ctypes.c_longlong
    lib.geom_attention_error_string.argtypes = [i]
    lib.geom_attention_error_string.restype = ctypes.c_char_p
    return lib


def kernel_inputs(fn: str, x, qg_w, qg_b, kv_w, kv_b, bias, kmask, c: int):
    """The kernel's operands from the wrapper's: x contiguous in its own
    dtype (float32 or bfloat16); the weights as [d, R*H, 2c] and biases
    [R*H, 2c] (g = axis * H + head, the TPU kernel's flattening), the bias
    [R*H, L, L] and kmask, all float32 and contiguous; ``w_bf16`` whether
    both weights are bfloat16 (so their float32 copies are bf16 values and
    one projection pass is exact). Raises on what the kernel cannot take.
    x is [B, R, L, d]."""
    B, R, L, d = x.shape
    H = qg_w.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: x is {x.dtype}, the kernel takes float32 or "
                        "bfloat16")
    if c != KERNEL_C:
        raise ValueError(f"{fn}: c={c}, the kernel is built for c={KERNEL_C}")
    if d % 8:
        raise ValueError(f"{fn}: d={d} is not a multiple of 8")
    expected = {"qg_w": (d, R, H, 2 * c), "kv_w": (d, R, H, 2 * c),
                "qg_b": (R, H, 1, 2 * c), "kv_b": (R, H, 1, 2 * c),
                "bias": (R, H, L, L)}
    got = {"qg_w": qg_w, "kv_w": kv_w, "qg_b": qg_b, "kv_b": kv_b,
           "bias": bias}
    for name, shape in expected.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{fn}: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
    if kmask is not None and tuple(kmask.shape) != (B, L):
        raise ValueError(f"{fn}: kmask has shape {tuple(kmask.shape)}, "
                         f"expected {(B, L)}")
    f32 = torch.float32
    G = R * H
    ops = dict(
        x=x.contiguous(),
        wqg=qg_w.to(f32).reshape(d, G, 2 * c).contiguous(),
        bqg=qg_b.to(f32).reshape(G, 2 * c).contiguous(),
        wkv=kv_w.to(f32).reshape(d, G, 2 * c).contiguous(),
        bkv=kv_b.to(f32).reshape(G, 2 * c).contiguous(),
        bias=bias.to(f32).reshape(G, L, L).contiguous(),
    )
    if kmask is not None:
        ops["kmask"] = kmask.to(f32).contiguous()
    for name, t in ops.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    ops["w_bf16"] = (qg_w.dtype == torch.bfloat16
                     and kv_w.dtype == torch.bfloat16)
    return ops


def launch(lib, fn: str, ops: dict, out, B, R, H, L, d, c, scale, device,
           stream):
    """Launch ``fn`` (geom_attention or node_attention) of ``lib`` on the
    operands of ``kernel_inputs``; raises if the launch is refused."""
    names = ("x", "wqg", "bqg", "wkv", "bkv", "bias") + (
        ("kmask",) if fn == "node_attention" else ())
    ptrs = [ops[n].data_ptr() for n in names] + [out.data_ptr()]
    dims = (B, R, H, L, d, c) if fn == "geom_attention" else (B, H, L, d, c)
    rc = getattr(lib, fn)(*ptrs, *dims, float(scale),
                          int(ops["x"].dtype == torch.bfloat16),
                          int(ops["w_bf16"]), device, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.geom_attention_error_string(rc).decode()} "
                           f"(code {rc}; B={B}, R={R}, H={H}, L={L}, d={d}, "
                           f"{lib.geom_attention_smem(d)} bytes of shared "
                           "memory)")


def _cuda_call(fn: str, x4, qg_w, qg_b, kv_w, kv_b, bias, kmask, c, scale):
    """Run kernel ``fn`` on the card; x4 is [B, R, L, d]. Returns
    [B, R*H, L, c] in x's dtype."""
    B, R, L, d = x4.shape
    H = qg_w.shape[2]
    ops = kernel_inputs(fn, x4, qg_w, qg_b, kv_w, kv_b, bias, kmask, c)
    out = torch.empty((B, R * H, L, c), dtype=x4.dtype, device=x4.device)
    device = x4.device.index
    if device is None:
        device = torch.cuda.current_device()
    launch(_lib(), fn, ops, out, B, R, H, L, d, c, scale, device,
           torch.cuda.current_stream(x4.device).cuda_stream)
    return out


def fused_gated_geom_attention_t(stacked_t, qg_w, qg_b, kv_w, kv_b, bias, *,
                                 c: int, scale: float):
    """GeometricAttention's gated two-axis attention on the axis-major
    stacked edge tensor.

    stacked_t [B, n_axis, L, d]; qg_w, kv_w [d, n_axis, H, 2c]; qg_b, kv_b
    [n_axis, H, 1, 2c]; bias [n_axis, H, L, L], shared over B. Returns the
    gated output [B, n_axis, H, L, c] (before the output projection) in
    stacked_t's dtype."""
    global geom_launches
    args = (stacked_t, qg_w, qg_b, kv_w, kv_b, bias)
    device = _device_of("geom_attention", args)
    if device.type == "cpu":
        return geom_attention_plain(*args, c=c, scale=scale)
    B, R, L, _ = stacked_t.shape
    out = _cuda_call("geom_attention", stacked_t, qg_w, qg_b, kv_w, kv_b,
                     bias, None, c, scale)
    geom_launches += 1
    return out.reshape(B, R, qg_w.shape[2], L, c)


def fused_gated_node_attention(node, qg_w, qg_b, kv_w, kv_b, bias, kmask, *,
                               c: int, scale: float):
    """AttentionWEdgeBias's gated attention with each row's key mask.

    node [M, L, d]; qg_w, kv_w [d, 1, H, 2c]; qg_b, kv_b [1, H, 1, 2c];
    bias [H, L, L], shared over the rows; kmask [M, L]. Returns the gated
    output [M, H, L, c] (before the output projection) in node's dtype."""
    global node_launches
    args = (node, qg_w, qg_b, kv_w, kv_b, bias, kmask)
    device = _device_of("node_attention", args)
    if device.type == "cpu":
        return node_attention_plain(*args, c=c, scale=scale)
    out = _cuda_call("node_attention", node[:, None], qg_w, qg_b, kv_w, kv_b,
                     bias[None], kmask, c, scale)
    node_launches += 1
    return out
