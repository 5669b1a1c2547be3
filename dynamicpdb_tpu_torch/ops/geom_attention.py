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
float32 accuracy, returning the input's dtype (float32 or bfloat16).
``fused_gated_node_attention`` also takes a block of query rows, [q0, q0 +
Lq) of the L rows that give the keys (``q0``, and Lq from the bias's
rows): one 'seq' rank's rows under sequence parallelism
(``parallel/sp.py``). The square call is q0 = 0, Lq = L. For a
CUDA tensor each launches its hand-written kernel (``csrc/geom_attention.cu``,
built by ``nvcc``, loaded with ``ctypes``); for a CPU tensor it runs its
plain version. Nothing falls back from one to the other: a CUDA call that
the kernel cannot take raises. The kernels tile the keys, so unlike the
TPU kernels they take every length L (no ``MAX_FLASH_RES``).

The kernels run all four products (the q|gate and k|v projections, q k^T
and p v) on the TF32 tensor cores (``mma.sync`` m16n8k8) in a
flash-attention layout: scores and output in accumulator fragments, k|v
of 128 keys at a time resident in shared memory, x, weight and bias tiles
brought in by double-buffered ``cp.async``. Each kernel has two
instances, 256 query rows a block (two 16-row mma tiles a warp) and 128
(one); ``tile_rows`` picks one per call and passes it to the launcher,
which refuses any other. A block projects k|v once per query chunk, so
the 128-row instance takes the calls of at most 128 query rows (a 'seq'
rank's block of a release window, sequences of up to 128 residues),
where a 256-row tile would run half or more of its rows on zeros, and the
256-row instance every other (past 128 rows, 128-row chunks would
re-project k|v more often). A row's arithmetic is the same in both: a
block's rows equal the square call's bit for bit. One TF32 pass misses
the float32 tolerance, so each float32 operand is split into a TF32 high
and low part and a product takes three passes (3xTF32); the projections
take one pass when x and the weights are both bfloat16 (the ``--dtype
bfloat16`` path).

Bounds on an H100 (chip_smoke.geom_cost): the geometric attention does
34.4 GFLOP of products per launch at the release shapes against ~137 MB,
the node attention 3.2 GFLOP against ~12 MB; arithmetic bounds both. On
the CUDA cores (67 TFLOP/s float32) that is 0.52 and 0.049 ms; on the
tensor cores, three TF32 passes at 495 TFLOP/s plus the elementwise work,
~0.22 and ~0.020 ms (``tc_bound_ms`` in chip_smoke's reports).

``geom_launches`` and ``node_launches`` count the kernel launches of this
process, ``geom_launches_128`` and ``node_launches_128`` those of them in
the 128-row instance; a run that must show the kernels were on its path
sets them to 0 before and reads them after.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dynamicpdb_tpu_torch.ops.ipa_attention import _device_of

geom_launches = 0
node_launches = 0
# the launches of the 128-row instance, counted in the two above too
geom_launches_128 = 0
node_launches_128 = 0

KERNEL_C = 32  # the head width the kernels are compiled for
TILE_ROWS = (128, 256)  # the kernel's instances: query rows a block


def query_rows(x, q0: int, Lq: int):
    """Rows [q0, q0 + Lq) of x [..., L, d] along its L axis, rows past L
    zero (a 'seq' rank's pad rows); x itself for the square call."""
    L = x.shape[-2]
    if q0 == 0 and Lq == L:
        return x
    part = x[..., min(q0, L):min(q0 + Lq, L), :]
    pad = x.new_zeros(x.shape[:-2] + (Lq - part.shape[-2], x.shape[-1]))
    return torch.cat([part, pad], -2)


def _gated_attention_plain(x, qg_w, qg_b, kv_w, kv_b, bias, kmask, c, scale,
                           q0: int = 0):
    """x [B, R, L, d]; weights [d, R, H, 2c], biases [R, H, 1, 2c]; bias
    broadcastable to [B, R, H, Lq, L]; kmask [B, L] or None. The queries are
    x's rows [q0, q0 + Lq) (``query_rows``), the keys all L. Returns
    [B, R, H, Lq, c] in float32."""
    f32 = torch.float32
    x = x.to(f32)
    xq = query_rows(x, q0, bias.shape[-2])
    qg = torch.einsum("brld,drhe->brhle", xq, qg_w.to(f32)) + qg_b.to(f32)
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
                         c: int, scale: float, q0: int = 0):
    """``fused_gated_node_attention`` in plain PyTorch (float32 math)."""
    out = _gated_attention_plain(node[:, None], qg_w, qg_b, kv_w, kv_b,
                                 bias[None, None], kmask, c, scale, q0)
    return out[:, 0].to(node.dtype)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (built from ``csrc/geom_attention.cu``) with every argument
    typed (pointers and the stream as c_void_p)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.geom_attention.argtypes = [p] * 7 + [i] * 6 + [f, i, i, i, i, p]
    lib.geom_attention.restype = i
    lib.node_attention.argtypes = [p] * 8 + [i] * 7 + [f, i, i, i, i, p]
    lib.node_attention.restype = i
    lib.geom_attention_smem.argtypes = [i]
    lib.geom_attention_smem.restype = ctypes.c_longlong
    lib.geom_attention_error_string.argtypes = [i]
    lib.geom_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, typed."""
    from dynamicpdb_tpu_torch.ops import _build

    return _typed(_build.load("geom_attention"))


def tile_rows(Lq: int) -> int:
    """The kernel instance for a call of Lq query rows: its query rows a
    block, one of TILE_ROWS.

    A block projects k|v of every key once per query chunk, so the tile
    that needs the fewest chunks re-projects k|v the least; among tiles
    that need as few, the smaller pads fewer rows. Lq <= 128 fits one chunk
    of either, so the 128-row tile takes it (a 'seq' rank's block, the
    short sequences); past 128 rows the 128-row tile needs more chunks
    than the 256-row one (ceil(Lq / 128) > ceil(Lq / 256)), and the
    256-row tile takes the call."""
    return 128 if Lq <= 128 else 256


def _f32(t):
    """t as a contiguous float32 tensor (t itself when it is one)."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def kernel_inputs(fn: str, x, qg_w, qg_b, kv_w, kv_b, bias, kmask, c: int):
    """The kernel's operands from the wrapper's: x contiguous in its own
    dtype (float32 or bfloat16); the weights [d, R, H, 2c] (the kernel's
    [d, R*H, 2c], g = axis * H + head, the TPU kernel's flattening), biases
    [R, H, 1, 2c], the bias [R, H, Lq, L] and kmask, all float32 and
    contiguous (the tensors themselves where they already are); ``w_bf16``
    whether both weights are bfloat16 (so their float32 copies are bf16
    values and one projection pass is exact). Raises on what the kernel
    cannot take. x is [B, R, L, d]; Lq (the query rows) is the bias's third
    dim for node_attention, L for geom_attention."""
    B, R, L, d = x.shape
    H = qg_w.shape[2]
    Lq = bias.shape[2] if fn == "node_attention" and bias.dim() == 4 else L
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: x is {x.dtype}, the kernel takes float32 or "
                        "bfloat16")
    if c != KERNEL_C:
        raise ValueError(f"{fn}: c={c}, the kernel is built for c={KERNEL_C}")
    if d % 8:
        raise ValueError(f"{fn}: d={d} is not a multiple of 8")
    w, b = (d, R, H, 2 * c), (R, H, 1, 2 * c)
    for name, t, shape in (("qg_w", qg_w, w), ("kv_w", kv_w, w),
                           ("qg_b", qg_b, b), ("kv_b", kv_b, b),
                           ("bias", bias, (R, H, Lq, L)),
                           ("kmask", kmask, (B, L))):
        if t is not None and t.shape != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    ops = dict(x=x.contiguous(), wqg=_f32(qg_w), bqg=_f32(qg_b),
               wkv=_f32(kv_w), bkv=_f32(kv_b), bias=_f32(bias))
    if kmask is not None:
        ops["kmask"] = _f32(kmask)
    for name, t in ops.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    ops["w_bf16"] = (qg_w.dtype == torch.bfloat16
                     and kv_w.dtype == torch.bfloat16)
    return ops


def launch(lib, fn: str, ops: dict, out, B, R, H, L, d, c, scale, device,
           stream, *, q0: int = 0, Lq: int | None = None,
           rows: int | None = None):
    """Launch ``fn`` (geom_attention or node_attention) of ``lib`` on the
    operands of ``kernel_inputs``, in the instance of ``rows`` query rows a
    block (None: ``tile_rows``); raises if the launch is refused.
    node_attention's queries are rows [q0, q0 + Lq) (Lq None: L)."""
    Lq = L if Lq is None else Lq
    rows = tile_rows(Lq) if rows is None else rows
    names = ("x", "wqg", "bqg", "wkv", "bkv", "bias") + (
        ("kmask",) if fn == "node_attention" else ())
    ptrs = [ops[n].data_ptr() for n in names] + [out.data_ptr()]
    dims = ((B, R, H, L, d, c) if fn == "geom_attention"
            else (B, H, L, Lq, q0, d, c))
    rc = getattr(lib, fn)(*ptrs, *dims, float(scale),
                          int(ops["x"].dtype == torch.bfloat16),
                          int(ops["w_bf16"]), rows, device, stream)
    if rc != 0:
        smem = lib.geom_attention_smem(rows)  # -1: no instance of `rows`
        raise RuntimeError(
            f"{fn} launch failed: "
            f"{lib.geom_attention_error_string(rc).decode()} (code {rc}; "
            f"B={B}, R={R}, H={H}, L={L}, Lq={Lq}, q0={q0}, d={d}, "
            f"rows={rows} " + (f"query rows a block, {smem} bytes of shared "
                               "memory)" if smem >= 0 else
                               f"query rows a block: the kernel has "
                               f"instances of {TILE_ROWS} only)"))


def _cuda_call(fn: str, x4, qg_w, qg_b, kv_w, kv_b, bias, kmask, c, scale,
               rows: int, q0: int = 0):
    """Run kernel ``fn`` on the card in the instance of ``rows`` query rows
    a block; x4 is [B, R, L, d], the queries its rows [q0, q0 + Lq) (Lq:
    bias.shape[2]). Returns [B, R*H, Lq, c] in x's dtype."""
    B, R, L, d = x4.shape
    H, Lq = qg_w.shape[2], bias.shape[2]
    if q0 < 0 or Lq < 1:
        raise ValueError(f"{fn}: query rows [{q0}, {q0 + Lq}) of L={L}")
    ops = kernel_inputs(fn, x4, qg_w, qg_b, kv_w, kv_b, bias, kmask, c)
    out = torch.empty((B, R * H, Lq, c), dtype=x4.dtype, device=x4.device)
    device = x4.device.index
    if device is None:
        device = torch.cuda.current_device()
    launch(_lib(), fn, ops, out, B, R, H, L, d, c, scale, device,
           torch.cuda.current_stream(x4.device).cuda_stream, q0=q0, Lq=Lq,
           rows=rows)
    return out


def fused_gated_geom_attention_t(stacked_t, qg_w, qg_b, kv_w, kv_b, bias, *,
                                 c: int, scale: float):
    """GeometricAttention's gated two-axis attention on the axis-major
    stacked edge tensor.

    stacked_t [B, n_axis, L, d]; qg_w, kv_w [d, n_axis, H, 2c]; qg_b, kv_b
    [n_axis, H, 1, 2c]; bias [n_axis, H, L, L], shared over B. Returns the
    gated output [B, n_axis, H, L, c] (before the output projection) in
    stacked_t's dtype."""
    global geom_launches, geom_launches_128
    args = (stacked_t, qg_w, qg_b, kv_w, kv_b, bias)
    device = _device_of("geom_attention", args)
    if device.type == "cpu":
        return geom_attention_plain(*args, c=c, scale=scale)
    B, R, L, _ = stacked_t.shape
    rows = tile_rows(L)
    out = _cuda_call("geom_attention", stacked_t, qg_w, qg_b, kv_w, kv_b,
                     bias, None, c, scale, rows)
    geom_launches += 1
    geom_launches_128 += rows == 128
    return out.reshape(B, R, qg_w.shape[2], L, c)


def fused_gated_node_attention(node, qg_w, qg_b, kv_w, kv_b, bias, kmask, *,
                               c: int, scale: float, q0: int = 0):
    """AttentionWEdgeBias's gated attention with each row's key mask, for
    the query rows [q0, q0 + Lq) of node against all its L keys.

    node [M, L, d]; qg_w, kv_w [d, 1, H, 2c]; qg_b, kv_b [1, H, 1, 2c];
    bias [H, Lq, L], the query rows' bias, shared over the pseudo-MSA rows;
    kmask [M, L]. Query rows past L read zeros (a 'seq' rank's pad rows).
    Returns the gated output [M, H, Lq, c] (before the output projection)
    in node's dtype."""
    global node_launches, node_launches_128
    args = (node, qg_w, qg_b, kv_w, kv_b, bias, kmask)
    device = _device_of("node_attention", args)
    if device.type == "cpu":
        return node_attention_plain(*args, c=c, scale=scale, q0=q0)
    rows = tile_rows(bias.shape[1])
    out = _cuda_call("node_attention", node[:, None], qg_w, qg_b, kv_w, kv_b,
                     bias[None], kmask, c, scale, rows, q0)
    node_launches += 1
    node_launches_128 += rows == 128
    return out
