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

For CUDA tensors each wrapper launches a hand-written kernel, built by
``nvcc`` and loaded with ``ctypes``, on the route that ``kernel_route``
picks for that wrapper from the widths:

  ``"tc"``       within ``TILE_LIMITS``, all four wrappers: the tensor-core
                 kernels (``csrc/ipa_attention_fwd.cu``,
                 ``csrc/ipa_attention_bwd.cu``);
  ``"wide_tc"``  past them and within ``WIDE_TC_LIMITS``, all four: the
                 wide tensor-core kernels
                 (``csrc/ipa_attention_wide_tc_fwd.cu``,
                 ``csrc/ipa_attention_wide_tc_bwd.cu``);
  ``"wide"``     every other width whose tiles fit a block's shared memory:
                 the CUDA-core kernels (``csrc/ipa_attention_wide_fwd.cu``,
                 ``csrc/ipa_attention_wide_bwd.cu``).

For CPU tensors a wrapper runs its plain version, the same function in
plain PyTorch. Nothing falls back from one to the other: a CUDA call that
no kernel can take raises. Because the CPU runs the same autograd
function with the plain inner calls, the CPU tests reach all of the wiring
the card runs (D, the layouts, the dhw reduction).

Bounds on an H100 (float32 outside the tensor cores, 67 TFLOP/s): the
forward does about 1.2 kFLOP per (frame, head, query, key), the three
backward kernels about 1.8, 2.4 and 1.3 kFLOP, each against 30-40 MB of
compulsory traffic at the release shapes, so arithmetic bounds all four
(about 19, 28, 37 and 20 us); with the products on the TF32 tensor cores
in three passes, about 9 (the bytes), 12, 15 and 12 us. The kernels keep
every N x N quantity in shared memory and registers, so traffic stays near
the compulsory bytes. All four tensor-core kernels run their products on
the tensor cores (3xTF32, float32 accuracy), which bounds their widths:
C <= 256, Pq*3 <= 32, Pv*3 <= 48, Dz <= 32 (``TILE_LIMITS``). The four
wide tensor-core kernels split C over eight warps of one 16-row (dk/dv:
16-key) tile and take C <= 384, Pq*3 <= 40, Pv*3 <= 56, Dz <= 64
(``WIDE_TC_LIMITS``); the wide CUDA-core kernels run every operation in
float32.

Rectangular calls. Every function takes ``key_mask``: the queries are
then Nq rows (q, q_pts, ``mask`` [F, Nq] and the cotangents) against Nk
keys (k, v, k_pts, v_pts, ``key_mask`` [F, Nk]), bias is [Nq, Nk, H] and
pair_z [Nq, Nk, Dz]; dk, dkp, dv and dvp are the sums over these Nq rows,
and dbias and dpz [Nq, Nk, .]. Sequence parallelism (``parallel/sp.py``)
calls them so with one rank's rows against every key. Without
``key_mask`` (None) the call is square: Nq = Nk = N, and the kernels take
``mask`` as both masks, which is the call they took before the split.

Each (wrapper, route) has a launch counter of this process (``COUNTERS``):
``launches``, ``bwd_dq_launches``, ``bwd_dkv_launches`` and
``bwd_pair_launches`` for the tensor-core kernels, ``wide_tc_launches``,
``wide_tc_bwd_dq_launches``, ``wide_tc_bwd_dkv_launches`` and
``wide_tc_bwd_pair_launches`` for the wide tensor-core ones, and
``wide_launches``, ``wide_bwd_dq_launches``, ``wide_bwd_dkv_launches`` and
``wide_bwd_pair_launches`` for the CUDA-core ones; a run that must show the
kernels were on its path sets them to 0 before and reads them after.
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
wide_launches = 0
wide_bwd_dq_launches = 0
wide_bwd_dkv_launches = 0
wide_bwd_pair_launches = 0
wide_tc_launches = 0
wide_tc_bwd_dq_launches = 0
wide_tc_bwd_dkv_launches = 0
wide_tc_bwd_pair_launches = 0

INPUT_NAMES = ("q", "k", "v", "q_pts", "k_pts", "v_pts", "bias", "pair_z",
               "mask", "head_weights")


def ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                        head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5,
                        key_mask=None):
    """Dense IPA attention in float32, the semantics of record
    (``dynamicpdb_tpu/models/ipa.py:55 dense_ipa_attention``) plus the row
    log-sum-exp. Shapes as in ``ipa_attention``."""
    key_mask = mask if key_mask is None else key_mask
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
    a = a + inf * (mask[:, :, None] * key_mask[:, None, :] - 1.0)[:, None]
    lse = torch.logsumexp(a, dim=-1)  # [F, H, Nq]
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
               lse, dvec, g_o, g_opt, g_pair, c_qk, c_b, inf, key_mask=None):
    """The backward's tile recompute (``_tile_a_dl`` :240) over all (i, j)
    at once: a, dl and dist, each [F, H, Nq, Nk]. Points are
    [F, N, H, P*3]; lse and dvec [F, H, Nq]."""
    key_mask = mask if key_mask is None else key_mask
    hw = head_weights[None, :, None, None]
    logits = c_qk * torch.einsum("fihc,fjhc->fhij", q, k)
    logits = logits + c_b * bias.permute(2, 0, 1)[None]
    qp_sq = torch.sum(q_pts * q_pts, -1).transpose(1, 2)[..., :, None]
    kp_sq = torch.sum(k_pts * k_pts, -1).transpose(1, 2)[..., None, :]
    dist = qp_sq + kp_sq - 2.0 * torch.einsum("fihx,fjhx->fhij", q_pts, k_pts)
    logits = logits + (-0.5) * hw * dist
    logits = logits + inf * (mask[:, :, None] * key_mask[:, None, :]
                             - 1.0)[:, None]
    a = torch.exp(logits - lse[..., None])
    ds = (torch.einsum("fihc,fjhc->fhij", g_o, v)
          + torch.einsum("fihx,fjhx->fhij", g_opt, v_pts)
          + torch.einsum("fihd,ijd->fhij", g_pair, pair_z))
    return a, a * (ds - dvec[..., None]), dist


def ipa_bwd_dq_plain(*inputs, c_qk, c_b, inf, key_mask=None):
    """Kernel A's function: (dq [F,Nq,H,C], dqp [F,Nq,H,Pq*3],
    dhw_rows [F,H,Nq])."""
    k, qp, kp, hw = inputs[1], inputs[3], inputs[4], inputs[9]
    _, dl, dist = _recompute(*inputs, c_qk, c_b, inf, key_mask)
    dq = c_qk * torch.einsum("fhij,fjhc->fihc", dl, k)
    rowsum = dl.sum(-1).transpose(1, 2)[..., None]  # [F, Nq, H, 1]
    dlkp = torch.einsum("fhij,fjhx->fihx", dl, kp)
    dqp = -hw[:, None] * (rowsum * qp - dlkp)
    return dq, dqp, torch.sum(-0.5 * dist * dl, -1)


def ipa_bwd_dkv_plain(*inputs, c_qk, c_b, inf, key_mask=None):
    """Kernel B's function: (dk, dkp, dv, dvp) in the layouts of k, k_pts,
    v, v_pts (points flattened to P*3), summed over the Nq query rows."""
    q, kp, qp, hw = inputs[0], inputs[4], inputs[3], inputs[9]
    g_o, g_opt = inputs[12], inputs[13]
    a, dl, _ = _recompute(*inputs, c_qk, c_b, inf, key_mask)
    dk = c_qk * torch.einsum("fhij,fihc->fjhc", dl, q)
    colsum = dl.sum(-2).transpose(1, 2)[..., None]  # [F, Nk, H, 1]
    dlqp = torch.einsum("fhij,fihx->fjhx", dl, qp)
    dkp = -hw[:, None] * (colsum * kp - dlqp)
    dv = torch.einsum("fhij,fihc->fjhc", a, g_o)
    dvp = torch.einsum("fhij,fihx->fjhx", a, g_opt)
    return dk, dkp, dv, dvp


def ipa_bwd_pair_plain(*inputs, c_qk, c_b, inf, key_mask=None):
    """Kernel C's function: (dbias [Nq,Nk,H], dpz [Nq,Nk,Dz])."""
    g_pair = inputs[14]
    a, dl, _ = _recompute(*inputs, c_qk, c_b, inf, key_mask)
    dbias = c_b * dl.sum(0).permute(1, 2, 0)
    dpz = torch.einsum("fhij,fihd->ijd", a, g_pair)
    return dbias, dpz


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """A kernel library, built and loaded on first use."""
    from dynamicpdb_tpu_torch.ops import _build

    return _typed(_build.load(name), name)


def _typed(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """``lib`` (built from ``csrc/<name>.cu``) with every argument of its
    functions typed (pointers and the stream as c_void_p), as ``LIBRARIES``
    lists them; its error-string function also as ``lib.error_string``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shapes = [i] * 8 + [f] * 3 + [i, p]  # F, Nq, Nk, H, C, Pq, Pv, Dz, ...
    launchers, smem, n_smem_args, err = LIBRARIES[name]
    for launcher, n_ptrs in launchers.items():
        getattr(lib, launcher).argtypes = [p] * n_ptrs + shapes
        getattr(lib, launcher).restype = i
    if name == "ipa_attention_wide_fwd":
        lib.ipa_attention_wide_smem_limit.argtypes = []
        lib.ipa_attention_wide_smem_limit.restype = ctypes.c_longlong
    getattr(lib, err).argtypes = [i]
    getattr(lib, err).restype = ctypes.c_char_p
    getattr(lib, smem).argtypes = [i] * n_smem_args
    getattr(lib, smem).restype = ctypes.c_longlong
    lib.error_string = getattr(lib, err)
    return lib


# each library: ({launcher: its pointer arguments (inputs with the key mask,
# then outputs)}, its shared-memory query, that query's int arguments, its
# error-string function)
_BWD = {"dq": 19, "dkv": 20, "pair": 18}
LIBRARIES = {
    "ipa_attention_fwd": ({"ipa_attention_fwd": 15}, "ipa_attention_fwd_smem",
                          4, "ipa_attention_error_string"),
    "ipa_attention_bwd": ({f"ipa_attention_bwd_{k}": n
                           for k, n in _BWD.items()},
                          "ipa_attention_bwd_smem", 5,
                          "ipa_attention_bwd_error_string"),
    "ipa_attention_wide_tc_fwd": ({"ipa_attention_wide_tc_fwd": 15},
                                  "ipa_attention_wide_tc_fwd_smem", 4,
                                  "ipa_attention_wide_tc_error_string"),
    "ipa_attention_wide_tc_bwd": ({f"ipa_attention_wide_tc_bwd_{k}": n
                                   for k, n in _BWD.items()},
                                  "ipa_attention_wide_tc_bwd_smem", 5,
                                  "ipa_attention_wide_tc_bwd_error_string"),
    "ipa_attention_wide_fwd": ({"ipa_attention_wide_fwd": 15},
                               "ipa_attention_wide_fwd_smem", 4,
                               "ipa_attention_wide_error_string"),
    "ipa_attention_wide_bwd": ({f"ipa_attention_wide_bwd_{k}": n
                                for k, n in _BWD.items()},
                               "ipa_attention_wide_bwd_smem", 5,
                               "ipa_attention_wide_bwd_error_string"),
}


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


# the widest operands the tensor-core kernels (all four) take: C, Pq*3,
# Pv*3 and Dz (csrc/ipa_tile.cuh kMaxC, kMaxP3q, kMaxP3v, kMaxDz)
TILE_LIMITS = {"C": 256, "Pq*3": 32, "Pv*3": 48, "Dz": 32}
# the widest the wide tensor-core kernels take (csrc/ipa_wide_tile.cuh)
WIDE_TC_LIMITS = {"C": 384, "Pq*3": 40, "Pv*3": 56, "Dz": 64}
WRAPPERS = ("ipa_attention_fwd", "ipa_attention_bwd_dq",
            "ipa_attention_bwd_dkv", "ipa_attention_bwd_pair")
# each wrapper's kernel on the wide tensor-core route and on the wide route:
# (library, launcher, shared-memory query, its kernel index or None)
WIDE_TC_KERNELS = {
    "ipa_attention_fwd": ("ipa_attention_wide_tc_fwd",
                          "ipa_attention_wide_tc_fwd",
                          "ipa_attention_wide_tc_fwd_smem", None),
    "ipa_attention_bwd_dq": ("ipa_attention_wide_tc_bwd",
                             "ipa_attention_wide_tc_bwd_dq",
                             "ipa_attention_wide_tc_bwd_smem", 0),
    "ipa_attention_bwd_dkv": ("ipa_attention_wide_tc_bwd",
                              "ipa_attention_wide_tc_bwd_dkv",
                              "ipa_attention_wide_tc_bwd_smem", 1),
    "ipa_attention_bwd_pair": ("ipa_attention_wide_tc_bwd",
                               "ipa_attention_wide_tc_bwd_pair",
                               "ipa_attention_wide_tc_bwd_smem", 2),
}
WIDE_KERNELS = {
    "ipa_attention_fwd": ("ipa_attention_wide_fwd", "ipa_attention_wide_fwd",
                          "ipa_attention_wide_fwd_smem", None),
    "ipa_attention_bwd_dq": ("ipa_attention_wide_bwd",
                             "ipa_attention_wide_bwd_dq",
                             "ipa_attention_wide_bwd_smem", 0),
    "ipa_attention_bwd_dkv": ("ipa_attention_wide_bwd",
                              "ipa_attention_wide_bwd_dkv",
                              "ipa_attention_wide_bwd_smem", 1),
    "ipa_attention_bwd_pair": ("ipa_attention_wide_bwd",
                               "ipa_attention_wide_bwd_pair",
                               "ipa_attention_wide_bwd_smem", 2),
}


def wide_smem(fn: str, C: int, P3q: int, P3v: int, Dz: int,
              kernels=WIDE_KERNELS) -> int:
    """Bytes of dynamic shared memory a block of ``fn``'s kernel in
    ``kernels`` (the wide route's, or ``WIDE_TC_KERNELS``) needs at these
    widths, from its library's own query (builds it)."""
    lib_name, _, query, which = kernels[fn]
    args = (C, P3q // 3, P3v // 3, Dz)
    query = getattr(_lib(lib_name), query)
    return int(query(*args) if which is None else query(which, *args))


def wide_smem_limit() -> int:
    """Bytes of dynamic shared memory a block of a wide kernel may use, the
    figure the wide launchers refuse past (``csrc/ipa_wide_smem.cuh``)."""
    return int(_lib("ipa_attention_wide_fwd").ipa_attention_wide_smem_limit())


def _within(widths: dict, limits: dict) -> bool:
    return all(widths[k] <= limits[k] for k in limits)


def kernel_route(fn: str, C: int, P3q: int, P3v: int, Dz: int,
                 smem=wide_smem, smem_limit=wide_smem_limit) -> str:
    """The kernel that wrapper ``fn`` launches on the card at these widths:
    ``"tc"`` (the tensor-core kernel) within ``TILE_LIMITS``; ``"wide_tc"``
    (the wide tensor-core kernel, ``WIDE_TC_KERNELS``) within
    ``WIDE_TC_LIMITS``; else ``"wide"`` (the CUDA-core kernel) when its
    tiles, as ``smem(fn, C, P3q, P3v, Dz)`` counts them, fit the
    ``smem_limit()`` bytes of shared memory a block may use; past that,
    ValueError naming the widths and the limit."""
    widths = dict(zip(TILE_LIMITS, (C, P3q, P3v, Dz)))
    if _within(widths, TILE_LIMITS):
        return "tc"
    if _within(widths, WIDE_TC_LIMITS):
        return "wide_tc"
    need, limit = smem(fn, C, P3q, P3v, Dz), smem_limit()
    if need > limit:
        shown = ", ".join(f"{k}={v}" for k, v in widths.items())
        raise ValueError(
            f"{fn}: {shown} is past the tensor-core kernels' widths "
            f"{TILE_LIMITS}, and its wide kernel needs {need} bytes of "
            f"shared memory a block, above the {limit} a block may use")
    return "wide"


# (wrapper, route) -> the module's launch counter of that kernel
COUNTERS = {
    ("ipa_attention_fwd", "tc"): "launches",
    ("ipa_attention_bwd_dq", "tc"): "bwd_dq_launches",
    ("ipa_attention_bwd_dkv", "tc"): "bwd_dkv_launches",
    ("ipa_attention_bwd_pair", "tc"): "bwd_pair_launches",
    ("ipa_attention_fwd", "wide_tc"): "wide_tc_launches",
    ("ipa_attention_bwd_dq", "wide_tc"): "wide_tc_bwd_dq_launches",
    ("ipa_attention_bwd_dkv", "wide_tc"): "wide_tc_bwd_dkv_launches",
    ("ipa_attention_bwd_pair", "wide_tc"): "wide_tc_bwd_pair_launches",
    ("ipa_attention_fwd", "wide"): "wide_launches",
    ("ipa_attention_bwd_dq", "wide"): "wide_bwd_dq_launches",
    ("ipa_attention_bwd_dkv", "wide"): "wide_bwd_dkv_launches",
    ("ipa_attention_bwd_pair", "wide"): "wide_bwd_pair_launches",
}


def launcher(fn: str, route: str) -> tuple[str, str]:
    """(library, launcher) of wrapper ``fn``'s kernel on ``route``."""
    if route == "tc":
        return ("ipa_attention_fwd" if fn == "ipa_attention_fwd"
                else "ipa_attention_bwd"), fn
    return (WIDE_TC_KERNELS if route == "wide_tc" else WIDE_KERNELS)[fn][:2]


def _launch(fn: str, route: str, ptrs, F, Nq, Nk, H, C, Pq, Pv, Dz, c_qk,
            c_b, inf, device):
    """Launch wrapper ``fn``'s kernel on ``route`` on the current stream and
    count it; ``ptrs``: the inputs with the key mask after the mask, then
    the outputs."""
    lib_name, name = launcher(fn, route)
    lib = _lib(lib_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, name)(
        *ptrs, F, Nq, Nk, H, C, Pq, Pv, Dz, float(c_qk), float(c_b),
        float(inf),
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(rc).decode()} (code {rc})")
    counter = COUNTERS[(fn, route)]
    globals()[counter] += 1


def input_shapes(F, Nq, Nk, H, C, P3q, P3v, Dz, points) -> dict:
    """The shape of each of ``INPUT_NAMES`` and of ``key_mask`` in a call of
    Nq query rows against Nk keys; points [..., P, 3] (``points`` True:
    the forward's layout) or [..., P*3] (the backward kernels')."""
    def pts(n, p3):
        return (F, n, H, p3 // 3, 3) if points else (F, n, H, p3)

    return {
        "q": (F, Nq, H, C), "k": (F, Nk, H, C), "v": (F, Nk, H, C),
        "q_pts": pts(Nq, P3q), "k_pts": pts(Nk, P3q), "v_pts": pts(Nk, P3v),
        "bias": (Nq, Nk, H), "pair_z": (Nq, Nk, Dz), "mask": (F, Nq),
        "key_mask": (F, Nk), "head_weights": (H,),
    }


def ipa_attention_fwd(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                      head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5,
                      key_mask=None):
    """Fused IPA attention forward (no autograd).

    q [F, Nq, H, C], k, v [F, Nk, H, C]; q_pts [F, Nq, H, Pq, 3], k_pts
    [F, Nk, H, Pq, 3] and v_pts [F, Nk, H, Pv, 3] in the global frame; bias
    [Nq, Nk, H] and pair_z [Nq, Nk, Dz] shared by the frames; mask [F, Nq];
    key_mask [F, Nk] (None: the square call, Nq = Nk, ``mask`` for both);
    head_weights [H] (already softplus'ed and scaled). Returns
    (o [F, Nq, H, C], o_pt [F, Nq, H, Pv, 3], o_pair [F, Nq, H, Dz],
    lse [F, H, Nq]), all float32.
    """
    args = (q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights)
    key_mask = mask if key_mask is None else key_mask
    device = _device_of("ipa_attention", args + (key_mask,))
    if device.type == "cpu":
        return ipa_attention_plain(*args, c_qk, c_b=c_b, inf=inf,
                                   key_mask=key_mask)

    F, N, H, C = q.shape
    Nk = k.shape[1]
    Pq, Pv, Dz = q_pts.shape[-2], v_pts.shape[-2], pair_z.shape[-1]
    expected = input_shapes(F, N, Nk, H, C, 3 * Pq, 3 * Pv, Dz, points=True)
    _check_kernel_inputs("ipa_attention", dict(zip(INPUT_NAMES, args),
                                               key_mask=key_mask),
                         expected, C)
    route = kernel_route("ipa_attention_fwd", C, 3 * Pq, 3 * Pv, Dz)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("ipa_attention: q, k and v must be 16-byte aligned")

    o = torch.empty((F, N, H, C), dtype=torch.float32, device=device)
    o_pt = torch.empty((F, N, H, Pv, 3), dtype=torch.float32, device=device)
    o_pair = torch.empty((F, N, H, Dz), dtype=torch.float32, device=device)
    lse = torch.empty((F, H, N), dtype=torch.float32, device=device)
    operands = args[:9] + (key_mask,) + args[9:] + (o, o_pt, o_pair, lse)
    _launch("ipa_attention_fwd", route, [t.data_ptr() for t in operands],
            F, N, Nk, H, C, Pq, Pv, Dz, c_qk, c_b, inf, device)
    return o, o_pt, o_pair, lse


BWD_INPUT_NAMES = INPUT_NAMES + ("lse", "dvec", "g_o", "g_opt", "g_pair")


def _bwd_call(fn: str, plain, out_shapes, inputs, c_qk, c_b, inf, key_mask):
    """Run backward kernel ``fn`` (or ``plain`` on the CPU) on the 15
    backward inputs (points flattened to P*3) and the key mask (None: the
    square call); ``out_shapes(F, Nq, Nk, H, C, P3q, P3v, Dz)`` gives the
    shapes of its outputs."""
    key_mask = inputs[8] if key_mask is None else key_mask
    device = _device_of(fn, tuple(inputs) + (key_mask,))
    if device.type == "cpu":
        return plain(*inputs, c_qk=c_qk, c_b=c_b, inf=inf,
                     key_mask=key_mask)
    q, k, q_pts, v_pts, pair_z = (inputs[0], inputs[1], inputs[3], inputs[5],
                                  inputs[7])
    F, N, H, C = q.shape
    Nk = k.shape[1]
    P3q, P3v, Dz = q_pts.shape[-1], v_pts.shape[-1], pair_z.shape[-1]
    if P3q % 3 or P3v % 3:
        raise ValueError(f"{fn}: point widths {P3q}, {P3v} are not P*3")
    expected = dict(
        input_shapes(F, N, Nk, H, C, P3q, P3v, Dz, points=False),
        lse=(F, H, N), dvec=(F, H, N), g_o=(F, N, H, C), g_opt=(F, N, H, P3v),
        g_pair=(F, N, H, Dz))
    named = dict(zip(BWD_INPUT_NAMES, inputs), key_mask=key_mask)
    _check_kernel_inputs(fn, named, expected, C)
    route = kernel_route(fn, C, P3q, P3v, Dz)
    if any(named[n].data_ptr() % 16 for n in ("q", "k", "v", "g_o")):
        raise ValueError(f"{fn}: q, k, v and g_o must be 16-byte aligned")
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in out_shapes(F, N, Nk, H, C, P3q, P3v, Dz)]
    operands = tuple(inputs[:9]) + (key_mask,) + tuple(inputs[9:]) + tuple(outs)
    _launch(fn, route, [t.data_ptr() for t in operands],
            F, N, Nk, H, C, P3q // 3, P3v // 3, Dz, c_qk, c_b, inf, device)
    return tuple(outs)


def ipa_attention_bwd_dq(*inputs, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5,
                         key_mask=None):
    """Kernel A on the backward inputs (``BWD_INPUT_NAMES``, points
    [F, N, H, P*3], lse and dvec [F, H, Nq]) and the key mask (None: the
    square call): (dq, dqp, dhw_rows [F, H, Nq])."""
    return _bwd_call(
        "ipa_attention_bwd_dq", ipa_bwd_dq_plain,
        lambda F, Nq, Nk, H, C, P3q, P3v, Dz: ((F, Nq, H, C),
                                               (F, Nq, H, P3q), (F, H, Nq)),
        inputs, c_qk, c_b, inf, key_mask)


def ipa_attention_bwd_dkv(*inputs, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5,
                          key_mask=None):
    """Kernel B on the backward inputs: (dk, dkp, dv, dvp), each [F, Nk, ...]
    and summed over the Nq query rows."""
    return _bwd_call(
        "ipa_attention_bwd_dkv", ipa_bwd_dkv_plain,
        lambda F, Nq, Nk, H, C, P3q, P3v, Dz: ((F, Nk, H, C),
                                               (F, Nk, H, P3q),
                                               (F, Nk, H, C),
                                               (F, Nk, H, P3v)),
        inputs, c_qk, c_b, inf, key_mask)


def ipa_attention_bwd_pair(*inputs, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5,
                           key_mask=None):
    """Kernel C on the backward inputs: (dbias [Nq, Nk, H],
    dpz [Nq, Nk, Dz])."""
    return _bwd_call(
        "ipa_attention_bwd_pair", ipa_bwd_pair_plain,
        lambda F, Nq, Nk, H, C, P3q, P3v, Dz: ((Nq, Nk, H), (Nq, Nk, Dz)),
        inputs, c_qk, c_b, inf, key_mask)


def backward_inputs(saved, g_o, g_opt, g_pair):
    """The 15 backward-kernel inputs from the forward's saved tensors
    (the 10 inputs, then o, o_pt, o_pair, lse) and the output cotangents:
    every cotangent made contiguous float32 (those reaching o_pt through
    the model's xyz unbinding arrive as strided views), points flattened to
    P*3, and D = <g, out> per (f, h, i) as ``_ipa_attention_bwd``
    (:583-587) computes it."""
    (q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
     o, o_pt, o_pair, lse) = saved
    F, N, H = q.shape[:3]  # the query rows
    Nk = k.shape[1]
    g_o = g_o.float().contiguous()
    g_opt = g_opt.float().reshape(F, N, H, -1).contiguous()
    g_pair = g_pair.float().contiguous()
    dvec = (torch.sum(g_o * o, -1)
            + torch.sum(g_opt * o_pt.reshape(F, N, H, -1), -1)
            + torch.sum(g_pair * o_pair, -1))  # [F, N, H]
    return (q, k, v, q_pts.reshape(F, N, H, -1), k_pts.reshape(F, Nk, H, -1),
            v_pts.reshape(F, Nk, H, -1), bias, pair_z, mask, head_weights,
            lse, dvec.transpose(1, 2).contiguous(), g_o, g_opt, g_pair)


class IPAAttention(torch.autograd.Function):
    """Differentiable fused IPA attention: ``ipa_attention_fwd`` forward,
    the three backward kernels from the saved row LSE, so training memory
    stays O(tile), never O(F·H·N²)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                head_weights, c_qk, c_b, inf, key_mask):
        o, o_pt, o_pair, lse = ipa_attention_fwd(
            q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights,
            c_qk, c_b=c_b, inf=inf, key_mask=key_mask)
        ctx.save_for_backward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z,
                              mask, head_weights, o, o_pt, o_pair, lse,
                              key_mask)
        ctx.consts = (c_qk, c_b, inf)
        ctx.mark_non_differentiable(lse)
        return o, o_pt, o_pair, lse

    @staticmethod
    def backward(ctx, g_o, g_opt, g_pair, _g_lse):
        c_qk, c_b, inf = ctx.consts
        saved = ctx.saved_tensors  # unpacked once (remat allows no more)
        saved, key_mask = saved[:14], saved[14]
        inputs = backward_inputs(saved, g_o, g_opt, g_pair)
        kw = dict(c_qk=c_qk, c_b=c_b, inf=inf, key_mask=key_mask)
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
                dhw.to(head_weights.dtype), None, None, None, None)


def ipa_attention(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                  head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5,
                  key_mask=None):
    """Differentiable fused IPA attention (``IPAAttention``); arguments and
    results as ``ipa_attention_fwd``. The lse output carries no gradient;
    in a rectangular call dk, dv and their points' gradients are this
    call's rows' share, and the masks none."""
    return IPAAttention.apply(q, k, v, q_pts, k_pts, v_pts, bias, pair_z,
                              mask, head_weights, c_qk, c_b, inf,
                              mask if key_mask is None else key_mask)
