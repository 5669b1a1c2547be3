"""Invariant Point Attention forward: the CUDA kernel and its plain version.

``ipa_attention`` replaces the Pallas TPU kernel
``dynamicpdb_tpu/ops/pallas/ipa_attention.py:39 _ipa_attn_kernel`` (launched
by ``fused_ipa_attention`` :123). For CUDA tensors it launches the
hand-written kernel in ``csrc/ipa_attention_fwd.cu`` (built by ``nvcc``,
loaded with ``ctypes``); for CPU tensors it runs ``ipa_attention_plain``,
the same function in plain PyTorch. Nothing falls back from one to the
other: a CUDA call that the kernel cannot take raises.

Bound on an H100: about 1.2 kFLOP per (frame, head, query, key), 1.28
GFLOP per call at the release shapes, against about 30 MB of compulsory
traffic, so float32 arithmetic bounds it (about 19 us at 67 TFLOP/s outside
the tensor cores; the bytes take about 9 us). The first design keeps every
N x N quantity in shared memory and registers (an online softmax over key
tiles), so traffic stays near the compulsory bytes; it runs on the CUDA
cores in float32, and the tensor cores are left for a later version.

``launches`` counts the kernel launches of this process; a run that must
show the kernel was on its path sets it to 0 before and reads it after.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

launches = 0


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


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, with every
    argument typed (pointers and the stream as c_void_p)."""
    from dynamicpdb_tpu_torch.ops import _build

    lib = _build.load("ipa_attention_fwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ipa_attention_fwd.argtypes = [p] * 14 + [i] * 7 + [f] * 3 + [i, p]
    lib.ipa_attention_fwd.restype = i
    lib.ipa_attention_error_string.argtypes = [i]
    lib.ipa_attention_error_string.restype = ctypes.c_char_p
    return lib


def ipa_attention(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask,
                  head_weights, c_qk, c_b=math.sqrt(1.0 / 3), inf=1e5):
    """Fused IPA attention forward.

    q, k, v [F, N, H, C]; q_pts, k_pts [F, N, H, Pq, 3] and v_pts
    [F, N, H, Pv, 3] in the global frame; bias [N, N, H] and pair_z
    [N, N, Dz] shared by the frames; mask [F, N]; head_weights [H] (already
    softplus'ed and scaled). Returns (o [F, N, H, C], o_pt [F, N, H, Pv, 3],
    o_pair [F, N, H, Dz], lse [F, H, N]), all float32.
    """
    global launches
    args = (q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"ipa_attention: tensors on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return ipa_attention_plain(*args, c_qk, c_b=c_b, inf=inf)
    if device.type != "cuda":
        raise ValueError(f"ipa_attention: unsupported device {device}")

    F, N, H, C = q.shape
    Pq, Pv, Dz = q_pts.shape[-2], v_pts.shape[-2], pair_z.shape[-1]
    expected = {
        "q": (F, N, H, C), "k": (F, N, H, C), "v": (F, N, H, C),
        "q_pts": (F, N, H, Pq, 3), "k_pts": (F, N, H, Pq, 3),
        "v_pts": (F, N, H, Pv, 3), "bias": (N, N, H), "pair_z": (N, N, Dz),
        "mask": (F, N), "head_weights": (H,),
    }
    for (name, shape), t in zip(expected.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"ipa_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"ipa_attention: {name} is {t.dtype}, the kernel "
                            "takes float32")
        if not t.is_contiguous():
            raise ValueError(f"ipa_attention: {name} is not contiguous")
    if C % 4:
        raise ValueError(f"ipa_attention: C={C} is not a multiple of 4")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("ipa_attention: q, k and v must be 16-byte aligned")

    o = torch.empty((F, N, H, C), dtype=torch.float32, device=device)
    o_pt = torch.empty((F, N, H, Pv, 3), dtype=torch.float32, device=device)
    o_pair = torch.empty((F, N, H, Dz), dtype=torch.float32, device=device)
    lse = torch.empty((F, H, N), dtype=torch.float32, device=device)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.ipa_attention_fwd(
        *(t.data_ptr() for t in args + (o, o_pt, o_pair, lse)),
        F, N, H, C, Pq, Pv, Dz, float(c_qk), float(c_b), float(inf),
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ipa_attention_fwd launch failed: "
            f"{lib.ipa_attention_error_string(rc).decode()} (code {rc})"
        )
    launches += 1
    return o, o_pt, o_pair, lse
