"""The yardstick's arithmetic: published peaks, and the operations and
compulsory bytes of the ops whose roofline share the benchmark reports.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at its 700 W limit).
A configuration's compute dtype picks the arithmetic peak, and every
float32 product is held to the TF32 tensor-core rate: the card runs no
float32 product faster, so no implementation can read over 100%.

The op counts are frozen here so that a later change to the program cannot
move its own bar: ``gated_attention_cost`` is the count the repository's
``chip_smoke.geom_cost`` makes. Bytes are the op's compulsory traffic:
each input tensor read once and each output written once, in the dtypes
the call passes.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12  # HBM3


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the arithmetic
    time at the dtype's peak and the bytes at the memory rate."""
    return max(ops / peak_flops(dtype), nbytes / PEAK_BYTES)


def gated_attention_cost(B, R, H, Lq, L, d, c) -> float:
    """Operations of one gated attention of the GeoFormer (the count of
    ``chip_smoke.geom_cost``, from the call's shapes): the q|gate
    projection of Lq rows and the k|v projection of L rows, the two
    Lq x L x c contractions, ~4 elementwise operations a logit and ~4 an
    output element."""
    G = R * H
    ew = B * G * (4 * Lq * L + 4 * Lq * c)
    return B * G * (2 * (Lq + L) * d * 2 * c + 4 * Lq * L * c) + ew


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "element_size"))
