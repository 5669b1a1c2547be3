"""The operations and compulsory bytes of the AlphaFold2 cell's kernel
calls, from their shapes: the arithmetic of ``kernels_roofline.af2``.

Each call is found by its program span (``ops.node_attention``,
``ops.geom_attention``, ``ops.geom_triangle``) and its shape by the
``alphafold.*`` span around it and the configuration: MSA row attention
is node attention over the clusters' rows, MSA column attention node
attention over the MSA's transpose, triangle attention the one-axis
geometric attention, a triangle multiplication the single-view triangle
route. Operations: ``costs.gated_attention_cost`` for the attentions; for
the triangle route its products (the four projections of the two
operands, the L^3 d product, the gate's and the output's projections),
2 operations a multiply-add. Bytes: each input read once and each output
written once, float32 (the weights as the kernels read them). A float32
product is held to the TF32 tensor-core rate (``costs``), so no route
reads over 100%.
"""
from __future__ import annotations

from h100bench import costs

F32 = 4


def node_attention(M: int, Lq: int, L: int, H: int, d: int, c: int):
    """(ops, bytes) of ``fused_gated_node_attention``: M rows of L keys,
    Lq query rows each, a bias [H, Lq, L] shared by the rows."""
    ops = costs.gated_attention_cost(M, 1, H, Lq, L, d, c)
    nbytes = F32 * (M * L * d + 2 * (d * H * 2 * c + H * 2 * c)
                    + H * Lq * L + M * L + M * H * Lq * c)
    return ops, nbytes


def geom_attention(B: int, H: int, L: int, d: int, c: int):
    """(ops, bytes) of ``fused_gated_geom_attention_t`` with one axis: B
    rows of L entries attending among themselves, a bias [H, L, L]."""
    ops = costs.gated_attention_cost(B, 1, H, L, L, d, c)
    nbytes = F32 * (B * L * d + 2 * (d * H * 2 * c + H * 2 * c)
                    + H * L * L + B * H * L * c)
    return ops, nbytes


def triangle_view(L: int, d: int):
    """(ops, bytes) of ``geom_triangle_view``: the value and gate
    projections of both operands (two [L^2, d] x [d, 2d] products), the
    L^3 d triangle product, the gate's and the output's [L^2, d] x [d, d]
    products; the normalised and the residual pair tensor read, the result
    written, the weights read."""
    ops = 2 * (2 * L * L * d * 2 * d) + 2 * d * L ** 3 + 2 * (2 * L * L * d * d)
    nbytes = F32 * (3 * L * L * d + d * 5 * d + 5 * d + d * d + d + L)
    return ops, nbytes


def call_bound_s(parent: str, config: dict, counters: dict) -> float | None:
    """The least time of one kernel call under the ``alphafold.*`` span
    ``parent``; None for a span that holds no kernel call."""
    L, M = counters["n_res"], counters["msa_clusters"]
    H, c, d = config["msa_heads"], config["msa_head_dim"], config["msa_dim"]
    if parent == "alphafold.msa_row_attention":
        ops, nbytes = node_attention(M, L, L, H, d, c)
    elif parent == "alphafold.msa_column_attention":
        ops, nbytes = node_attention(L, M, M, H, d, c)
    elif parent == "alphafold.triangle_attention":
        ops, nbytes = geom_attention(L, config["pair_heads"], L,
                                     config["pair_dim"],
                                     config["pair_head_dim"])
    elif parent == "alphafold.triangle_multiplication":
        ops, nbytes = triangle_view(L, config["pair_dim"])
    else:
        return None
    return costs.bound_s(ops, nbytes, config["compute_dtype"])
