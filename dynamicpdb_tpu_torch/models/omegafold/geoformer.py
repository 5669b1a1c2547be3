"""The GeoFormer trunk of OmegaFold.

Port of ``dynamicpdb_tpu/models/omegafold/geoformer.py``: gated multi-axis
attention, attention with edge bias, parameter-free pre-LN transitions, the
node -> edge outer product, and the two-axis geometric attention over the
edge tensor. Modules carry the reference OmegaFold's parameter names and
layouts, so a reference state dict loads strictly.

Both fused attentions of the JAX package run here on every call: a CUDA
tensor launches the hand-written kernels of ``ops/geom_attention.py``, a
CPU tensor runs their plain versions. The JAX package's ``flash`` switch
and its ``MAX_FLASH_RES`` bound (a TPU VMEM limit) have no counterpart: the
kernels tile the keys and take every length.

Sequence parallelism (``parallel/sp.py``; JAX ``geoformer.py:315-353``,
where GSPMD partitions the dense path and the Pallas kernel is bypassed):
node holds this rank's residues [M, Lr, d], edge its query rows
[Lr, L, de], the mask [M, L] stays whole. Per block, the collectives are
  * attention with edge bias: the normalised node gathered for the keys
    (``gather_rows``), the rectangular ``node_attention`` on the rows;
  * the outer product: its right half gathered, so out[i, j] is whole for
    this rank's i;
  * each geometric attention: the normalised edge gathered whole, the
    bias b [2, H, L, L] gathered whole (every row attends over all of it;
    ``geom_attention`` takes the rank's rows as its batch rows), and the
    column view of the column branch's output (``column_view``, an
    all-to-all). The triangle product needs act_col of every residue j,
    made from edge row j and edge column j: the rank gathers the
    normalised edge (L^2 de numbers) rather than act_col itself (2 L^2 de)
    and projects every j's act_col from it (``ops/geom_triangle``: in one
    launch on the card, a row block at a time on the CPU); the whole edge
    also gives the rank its rows of the column view. Against an
    all-to-all column view of the edge and a gathered act_col, a rank
    receives half the numbers, in three collectives instead of four;
  * column attention and the transitions are local.
Outside a 'seq' mesh every collective is the identity and every rank view
the whole, and the code computes what one process computed before.

The JAX module's flax-free ``*Params`` pytrees and their ``*_from_torch``
converters are the modules' own parameters here (the reference state
dict loads as it is); its ``geoformer`` function is ``GeoFormer``'s
forward.
"""
from __future__ import annotations

import torch
from torch import nn

from dynamicpdb_tpu_torch.models.omegafold.core import attention, linear
from dynamicpdb_tpu_torch.models.omegafold.core import layer_norm_f32 as _normalize
from dynamicpdb_tpu_torch.ops.geom_attention import (
    fused_gated_geom_attention_t,
    fused_gated_node_attention,
)
from dynamicpdb_tpu_torch.ops.geom_triangle import geom_triangle
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.utils.logging import span


def _mask2bias(mask, inf=1e9):
    return (mask.float() - 1.0) * inf


class Attention(nn.Module):
    """Gated multi-axis attention weights (reference ``modules.Attention``;
    OmegaFold gates every one of them)."""

    def __init__(self, q_dim: int, kv_dim: int, n_axis: int, n_head: int,
                 c: int, out_dim: int, device=None):
        super().__init__()
        self.c, self.n_axis, self.q_dim = c, n_axis, q_dim
        self.qg_weights = nn.Parameter(
            torch.zeros(q_dim, n_axis, n_head, 2 * c, device=device))
        self.kv_weights = nn.Parameter(
            torch.zeros(kv_dim, n_axis, n_head, 2 * c, device=device))
        self.qg_bias = nn.Parameter(
            torch.zeros(n_axis, n_head, 1, 2 * c, device=device))
        self.kv_bias = nn.Parameter(
            torch.zeros(n_axis, n_head, 1, 2 * c, device=device))
        self.o_weights = nn.Parameter(
            torch.zeros(n_axis, n_head, c, out_dim, device=device))
        self.o_bias = nn.Parameter(torch.zeros(out_dim, n_axis, device=device))


def gated_attention(p: Attention, q_inputs, kv_inputs, bias):
    """q_inputs/kv_inputs (*, len, dim[, n_axis]); bias broadcastable to
    (*, n_axis, H, q_len, kv_len)."""
    c = p.c
    to_unsqueeze = (q_inputs.shape[-1] != p.n_axis
                    and q_inputs.shape[-1] == p.q_dim)
    if to_unsqueeze:
        q_inputs, kv_inputs = q_inputs[..., None], kv_inputs[..., None]
        if bias is not None:
            bias = bias.unsqueeze(-4)
    dt = p.qg_weights.dtype
    qg = torch.einsum("...qar,arhc->...rhqc", q_inputs.to(dt),
                      p.qg_weights) + p.qg_bias
    kv = torch.einsum("...kar,arhc->...rhkc", kv_inputs.to(dt),
                      p.kv_weights) + p.kv_bias
    out, _ = attention(qg[..., :c], kv[..., :c], c ** (-0.5), kv[..., c:],
                       bias)
    out = _attn_out_proj(out * torch.sigmoid(qg[..., c:]), p)
    return out[..., 0] if to_unsqueeze else out


def _attn_out_proj(out, p: Attention):
    """Per-axis output projection [..., r, h, q, c] -> [..., q, out, r]."""
    return torch.einsum("...rhqc,rhco->...qor", out.to(p.o_weights.dtype),
                        p.o_weights) + p.o_bias


class AttentionWEdgeBias(nn.Module):
    def __init__(self, d_node: int, d_edge: int, n_head: int, c: int,
                 device=None):
        super().__init__()
        self.proj_edge_bias = nn.Linear(d_edge, n_head, device=device)
        self.attention = Attention(d_node, d_node, 1, n_head, c, d_node,
                                   device=device)


def attention_w_edge_bias(p: AttentionWEdgeBias, node, edge, mask):
    """node [M, Lr, d]; edge [Lr, L, de] (this rank's rows; Lr = L outside
    sequence parallelism); mask [M, L], the full pseudo-MSA mask: each row
    masks its own keys. The edge bias [H, Lr, L] is shared by the
    pseudo-MSA rows and the row's key mask is applied in the kernel."""
    a = p.attention
    L = mask.shape[-1]
    node = sp.gather_rows(_normalize(node), L, dim=1)  # every residue's keys
    edge_bias = linear(p.proj_edge_bias, _normalize(edge)).permute(2, 0, 1)
    out = fused_gated_node_attention(
        node, a.qg_weights, a.qg_bias, a.kv_weights, a.kv_bias, edge_bias,
        mask, c=a.c, scale=a.c ** (-0.5),
        q0=sp.row_range(L)[0])  # [M, H, Lr, c], gated
    return _attn_out_proj(out[:, None], a)[..., 0]


class Transition(nn.Module):
    def __init__(self, d: int, multiplier: int, device=None):
        super().__init__()
        self.network = nn.Sequential(
            nn.Linear(d, d * multiplier, device=device), nn.ReLU(),
            nn.Linear(d * multiplier, d, device=device))


def transition(p: Transition, x):
    h = torch.relu(linear(p.network[0], _normalize(x)))
    return linear(p.network[2], h)


class Node2Edge(nn.Module):
    def __init__(self, d_node: int, proj: int, d_edge: int, device=None):
        super().__init__()
        self.input_proj = nn.Linear(d_node, 2 * proj, device=device)
        self.out_weights = nn.Parameter(
            torch.zeros(proj, proj, d_edge, device=device))
        self.out_bias = nn.Parameter(torch.zeros(d_edge, device=device))


def node2edge(p: Node2Edge, node, mask):
    """node [M, Lr, d] (this rank's residues); mask [M, L]: masked mean
    outer product over the pseudo-MSA rows, [Lr, L, d_edge]."""
    proj = p.out_weights.shape[0]
    L = mask.shape[-1]
    act = linear(p.input_proj, _normalize(node))
    m_all = mask[..., None].to(act.dtype)
    m = sp.take_rows(m_all, L, 1)
    act = act * m
    norm = torch.einsum("sid,sjd->ijd", m, m_all)
    left = act[..., :proj]
    right = sp.gather_rows(act[..., proj:], L, dim=1)
    out = torch.einsum("sid,def->sief", left, p.out_weights)
    out = torch.einsum("sief,sje->ijf", out, right) + p.out_bias
    return out / (norm + 1e-3)


class GeometricAttention(nn.Module):
    def __init__(self, d_edge: int, n_head: int, c: int, device=None):
        super().__init__()
        self.linear_b_weights = nn.Parameter(
            torch.zeros(d_edge, 2, n_head, device=device))
        self.linear_b_bias = nn.Parameter(
            torch.zeros(2, n_head, 1, 1, device=device))
        self.act_w = nn.Parameter(torch.zeros(d_edge, 2, 5 * d_edge,
                                              device=device))
        self.act_b = nn.Parameter(torch.zeros(2, 5 * d_edge, device=device))
        self.out_proj_w = nn.Parameter(torch.zeros(2, d_edge, d_edge,
                                                   device=device))
        self.out_proj_b = nn.Parameter(torch.zeros(2, d_edge, device=device))
        self.attention = Attention(d_edge, d_edge, 2, n_head, c, d_edge,
                                   device=device)


def geometric_attention(p: GeometricAttention, edge, mask, *,
                        pad_safe: bool = False):
    """edge [Lr, L, d], this rank's rows (all L outside sequence
    parallelism); mask [L]. Returns the residual update [Lr, L, d].

    The reference builds the attended branch's mask bias and then
    overwrites it, so its mask never reaches that branch; that is kept.
    ``pad_safe=True`` restores the key masking there and masks the
    triangle product's summed-out axis, so that padding cannot perturb
    real positions; with an all-ones mask it changes nothing."""
    L = mask.shape[-1]
    edge = _normalize(edge)
    whole = sp.gather_rows(edge, L, dim=0)  # [L, L, d]; edge itself at S 1
    cols = whole.transpose(0, 1)  # the column view: cols[j, k] = whole[k, j]
    # axis-major [Lr, 2, L, d]: the row and column views, as the kernel
    # reads them; the kernel's batch rows are this rank's rows
    stacked = torch.stack([edge, sp.take_rows(cols, L, 0)], dim=-3)
    b = torch.einsum("qrkc,crh->rhqk", stacked, p.linear_b_weights)
    b = sp.gather_rows(b + p.linear_b_bias, L, dim=2)  # [2, H, L, L]
    if pad_safe:
        b = b + _mask2bias(mask)[None, None, None, :]
    a = p.attention
    out5 = fused_gated_geom_attention_t(
        stacked, a.qg_weights, a.qg_bias, a.kv_weights, a.kv_bias, b,
        c=a.c, scale=a.c ** (-0.5))  # [B, 2, H, L, c], gated
    attended = _attn_out_proj(out5, a)
    attended = attended[..., 0] + sp.column_view(attended[..., 1], L)

    # the triangle-multiplicative branch, added to the attended one
    return geom_triangle(edge, whole, attended, mask, p.act_w, p.act_b,
                         p.out_proj_w, p.out_proj_b, q0=sp.row_range(L)[0],
                         pad_safe=pad_safe)


class GeoFormerBlock(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        nd, ed = cfg.node_dim, cfg.edge_dim
        self.attention_w_edge_bias = AttentionWEdgeBias(
            nd, ed, cfg.attn_n_head, cfg.attn_c, device=device)
        self.column_attention = Attention(nd, nd, 1, cfg.attn_n_head,
                                          cfg.attn_c, nd, device=device)
        self.node_transition = Transition(nd, cfg.transition_multiplier,
                                          device=device)
        self.out_product = Node2Edge(nd, cfg.opm_dim, ed, device=device)
        self.geometric_attention = nn.ModuleList(
            GeometricAttention(ed, cfg.geom_head, cfg.geom_c, device=device)
            for _ in range(cfg.geom_count))
        self.edge_transition = Transition(ed, cfg.transition_multiplier,
                                          device=device)


def geoformer_block(p: GeoFormerBlock, node, edge, mask, *,
                    pad_safe: bool = False):
    """node [M, Lr, d_node]; edge [Lr, L, d_edge] (this rank's rows; Lr = L
    outside sequence parallelism); mask [M, L]. Each step runs under a
    span named for it (``utils.logging.span``)."""
    with span("omegafold.attention_w_edge_bias"):
        node = node + attention_w_edge_bias(p.attention_w_edge_bias, node,
                                            edge, mask)
    with span("omegafold.column_attention"):  # over the pseudo-MSA axis
        node_col = _normalize(node.transpose(0, 1))
        rows_mask = sp.take_rows(mask, mask.shape[-1], 1)
        col_bias = _mask2bias(rows_mask.T[..., None, None, :])
        node_col = gated_attention(p.column_attention, node_col, node_col,
                                   col_bias)
        node = node + node_col.transpose(0, 1).to(node.dtype)
    with span("omegafold.node_transition"):
        node = node + transition(p.node_transition, node)
    with span("omegafold.out_product"):
        edge = edge + node2edge(p.out_product, node, mask)
    with span("omegafold.geometric_attention"):
        for gp in p.geometric_attention:
            edge = edge + geometric_attention(
                gp, edge, mask[0], pad_safe=pad_safe).to(edge.dtype)
    with span("omegafold.edge_transition"):
        edge = edge + transition(p.edge_transition, edge)
    return node, edge


class GeoFormer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(GeoFormerBlock(cfg, device=device)
                                    for _ in range(cfg.geo_num_blocks))
        self.node_final_proj = nn.Linear(cfg.node_dim, cfg.struct.node_dim,
                                         device=device)

    def forward(self, node, edge, mask, *, pad_safe: bool = False):
        """node [M, Lr, d_node], edge [Lr, L, d_edge], mask [M, L] ->
        (node_repr, edge_repr, final_node [M, Lr, d_struct]), Lr = L
        outside sequence parallelism, else this rank's rows."""
        for block in self.blocks:
            node, edge = geoformer_block(block, node, edge, mask,
                                         pad_safe=pad_safe)
        return node, edge, linear(self.node_final_proj, node)
