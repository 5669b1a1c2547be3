"""OmegaFold core primitives and the OmegaPLM gated attention unit.

Port of ``dynamicpdb_tpu/models/omegafold/core.py``: biased softmax
attention with an optional edge return, RoPE, multi-headed scale-shift,
relative-position lookup, the GAU logits scaling, and the GAU itself as an
``nn.Module`` whose parameter names are the reference OmegaFold's
(``gva_proj.0``, ``multi_headed_scaling``, ``relpos``, ``output_proj``).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def layer_norm_f32(x, weight=None, bias=None, eps=1e-5,
                   unbiased: bool = False):
    """LayerNorm with its statistics in float32, the one normalisation
    behind every OmegaFold module. ``unbiased=True`` divides the variance
    by n - 1 (torch.var's default, which the reference's in-place
    normalize uses). The result has x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    sq = (xf - mean) ** 2
    if unbiased:
        var = sq.sum(-1, keepdim=True) / max(x.shape[-1] - 1, 1)
    else:
        var = sq.mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight + bias
    return y


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last dim with float32 statistics
    (parameters ``weight`` and ``bias``, as ``torch.nn.LayerNorm``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm_f32(x, self.weight, self.bias)


def linear(mod: nn.Linear, x):
    """``mod(x)`` with x cast to the layer's dtype (a float32 statistic
    or scale may have promoted x on the bfloat16 path)."""
    return mod(x.to(mod.weight.dtype))


def attention(query, key, scale, value, bias, *, return_edge: bool = False,
              edge_reduction_dim: int = 0):
    """softmax(scale * q @ k^T + bias) @ v; query [*, Q, d], key [*, K, d],
    value [*, K, dv], bias broadcastable to [*, Q, K]. With
    ``return_edge`` the weights summed over ``edge_reduction_dim`` are
    returned as well."""
    logits = torch.einsum("...id,...jd->...ij", query * scale, key)
    logits = logits + bias
    attn = torch.exp(logits - logits.amax(-1, keepdim=True))
    attn = attn / attn.sum(-1, keepdim=True)
    out = torch.einsum("...ij,...jd->...id", attn, value.to(attn.dtype))
    if return_edge:
        return out, attn.sum(edge_reduction_dim)
    return out, None


def rope(x, seq_dim: int):
    """Rotary position embedding over the flattened ``seq_dim``: the
    feature dim splits into halves (x1, x2) -> [x1 cos - x2 sin,
    x2 cos + x1 sin]."""
    half = x.shape[-1] // 2
    inv_freq = 10000.0 ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(x.shape[seq_dim], dtype=x.dtype, device=x.device)
    sinusoid = pos[:, None] * inv_freq[None, :]
    sin, cos = torch.sin(sinusoid), torch.cos(sinusoid)
    n_between = x.dim() - 1 - (seq_dim % x.dim()) - 1
    shape = (x.shape[seq_dim],) + (1,) * n_between + (half,)
    sin, cos = sin.reshape(shape), cos.reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def multi_headed_scaling(x, weight, bias, on_out_ready=None):
    """Elementwise scale-shift of x [..., d] into ``weight.shape[0]``
    copies (weight, bias [H, d]); returns a list of H tensors."""
    y = x[..., None, :] * weight + bias  # [..., H, d]
    if on_out_ready is not None:
        y = on_out_ready(y)
    return [y[..., h, :] for h in range(weight.shape[0])]


def relpos_embedding(table, num_res: int):
    """AF2 relative-position lookup: table [2*one_side + 1, dim] ->
    [num_res, num_res, dim]."""
    one_side = table.shape[0] // 2
    idx = torch.arange(num_res, device=table.device)
    rel = torch.clamp(idx[None, :] - idx[:, None], -one_side, one_side)
    return table[rel + one_side]


def gau_qk_scaling(num_res, attn_dim: int):
    """log(N) / (log(512) sqrt(d)) logits scaling, float32."""
    num_res = torch.as_tensor(num_res, dtype=torch.float32)
    return torch.log(torch.clamp(num_res, min=4e-5)) / (
        math.log(512) * attn_dim ** 0.5)


class MultiHeadedScaling(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_heads, dim, device=device))
        self.bias = nn.Parameter(torch.zeros(num_heads, dim, device=device))


class GatedAttentionUnit(nn.Module):
    """OmegaPLM GAU: fused gate/value/base projection with SiLU -> per-head
    scale-shift + RoPE -> biased attention (+ relpos scalar bias) -> gated
    output projection."""

    def __init__(self, node: int, proj_dim: int, attn_dim: int,
                 num_relpos: int, device=None):
        super().__init__()
        self.proj_dim, self.attn_dim = proj_dim, attn_dim
        self.gva_proj = nn.Sequential(  # the reference's key: gva_proj.0
            nn.Linear(node, 2 * proj_dim + attn_dim, device=device))
        self.multi_headed_scaling = MultiHeadedScaling(attn_dim, 2,
                                                       device=device)
        self.relpos = nn.Embedding(num_relpos, 1, device=device)
        self.output_proj = nn.Linear(proj_dim, node, device=device)

    def forward(self, node, scaling, bias):
        """node [..., L, node]; bias broadcastable to [..., L, L]. Returns
        (node update, edge [L, L] summed over the pseudo-MSA rows)."""
        gva = linear(self.gva_proj[0], node)
        gva = gva * torch.reciprocal(1 + torch.exp(-gva))  # SiLU
        p = self.proj_dim
        gates, values, base = gva[..., :p], gva[..., p:2 * p], gva[..., 2 * p:]
        mhs = self.multi_headed_scaling
        queries, keys = multi_headed_scaling(
            base, mhs.weight, mhs.bias,
            on_out_ready=lambda x: rope(x, x.dim() - 3))
        rel = relpos_embedding(self.relpos.weight, base.shape[-2])[..., 0]
        out, edge = attention(queries, keys, scaling, values, bias + rel,
                              return_edge=True, edge_reduction_dim=-3)
        return linear(self.output_proj, out * gates), edge
