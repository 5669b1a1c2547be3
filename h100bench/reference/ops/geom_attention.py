"""The GeoFormer's two gated attentions in plain PyTorch: frozen copies of
the port's plain versions, under the wrapper names the GeoFormer calls."""
from __future__ import annotations

import torch


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


fused_gated_geom_attention_t = geom_attention_plain
fused_gated_node_attention = node_attention_plain
