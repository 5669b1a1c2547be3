"""OmegaPLM, the protein language model of OmegaFold.

Port of ``dynamicpdb_tpu/models/omegafold/plm.py``: token embedding with
the token-dropout rescale, a stack of pre-LayerNorm gated attention units
(66 at the release width) and an output LayerNorm. Each layer's attention
map, summed over the pseudo-MSA rows, is one channel of the edge
representation. Parameter names are the reference's (``input_embedding``,
``layers.{i}.gau``, ``output_norm``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from dynamicpdb_tpu_torch.models.omegafold.core import (
    GatedAttentionUnit,
    LayerNorm,
    gau_qk_scaling,
    layer_norm_f32,
)


@dataclass(frozen=True)
class PLMConfig:
    alphabet_size: int = 23
    node: int = 1280
    num_layers: int = 66  # the reference names this cfg.edge
    proj_dim: int = 2560
    attn_dim: int = 256
    num_relpos: int = 129
    masked_ratio: float = 0.12


class OmegaPLMLayer(nn.Module):
    def __init__(self, cfg: PLMConfig, device=None):
        super().__init__()
        self.gau = GatedAttentionUnit(cfg.node, cfg.proj_dim, cfg.attn_dim,
                                      cfg.num_relpos, device=device)


class OmegaPLM(nn.Module):
    def __init__(self, cfg: PLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.alphabet_size, cfg.node,
                                            device=device)
        self.layers = nn.ModuleList(
            OmegaPLMLayer(cfg, device=device) for _ in range(cfg.num_layers))
        self.output_norm = LayerNorm(cfg.node, device=device)

    def _finetuning_scale(self, mask, tokens):
        """Token-dropout rescale over the mask token (21); the sums are
        float32 so a bfloat16 mask keeps integer counts past 256 residues."""
        src_len = mask.sum(-1, dtype=torch.float32)
        observed = (tokens == 21).sum(-1).float() / src_len
        observed = torch.where(observed == 1.0, torch.full_like(observed, 0.99),
                               observed)
        return ((1 - self.cfg.masked_ratio) / (1 - observed))[:, None, None]

    def forward(self, tokens, mask):
        """tokens, mask [M, L] -> (node [M, L, node], edges [layers, L, L])."""
        qk_scaling = gau_qk_scaling(mask.sum(-1, dtype=torch.float32),
                                    self.cfg.attn_dim)[..., None, None]
        bias = (mask[..., None, :].float() - 1.0) * 1e9  # [M, 1, L]
        node = self.input_embedding(tokens)
        node = (node * self._finetuning_scale(mask, tokens)).to(node.dtype)
        edges = []
        for layer in self.layers:
            update, edge = layer.gau(layer_norm_f32(node), qk_scaling, bias)
            node = node + update
            edges.append(edge)
        node = self.output_norm(node)
        edges = torch.stack(edges)
        return node, edges / (mask.any(-1).sum() + 1e-5)
