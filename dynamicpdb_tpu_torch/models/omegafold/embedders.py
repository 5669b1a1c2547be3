"""OmegaFold input and recycle embedders.

Port of ``dynamicpdb_tpu/models/omegafold/embedders.py``: the edge
embedder (per-token i/j embeddings plus the AF2 relative position) and the
recycle embedder (LayerNormed previous node/edge plus the distogram of the
previous cycle's pseudo-beta atoms). Parameter names are the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from dynamicpdb_tpu_torch.models.omegafold.atoms import tables
from dynamicpdb_tpu_torch.models.omegafold.core import (
    LayerNorm,
    relpos_embedding,
)


class EdgeEmbedder(nn.Module):
    def __init__(self, alphabet_size: int, edge_dim: int, relpos_len: int,
                 device=None):
        super().__init__()
        self.proj_i = nn.Embedding(alphabet_size, edge_dim, device=device)
        self.proj_j = nn.Embedding(alphabet_size, edge_dim, device=device)
        self.relpos = nn.Embedding(2 * relpos_len + 1, edge_dim, device=device)

    def forward(self, fasta, out):
        """fasta [L] tokens; adds into out [L, L, edge_dim]."""
        out = out + self.proj_i.weight[fasta][:, None]
        out = out + self.proj_j.weight[fasta][None, :]
        return out + relpos_embedding(self.relpos.weight, fasta.shape[-1])


def create_pseudo_beta(atom14_pos, atom14_mask):
    """CB where the residue has one, else CA (atom14: N CA C O CB ...)."""
    has_cb = atom14_mask[..., 4:5] > 0
    return torch.where(has_cb, atom14_pos[..., 4, :], atom14_pos[..., 1, :])


# the distogram's first and last bin edges (Angstrom), reference constants
FIRST_BREAK, LAST_BREAK = 3.25, 20.75


class RecycleEmbedder(nn.Module):
    def __init__(self, node_dim: int, edge_dim: int, num_bins: int,
                 device=None):
        super().__init__()
        self.layernorm_node = LayerNorm(node_dim, device=device)
        self.layernorm_edge = LayerNorm(edge_dim, device=device)
        self.prev_pos_embed = nn.Embedding(num_bins, edge_dim, device=device)

    def forward(self, fasta, prev_node, prev_edge, prev_x, node_repr,
                edge_repr):
        """Adds the previous cycle into node_repr [M, L, d] (row 0 only)
        and edge_repr [L, L, de]."""
        atom_mask = tables(fasta.device)["restype2atom_mask"][fasta]
        beta = create_pseudo_beta(prev_x, atom_mask)
        d = torch.linalg.norm(beta[:, None] - beta[None, :], dim=-1)
        breaks = torch.linspace(FIRST_BREAK, LAST_BREAK,
                                self.prev_pos_embed.num_embeddings - 1,
                                device=d.device)
        bins = (d[..., None] > breaks).sum(-1)
        node_repr = torch.cat([node_repr[:1] + self.layernorm_node(prev_node),
                               node_repr[1:]])
        edge_repr = edge_repr + self.prev_pos_embed.weight[bins]
        return node_repr, edge_repr + self.layernorm_edge(prev_edge)
