"""OmegaFold input and recycle embedders.

Port of ``dynamicpdb_tpu/models/omegafold/embedders.py``: the edge
embedder (per-token i/j embeddings plus the AF2 relative position) and the
recycle embedder (LayerNormed previous node/edge plus the distogram of the
previous cycle's pseudo-beta atoms). Parameter names are the reference's.

Under sequence parallelism (``parallel/sp.py``) the edge tensors hold this
rank's query rows, [Lr, L, .], and the node this rank's residues: both
embedders add the rows' terms (relative positions from q0, the pseudo-beta
distances of the rows against all L, from the whole previous atoms).

The JAX module's ``EdgeEmbedderParams`` and ``RecycleEmbedderParams``
pytrees, their functions and their ``*_from_torch`` converters are the
``EdgeEmbedder`` and ``RecycleEmbedder`` modules here, which load the
reference state dict as it is.
"""
from __future__ import annotations

import torch
from torch import nn

from h100bench.reference.models.omegafold.atoms import tables
from h100bench.reference.models.omegafold.core import (
    LayerNorm,
    relpos_embedding,
)
from h100bench.reference.parallel import sp


class EdgeEmbedder(nn.Module):
    def __init__(self, alphabet_size: int, edge_dim: int, relpos_len: int,
                 device=None):
        super().__init__()
        self.proj_i = nn.Embedding(alphabet_size, edge_dim, device=device)
        self.proj_j = nn.Embedding(alphabet_size, edge_dim, device=device)
        self.relpos = nn.Embedding(2 * relpos_len + 1, edge_dim, device=device)

    def forward(self, fasta, out):
        """fasta [L] tokens; adds into out [Lr, L, edge_dim], this rank's
        rows (all L outside sequence parallelism)."""
        L = fasta.shape[-1]
        q0, rows, _ = sp.row_range(L)
        out = out + sp.take_rows(self.proj_i.weight[fasta], L, 0)[:, None]
        out = out + self.proj_j.weight[fasta][None, :]
        return out + relpos_embedding(self.relpos.weight, L, q0, rows)


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
        """Adds the previous cycle into node_repr [M, Lr, d] (row 0 only)
        and edge_repr [Lr, L, de], this rank's rows (all L outside sequence
        parallelism), from prev_node [L, d] and prev_x [L, 14, 3] whole and
        prev_edge [Lr, L, de]."""
        L = fasta.shape[-1]
        atom_mask = tables(fasta.device)["restype2atom_mask"][fasta]
        beta = create_pseudo_beta(prev_x, atom_mask)
        d = torch.linalg.norm(sp.take_rows(beta, L, 0)[:, None]
                              - beta[None, :], dim=-1)
        breaks = torch.linspace(FIRST_BREAK, LAST_BREAK,
                                self.prev_pos_embed.num_embeddings - 1,
                                device=d.device)
        bins = (d[..., None] > breaks).sum(-1)
        prev_node = sp.take_rows(prev_node, L, 0)
        node_repr = torch.cat([node_repr[:1] + self.layernorm_node(prev_node),
                               node_repr[1:]])
        edge_repr = edge_repr + self.prev_pos_embed.weight[bins]
        return node_repr, edge_repr + self.layernorm_edge(prev_edge)
