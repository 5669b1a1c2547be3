"""OmegaFold structure module and confidence head.

Port of ``dynamicpdb_tpu/models/omegafold/structure.py``: OmegaFold's own
decoder IPA (plain tensor math, not the DFOLD IPA kernel) over
black-hole-initialised frames, per-cycle 6-vector frame updates, the
torsion head and the pLDDT head. Frames stay float32 (rots [L, 3, 3],
trans [L, 3]); cycles run in nanometres and the returned translation is in
Angstrom. Parameter names are the reference's.

The JAX module's ``*Params`` pytrees (``LinearParams`` among them) and
their ``*_from_torch`` converters are the modules' own parameters here;
its functions ``decode_ipa``, ``structure_cycle``, ``structure_module``,
``torsion_head`` and ``confidence_head`` are the forwards of
``DecodeIPA``, ``StructureCycle``, ``StructureModule``,
``TorsionAngleHead`` and ``ConfidenceHead``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from h100bench.reference.models.omegafold.core import (
    LayerNorm,
    layer_norm_f32 as _normalize,
    linear,
)


def quaternion_to_matrix(q):
    """pytorch3d convention; (..., 4), or (..., 3) with real part 1."""
    if q.shape[-1] == 3:
        q = torch.cat([torch.ones_like(q[..., :1]), q], dim=-1)
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


class DecodeIPA(nn.Module):
    def __init__(self, s, device=None):
        super().__init__()
        H, d = s.num_head, s.node_dim
        self.num_head, self.num_scalar_qk = H, s.num_scalar_qk
        self.num_point_qk = s.num_point_qk
        self.q_scalar = nn.Linear(d, H * s.num_scalar_qk, device=device)
        self.k_scalar = nn.Linear(d, H * s.num_scalar_qk, device=device)
        self.v_scalar = nn.Linear(d, H * s.num_scalar_v, device=device)
        self.q_point = nn.Linear(d, H * s.num_point_qk * 3, device=device)
        self.k_point = nn.Linear(d, H * s.num_point_qk * 3, device=device)
        self.v_point = nn.Linear(d, H * s.num_point_v * 3, device=device)
        self.trainable_point_weights = nn.Parameter(torch.ones(H, device=device))
        self.bias_2d = nn.Linear(s.edge_dim, H, device=device)
        self.output_projection = nn.Linear(
            H * (s.num_scalar_v + 4 * s.num_point_v + s.edge_dim), d,
            device=device)

    def forward(self, node, edge, rots, trans, mask):
        """node [L, d]; edge [L, L, de]; frames rots [L, 3, 3], trans
        [L, 3]; mask [L]. Returns the node update."""
        L, H = node.shape[0], self.num_head
        scalar_w = math.sqrt(1 / (3 * max(self.num_scalar_qk, 1)))
        point_w = math.sqrt(1 / (3 * max(self.num_point_qk, 1) * 9.0 / 2))
        edge_w = math.sqrt(1 / 3)

        def heads(lin):
            return linear(lin, node).reshape(L, H, -1)

        def points(lin):
            y = linear(lin, node).reshape(L, H, -1, 3).to(rots.dtype)
            return torch.einsum("lij,lhpj->lhpi", rots, y) + trans[:, None, None]

        q_s, k_s, v_s = heads(self.q_scalar), heads(self.k_scalar), heads(self.v_scalar)
        logits = torch.einsum("qhc,khc->qkh", q_s, k_s) * scalar_w
        logits = logits + linear(self.bias_2d, edge) * edge_w
        q_p, k_p, v_p = points(self.q_point), points(self.k_point), points(self.v_point)
        dist = ((q_p[:, None] - k_p[None]) ** 2).sum((-1, -2))  # [q, k, h]
        logits = logits - dist * point_w * nn.functional.softplus(
            self.trainable_point_weights) / 2
        logits = logits + (mask.float()[None, :, None] - 1.0) * 1e9
        attn = torch.softmax(logits, dim=-2)  # over k

        ret_edge = torch.einsum("qkh,qkc->qhc", attn, edge.to(attn.dtype))
        ret_scalar = torch.einsum("qkh,khc->qhc", attn, v_s.to(attn.dtype))
        ret_point = torch.einsum("qkh,khpc->qhpc", attn, v_p.to(attn.dtype))
        ret_point = torch.einsum("lji,lhpj->lhpi", rots,
                                 ret_point - trans[:, None, None])
        feat = torch.cat([ret_scalar.reshape(L, -1), ret_point.reshape(L, -1),
                          torch.linalg.norm(ret_point, dim=-1).reshape(L, -1),
                          ret_edge.reshape(L, -1)], dim=-1)
        return linear(self.output_projection, feat)


class StructureCycle(nn.Module):
    def __init__(self, s, device=None):
        super().__init__()
        self.ipa = DecodeIPA(s, device=device)
        self.input_norm = LayerNorm(s.node_dim, device=device)
        self.transition = nn.ModuleList(
            nn.Linear(s.node_dim, s.node_dim, device=device)
            for _ in range(s.num_transition))
        self.update_norm = LayerNorm(s.node_dim, device=device)
        self.affine_update = nn.Linear(s.node_dim, 6, device=device)

    def forward(self, node, edge, rots, trans, mask):
        node = node + self.ipa(node, edge, rots, trans, mask).to(node.dtype)
        node = self.input_norm(node)
        inp = node
        for i, lin in enumerate(self.transition):
            node = linear(lin, node)
            if i != len(self.transition) - 1:
                node = torch.relu(node)
        node = self.update_norm(node + inp)
        upd = linear(self.affine_update, node).to(rots.dtype)  # quat3 + nm
        rot_u = quaternion_to_matrix(upd[..., :3])
        new_rots = torch.einsum("lij,ljk->lik", rots, rot_u)
        new_trans = torch.einsum("lij,lj->li", rots, upd[..., 3:]) + trans
        return node, new_rots, new_trans


class TorsionAngleHead(nn.Module):
    def __init__(self, s, device=None):
        super().__init__()
        d, ch = s.node_dim, s.num_channel
        self.input_projection = nn.ModuleList(
            nn.Linear(d, ch, device=device) for _ in range(2))
        self.resblock1 = nn.ModuleList(
            nn.Linear(ch, ch, device=device)
            for _ in range(s.num_residual_block))
        self.resblock2 = nn.ModuleList(
            nn.Linear(ch, ch, device=device)
            for _ in range(s.num_residual_block))
        self.unnormalized_angles = nn.Linear(ch, 14, device=device)

    def forward(self, reprs):
        act = 0.0
        for x, lin in zip(reprs, self.input_projection):
            act = linear(lin, torch.relu(x)) + act
        for l1, l2 in zip(self.resblock1, self.resblock2):
            act = act + linear(l2, torch.relu(linear(l1, torch.relu(act))))
        raw = linear(self.unnormalized_angles, torch.relu(act))
        raw = raw.reshape(raw.shape[:-1] + (7, 2))
        return raw / torch.clamp(torch.linalg.norm(raw, dim=-1, keepdim=True),
                                 min=4e-5)


class StructureModule(nn.Module):
    def __init__(self, s, device=None):
        super().__init__()
        self.node_norm = LayerNorm(s.node_dim, device=device)
        self.edge_norm = LayerNorm(s.edge_dim, device=device)
        self.init_proj = nn.Linear(s.node_dim, s.node_dim, device=device)
        self.cycles = nn.ModuleList(StructureCycle(s, device=device)
                                    for _ in range(s.num_cycle))
        self.torsion_angle_pred = TorsionAngleHead(s, device=device)

    def forward(self, node, edge, mask):
        """node [L, d], edge [L, L, de], mask [L] -> (node, (rots, trans in
        Angstrom), torsions [L, 7, 2])."""
        node = self.node_norm(node)
        edge = self.edge_norm(edge)
        init_node = node
        node = linear(self.init_proj, node)
        L = node.shape[0]
        rots = torch.eye(3, device=node.device).expand(L, 3, 3)
        trans = torch.zeros(L, 3, device=node.device)
        for cycle in self.cycles:
            node, rots, trans = cycle(node, edge, rots, trans, mask)
        torsions = self.torsion_angle_pred([node, init_node])
        return node, (rots, trans * 10.0), torsions


class ConfidenceHead(nn.Module):
    def __init__(self, s, device=None):
        super().__init__()
        self.network = nn.Sequential(
            nn.Linear(s.node_dim, s.hidden_dim, device=device), nn.ReLU(),
            nn.Linear(s.hidden_dim, s.hidden_dim, device=device), nn.ReLU(),
            nn.Linear(s.hidden_dim, s.num_bins, device=device))

    def forward(self, node):
        """node [L, d] -> pLDDT [L] in [0, 1]."""
        x = torch.relu(linear(self.network[0], _normalize(node)))
        x = torch.relu(linear(self.network[2], x))
        logits = linear(self.network[4], x)
        n = logits.shape[-1]
        centers = (torch.arange(n, device=node.device, dtype=torch.float32)
                   + 0.5) / n
        return torch.softmax(logits.float(), dim=-1) @ centers
