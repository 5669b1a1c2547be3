"""Invariant Point Attention (DFOLD fork).

Port of ``dynamicpdb_tpu/models/ipa.py``: OpenFold's Algorithm 22 with the
DFOLD extras, a single [N, N, c_z] pair tensor shared by all frames and a
second family of point outputs kept in the global frame.

Shapes: s [F, N, c_s], z [N, N, c_z], rigids Rigid [F, N], mask [F, N].
The projections run in ``compute_dtype``; the attention core
(``ops.ipa_attention``: the CUDA kernel on the card) takes float32 q, k, v,
bias and pair_z, as the JAX package's Pallas branch does (``ipa.py:206-216``),
and logits, softmax, geometry and the block output stay float32.
Parameter names follow the reference torch layout, whose point projections
are xyz-major (row xyz*(H*P) + hp).

Under sequence parallelism (``parallel/sp.py``) s, r and mask hold this
rank's rows and z is [rows, N, c_z], this rank's rows against every
residue. q, k, v and the points are projected and lifted on this rank's
rows; k, v, their points and the key mask are then gathered over the
ranks (``sp.gather_rows``, one collective a call), and the kernel takes
this rank's query rows against all N keys. b and pair_z come from z's rows
as they are.

The JAX module's ``dense_ipa_attention`` (the attention core without a
kernel) is ``ops/ipa_attention.py``'s plain version here, which the CPU
runs.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamicpdb_tpu_torch.config import IPAConfig
from dynamicpdb_tpu_torch.models.layers import Linear
from dynamicpdb_tpu_torch.ops.ipa_attention import ipa_attention
from dynamicpdb_tpu_torch.ops.rigid import Rigid
from dynamicpdb_tpu_torch.parallel import sp


def _xyz_major_points(x, n_pts: int):
    """[..., 3*n_pts] in xyz-major order -> [..., n_pts, 3]."""
    return x.reshape(x.shape[:-1] + (3, n_pts)).transpose(-1, -2)


def _gather_keys(n_res: int, *keys):
    """k, v, k_pts, v_pts and the mask of this rank's rows ([F, rows, ...],
    float32) gathered over the 'seq' ranks into one collective and cut to
    the window's ``n_res`` keys, each contiguous in its own shape."""
    F_, rows = keys[0].shape[:2]
    flat = torch.cat([t.reshape(F_, rows, -1) for t in keys], dim=-1)
    whole = sp.gather_rows(flat, n_res, dim=1)
    widths = [t[0, 0].numel() for t in keys]
    return tuple(
        part.reshape((F_, n_res) + t.shape[2:]).contiguous()
        for part, t in zip(whole.split(widths, dim=-1), keys))


class InvariantPointAttention(nn.Module):
    def __init__(self, cfg: IPAConfig, inf: float = 1e5, eps: float = 1e-8,
                 compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.inf = inf
        self.eps = eps
        H, C, Pq, Pv = cfg.no_heads, cfg.c_hidden, cfg.no_qk_points, cfg.no_v_points
        dz = cfg.c_z // 4
        dt = compute_dtype
        self.linear_q = Linear(cfg.c_s, H * C, compute_dtype=dt)
        self.linear_kv = Linear(cfg.c_s, 2 * H * C, compute_dtype=dt)
        self.linear_q_points = Linear(cfg.c_s, H * Pq * 3, compute_dtype=dt)
        self.linear_kv_points = Linear(cfg.c_s, H * (Pq + Pv) * 3, compute_dtype=dt)
        self.linear_b = Linear(cfg.c_z, H, compute_dtype=dt)
        self.down_z = Linear(cfg.c_z, dz, compute_dtype=dt)
        self.head_weights = nn.Parameter(torch.full((H,), 0.541324854612918))
        self.linear_out = Linear(H * (C + dz + 8 * Pv), cfg.c_s, compute_dtype=dt)
        # constructed but never called in the reference IPA; kept so the
        # state dict has the reference layout
        self.linear_rbf = nn.Linear(20, 1)

    def forward(self, s, z, r: Rigid, mask):
        c = self.cfg
        F_, N, _ = s.shape
        H, C, Pq, Pv = c.no_heads, c.c_hidden, c.no_qk_points, c.no_v_points

        q = self.linear_q(s).reshape(F_, N, H, C)
        k, v = self.linear_kv(s).reshape(F_, N, H, 2 * C).split(C, dim=-1)

        # points: local frames lifted to the global frame, always float32
        r_pts = r.unsqueeze(-1)
        q_pts = _xyz_major_points(self.linear_q_points(s).float(), H * Pq)
        q_pts = r_pts.apply(q_pts).reshape(F_, N, H, Pq, 3)
        kv_pts = _xyz_major_points(
            self.linear_kv_points(s).float(), H * (Pq + Pv))
        kv_pts = r_pts.apply(kv_pts).reshape(F_, N, H, Pq + Pv, 3)
        k_pts, v_pts = kv_pts.split([Pq, Pv], dim=-2)

        b = self.linear_b(z)  # [N, N, H], frame-shared
        pair_z = self.down_z(z)  # [N, N, c_z // 4]
        head_weights = F.softplus(self.head_weights) * math.sqrt(
            1.0 / (3 * (Pq * 9.0 / 2)))

        def f32(x):
            return x.float().contiguous()

        q, k, v, q_pts = f32(q), f32(k), f32(v), f32(q_pts)
        k_pts, v_pts, mask = f32(k_pts), f32(v_pts), f32(mask)
        key_mask = None
        if sp.is_active():
            k, v, k_pts, v_pts, key_mask = _gather_keys(
                z.shape[1], k, v, k_pts, v_pts, mask)
        o, o_pt_global, o_pair, _ = ipa_attention(
            q, k, v, q_pts, k_pts, v_pts, f32(b), f32(pair_z), mask,
            f32(head_weights), math.sqrt(1.0 / (3 * C)), math.sqrt(1.0 / 3),
            self.inf, key_mask=key_mask,
        )

        # DFOLD extra: keep the global-frame point outputs beside the local
        o_pt_local = r.unsqueeze(-1).unsqueeze(-1).invert_apply(o_pt_global)
        o_pt_norm = torch.sqrt(torch.sum(o_pt_local**2, -1) + self.eps)
        o_pt_global_norm = torch.sqrt(torch.sum(o_pt_global**2, -1) + self.eps)

        def unbind_xyz(p):  # [F, N, H, Pv, 3] -> 3 x [F, N, H*Pv]
            return [p[..., i].reshape(F_, N, H * Pv) for i in range(3)]

        # the reference's concat order
        o_feats = torch.cat(
            [
                o.reshape(F_, N, H * C),
                *unbind_xyz(o_pt_local),
                o_pt_norm.reshape(F_, N, H * Pv),
                o_pair.reshape(F_, N, -1),
                *unbind_xyz(o_pt_global),
                o_pt_global_norm.reshape(F_, N, H * Pv),
            ],
            dim=-1,
        )
        return self.linear_out(o_feats).float()
