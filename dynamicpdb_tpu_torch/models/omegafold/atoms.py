"""OmegaFold all-atom expansion: backbone frames + torsions -> atom14.

Port of ``dynamicpdb_tpu/models/omegafold/atoms.py``. OmegaFold chains its
side-chain rigid groups with its own default-frame tables and torsion
order, not the AF2 convention of ``ops/frames``. The tables are this
package's byte-identical copy of ``chem/omegafold_tables.npz``. Frames are
(rots [..., 3, 3], trans [..., 3], mask [...]) in Angstrom.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

TABLES_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "chem", "omegafold_tables.npz")

GLY_IDX = 7  # 'G' in the OmegaFold/AF2 restype order


@functools.cache
def _np_tables() -> dict:
    with np.load(TABLES_PATH) as z:
        return {k: np.asarray(z[k]) for k in z.files}


@functools.cache
def tables(device=None) -> dict:
    """The tables as tensors on ``device`` (float32 and int64)."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in _np_tables().items()}


def robust_normalize(x, eps: float = 4e-5):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _mask_frames(rots, trans, mask):
    """Masked rows get the identity rotation and zero translation."""
    m = mask[..., None, None].bool()
    rots = torch.where(m, rots, _eye(rots))
    return rots, trans * mask[..., None].to(trans.dtype)


def _compose(r1, t1, r2, t2):
    r = torch.einsum("...ij,...jk->...ik", r1, r2)
    return r, t1 + torch.einsum("...ij,...j->...i", r1, t2)


def rot_x_from_sin_cos(angles):
    sin, cos = angles[..., 0], angles[..., 1]
    zeros, ones = torch.zeros_like(sin), torch.ones_like(sin)
    return torch.stack([torch.stack([ones, zeros, zeros], -1),
                        torch.stack([zeros, cos, -sin], -1),
                        torch.stack([zeros, sin, cos], -1)], dim=-2)


def expand_w_torsion(rots, trans, mask, torsion_angles, fasta):
    """Backbone frames [N] + torsions [N, 7 or 5, 2] -> the 8 per-group
    global frames (rots8 [N, 8, 3, 3], trans8 [N, 8, 3], mask8 [N, 8])."""
    t = tables(fasta.device)
    tors_mask = torch.ones(torsion_angles.shape[:-1], dtype=torch.bool,
                           device=fasta.device)
    if torsion_angles.shape[-2] == 5:
        torsion_angles = torch.cat(
            [torch.zeros_like(torsion_angles[..., 0:2, :]), torsion_angles],
            dim=-2)
        tors_mask = torch.cat([torch.zeros_like(tors_mask[..., :2]),
                               tors_mask], dim=-1)
    ident = torch.tensor([0.0, 1.0], dtype=torsion_angles.dtype,
                         device=fasta.device)
    ident = ident.expand(torsion_angles.shape[:-2] + (1, 2))
    angles = torch.cat([ident, torsion_angles], dim=-2)  # [N, 8, 2]
    mask8 = torch.cat([torch.ones_like(tors_mask[..., :1]), tors_mask], -1)

    angles = robust_normalize(angles)
    rx = rot_x_from_sin_cos(angles)
    rx, rx_t = _mask_frames(rx, angles.new_zeros(angles.shape[:-1] + (3,)),
                            mask8)
    m4 = t["restype_aa_default_frame"][fasta].to(rots.dtype)  # [N, 8, 4, 4]
    df_r, df_t = _mask_frames(m4[..., :3, :3], m4[..., :3, 3], mask8)
    all_r, all_t = _compose(df_r, df_t, rx, rx_t)

    # chain the side-chain groups: chiK-to-backbone = chi(K-1)-to-bb o chiK
    c1r, c1t = all_r[..., 4, :, :], all_t[..., 4, :]
    c2r, c2t = _compose(c1r, c1t, all_r[..., 5, :, :], all_t[..., 5, :])
    c3r, c3t = _compose(c2r, c2t, all_r[..., 6, :, :], all_t[..., 6, :])
    c4r, c4t = _compose(c3r, c3t, all_r[..., 7, :, :], all_t[..., 7, :])
    all_r = torch.cat([all_r[..., :5, :, :],
                       torch.stack([c2r, c3r, c4r], dim=-3)], dim=-3)
    all_t = torch.cat([all_t[..., :5, :],
                       torch.stack([c2t, c3t, c4t], dim=-2)], dim=-2)
    all_r, all_t = _mask_frames(all_r, all_t, mask8)

    g_r, g_t = _compose(rots[..., None, :, :], trans[..., None, :], all_r,
                        all_t)
    return g_r, g_t, mask[..., None].bool() & mask8


def expanded_to_pos(rots8, trans8, mask8, fasta):
    """The 8 global group frames -> (pos14 [N, 14, 3], mask14 [N, 14])."""
    t = tables(fasta.device)
    dt = rots8.dtype
    residx2group = t["restype_atom14_to_aa"][fasta]  # [N, 14]
    group_mask = torch.eye(8, dtype=dt, device=fasta.device)[residx2group]
    group_mask = group_mask * mask8[..., None, :].to(dt)
    sel_r = torch.einsum("...gij,...ag->...aij", rots8, group_mask)
    sel_t = torch.einsum("...gi,...ag->...ai", trans8, group_mask)
    sel_m = (mask8[..., None, :].to(dt) * group_mask).sum(-1)
    lit = t["restype_atom14_aa_positions"][fasta].to(dt)  # [N, 14, 3]
    pos14 = torch.einsum("...aij,...aj->...ai", sel_r, lit) + sel_t
    pos14 = pos14 * sel_m[..., None]

    exist = group_mask[..., 1:].sum(-1)
    exist[..., 4] = (fasta != GLY_IDX).to(exist.dtype)
    exist = torch.cat([mask8[..., 0:1].to(exist.dtype).expand(
        exist[..., 0:3].shape), exist[..., 3:]], dim=-1)
    return pos14, exist.bool()


def frames_and_torsions_to_atom14(rots, trans, mask, torsion_angles, fasta):
    r8, t8, m8 = expand_w_torsion(rots, trans, mask, torsion_angles, fasta)
    return expanded_to_pos(r8, t8, m8, fasta)
