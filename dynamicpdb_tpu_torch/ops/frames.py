"""All-atom <-> rigid-frame featurization geometry on tensors.

Port of ``dynamicpdb_tpu/ops/frames.py`` (the AF2/OpenFold chain the
reference runs per data window): atom37 -> backbone and rigid-group frames,
atom37 -> torsion angles, atom37 -> atom14, rigids + torsions -> frames ->
atom14 or atom37, atom14 -> atom37.
Residue-type loops are table gathers; frames are (rotmat, trans) pairs.
Leading batch dims broadcast: ``aatype`` and the masks may carry fewer of
them than the coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dynamicpdb_tpu_torch.chem import constants as chem
from dynamicpdb_tpu_torch.ops.rigid import Rigid

DEFAULT_FRAMES = np.asarray(chem.restype_rigid_group_default_frame)  # [21,8,4,4]
GROUP_IDX14 = np.asarray(chem.restype_atom14_to_rigid_group)  # [21,14]
GROUP_IDX37 = np.asarray(chem.restype_atom37_to_rigid_group)  # [21,37]
ATOM14_MASK = np.asarray(chem.restype_atom14_mask)  # [21,14]
ATOM37_MASK = np.asarray(chem.restype_atom37_mask)  # [21,37]
IDEAL_POS14 = np.asarray(chem.restype_atom14_rigid_group_positions)  # [21,14,3]
IDEAL_POS37 = np.asarray(chem.restype_atom37_rigid_group_positions)  # [21,37,3]
A14_TO_A37 = np.asarray(chem.restype_atom14_to_atom37)  # [21,14]
A37_TO_A14 = np.asarray(chem.restype_atom37_to_atom14)  # [21,37]
CHI_ATOM_IDX = np.asarray(chem.chi_atom_indices)  # [21,4,4]
CHI_MASK = np.asarray(chem.chi_angles_mask)  # [21,4]
CHI_PI_PERIODIC = np.asarray(chem.chi_pi_periodic)  # [21,4]
BASE_ATOM37_IDX = np.asarray(chem.rigidgroup_base_atom37_idx)  # [21,8,3]
GROUP_EXISTS = np.asarray(chem.rigidgroup_exists)  # [21,8]
GROUP_AMBIGUOUS = np.asarray(chem.rigidgroup_is_ambiguous)  # [21,8]


def _table(arr: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A chem table as a tensor on ``like``'s device (float32 unless the
    table is integer)."""
    if dtype is None:
        dtype = torch.long if np.issubdtype(arr.dtype, np.integer) else torch.float32
    return torch.as_tensor(arr, dtype=dtype, device=like.device)


def _gather(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis`` with broadcasting of the non-gathered dims."""
    nd = max(x.ndim, idx.ndim)
    x = x.reshape((1,) * (nd - x.ndim) + x.shape)
    idx = idx.reshape((1,) * (nd - idx.ndim) + idx.shape)
    dim = dim % nd
    shape = list(torch.broadcast_shapes(
        x.shape[:dim] + (1,) + x.shape[dim + 1:],
        idx.shape[:dim] + (1,) + idx.shape[dim + 1:],
    ))
    xs, ids = list(shape), list(shape)
    xs[dim], ids[dim] = x.shape[dim], idx.shape[dim]
    return torch.gather(x.expand(xs), dim, idx.expand(ids))


class Frames8(NamedTuple):
    """Rigid-group frames as explicit (rotation, translation) tensors."""

    rots: torch.Tensor  # [..., N, 8, 3, 3]
    trans: torch.Tensor  # [..., N, 8, 3]

    def to_tensor_4x4(self) -> torch.Tensor:
        out = self.rots.new_zeros(self.rots.shape[:-2] + (4, 4))
        out[..., :3, :3] = self.rots
        out[..., :3, 3] = self.trans
        out[..., 3, 3] = 1.0
        return out


def _gram_schmidt(p_neg_x, origin, p_xy, eps=1e-8):
    """Rotation columns (e0, e1, e0 x e1); AF2 Algorithm 21."""
    e0 = origin - p_neg_x
    e1 = p_xy - origin
    e0 = e0 / torch.sqrt(torch.sum(e0 * e0, -1, keepdim=True) + eps)
    e1 = e1 - e0 * torch.sum(e0 * e1, -1, keepdim=True)
    e1 = e1 / torch.sqrt(torch.sum(e1 * e1, -1, keepdim=True) + eps)
    e2 = torch.linalg.cross(e0, e1, dim=-1)
    return torch.stack([e0, e1, e2], dim=-1)


def atom37_to_frames(aatype, atom37, atom37_mask, eps: float = 1e-8):
    """Ground-truth rigid-group frames from atom37 coordinates.

    Returns gt_frames, gt_exists, group_exists, alt_gt_frames, is_ambiguous
    and backbone_rigid (group 0 as a quaternion Rigid).
    """
    base_idx = _table(BASE_ATOM37_IDX, atom37)[aatype]  # [..., N, 8, 3]
    base_pos = _gather(
        atom37[..., None, :, :], -2, base_idx[..., None].expand(
            base_idx.shape + (3,))
    )  # [..., N, 8, 3, 3]

    rots = _gram_schmidt(
        base_pos[..., 0, :], base_pos[..., 1, :], base_pos[..., 2, :], eps
    )
    trans = base_pos[..., 1, :]

    # group-0 fix-up: rotate 180 deg about y
    flip = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    flip[0, 0, 0] = -1.0
    flip[0, 2, 2] = -1.0
    rots = rots @ _table(flip, rots)

    group_exists = _table(GROUP_EXISTS, atom37)[aatype]
    atoms_exist = _gather(atom37_mask[..., None, :], -1, base_idx)  # [..., N, 8, 3]
    gt_exists = torch.amin(atoms_exist, dim=-1) * group_exists

    # alternate frames for 180-deg-symmetric terminal chis
    ambig = _table(GROUP_AMBIGUOUS, atom37)[aatype]
    swap = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    alt_rots = torch.where(
        ambig[..., None, None] > 0, rots @ _table(swap, rots), rots
    )

    backbone = Rigid.from_rotmat(rots[..., 0, :, :], trans[..., 0, :])
    return {
        "gt_frames": Frames8(rots, trans),
        "gt_exists": gt_exists,
        "group_exists": group_exists,
        "alt_gt_frames": Frames8(alt_rots, trans),
        "is_ambiguous": ambig,
        "backbone_rigid": backbone,
    }


def atom37_to_torsion_angles(aatype, atom37, atom37_mask):
    """(pre_omega, phi, psi, chi1..4) sin/cos + alt + mask; the residue axis
    is -3 of atom37 and -2 of atom37_mask."""
    aatype = torch.clamp(aatype, 0, 20)
    batch = torch.broadcast_shapes(
        atom37.shape[:-2], atom37_mask.shape[:-1], aatype.shape
    )
    atom37 = atom37.expand(batch + (37, 3))
    atom37_mask = atom37_mask.expand(batch + (37,))
    aatype = aatype.expand(batch)

    prev_pos = torch.cat(
        [torch.zeros_like(atom37[..., :1, :, :]), atom37[..., :-1, :, :]], dim=-3
    )
    prev_mask = torch.cat(
        [torch.zeros_like(atom37_mask[..., :1, :]), atom37_mask[..., :-1, :]],
        dim=-2,
    )

    pre_omega_pos = torch.cat([prev_pos[..., 1:3, :], atom37[..., :2, :]], dim=-2)
    phi_pos = torch.cat([prev_pos[..., 2:3, :], atom37[..., :3, :]], dim=-2)
    psi_pos = torch.cat([atom37[..., :3, :], atom37[..., 4:5, :]], dim=-2)
    pre_omega_mask = torch.prod(prev_mask[..., 1:3], -1) * torch.prod(
        atom37_mask[..., :2], -1
    )
    phi_mask = prev_mask[..., 2] * torch.prod(atom37_mask[..., :3], -1)
    psi_mask = torch.prod(atom37_mask[..., :3], -1) * atom37_mask[..., 4]

    chi_idx = _table(CHI_ATOM_IDX, atom37)[aatype]  # [..., N, 4, 4]
    chi_pos = _gather(
        atom37[..., None, :, :], -2, chi_idx[..., None].expand(chi_idx.shape + (3,))
    )  # [..., N, 4, 4, 3]
    chi_mask = _table(CHI_MASK, atom37)[aatype] * torch.prod(
        _gather(atom37_mask[..., None, :], -1, chi_idx), dim=-1
    )

    torsion_pos = torch.cat(
        [
            pre_omega_pos[..., None, :, :],
            phi_pos[..., None, :, :],
            psi_pos[..., None, :, :],
            chi_pos,
        ],
        dim=-3,
    )  # [..., N, 7, 4, 3]
    torsion_mask = torch.cat(
        [pre_omega_mask[..., None], phi_mask[..., None], psi_mask[..., None],
         chi_mask],
        dim=-1,
    )

    # dihedral via the torsion-frame trick: frame from atoms (1, 2 | 0),
    # atom 3 expressed in it; sin = z, cos = y
    rots = _gram_schmidt(
        torsion_pos[..., 1, :], torsion_pos[..., 2, :], torsion_pos[..., 0, :]
    )
    rel = torch.einsum(
        "...ji,...j->...i", rots, torsion_pos[..., 3, :] - torsion_pos[..., 2, :]
    )
    sin_cos = torch.stack([rel[..., 2], rel[..., 1]], dim=-1)
    denom = torch.sqrt(torch.sum(sin_cos**2, -1, keepdim=True) + 1e-8)
    sin_cos = sin_cos / denom
    # psi sign flip (AF2 convention)
    sin_cos = sin_cos * sin_cos.new_tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0])[
        :, None]

    chi_is_ambiguous = _table(CHI_PI_PERIODIC, atom37)[aatype]
    mirror = torch.cat(
        [torch.ones(aatype.shape + (3,), device=atom37.device),
         1.0 - 2.0 * chi_is_ambiguous],
        dim=-1,
    )
    return {
        "torsion_angles_sin_cos": sin_cos,
        "alt_torsion_angles_sin_cos": sin_cos * mirror[..., None],
        "torsion_angles_mask": torsion_mask,
    }


def torsion_angles_to_frames(bb: Rigid, angles: torch.Tensor, aatype) -> Frames8:
    """Backbone rigid + 7 torsions -> all 8 rigid-group frames in global
    coordinates."""
    default = _table(DEFAULT_FRAMES, angles)[aatype]  # [..., N, 8, 4, 4]
    def_rots = default[..., :3, :3]
    def_trans = default[..., :3, 3]

    # x-axis rotation per group from (sin, cos); group 0 is the identity
    bb_rot = torch.zeros_like(angles[..., :1, :])
    bb_rot[..., 1] = 1.0
    alpha = torch.cat([bb_rot, angles], dim=-2)  # [..., N, 8, 2]
    sin_a, cos_a = alpha[..., 0], alpha[..., 1]
    zeros = torch.zeros_like(sin_a)
    ones = torch.ones_like(sin_a)
    x_rot = torch.stack(
        [ones, zeros, zeros, zeros, cos_a, -sin_a, zeros, sin_a, cos_a], dim=-1
    ).reshape(sin_a.shape + (3, 3))

    rots = def_rots @ x_rot
    trans = def_trans

    def compose(r1, t1, r2, t2):
        return r1 @ r2, torch.einsum("...ij,...j->...i", r1, t2) + t1

    # chain chi2 <- chi1, chi3 <- chi2, chi4 <- chi3 into backbone coords
    chi1_r, chi1_t = rots[..., 4, :, :], trans[..., 4, :]
    chi2_r, chi2_t = compose(chi1_r, chi1_t, rots[..., 5, :, :], trans[..., 5, :])
    chi3_r, chi3_t = compose(chi2_r, chi2_t, rots[..., 6, :, :], trans[..., 6, :])
    chi4_r, chi4_t = compose(chi3_r, chi3_t, rots[..., 7, :, :], trans[..., 7, :])

    all_r = torch.cat(
        [rots[..., :5, :, :], torch.stack([chi2_r, chi3_r, chi4_r], dim=-3)],
        dim=-3,
    )
    all_t = torch.cat(
        [trans[..., :5, :], torch.stack([chi2_t, chi3_t, chi4_t], dim=-2)],
        dim=-2,
    )

    bb_r = bb.rotmat()[..., None, :, :]
    bb_t = bb.trans[..., None, :]
    glob_r = bb_r @ all_r
    glob_t = torch.einsum("...ij,...j->...i", bb_r, all_t) + bb_t
    return Frames8(glob_r, glob_t)


def _frames_to_atom_pos(frames: Frames8, aatype, group_idx, ideal_pos, atom_mask):
    group = _table(group_idx, frames.rots)[aatype]  # [..., N, A]
    r = _gather(
        frames.rots, -3, group[..., None, None].expand(group.shape + (3, 3))
    )  # [..., N, A, 3, 3]
    t = _gather(frames.trans, -2, group[..., None].expand(group.shape + (3,)))
    pos = _table(ideal_pos, frames.rots)[aatype]  # [..., N, A, 3]
    out = torch.einsum("...ij,...j->...i", r, pos) + t
    return out * _table(atom_mask, frames.rots)[aatype][..., None]


def frames_to_atom14_pos(frames: Frames8, aatype) -> torch.Tensor:
    """Idealized atom14 coordinates from rigid-group frames."""
    return _frames_to_atom_pos(frames, aatype, GROUP_IDX14, IDEAL_POS14, ATOM14_MASK)


def frames_to_atom37_pos(frames: Frames8, aatype) -> torch.Tensor:
    """Idealized atom37 coordinates from rigid-group frames."""
    return _frames_to_atom_pos(frames, aatype, GROUP_IDX37, IDEAL_POS37, ATOM37_MASK)


def atom14_to_atom37(atom14: torch.Tensor, aatype):
    """[..., N, 14, ...] -> ([..., N, 37, ...], mask [..., N, 37])."""
    idx = _table(A37_TO_A14, atom14)[aatype]  # [..., N, 37]
    extra = atom14.ndim - idx.ndim  # trailing dims beyond the atom axis
    gather_idx = idx.reshape(idx.shape + (1,) * extra).expand(
        idx.shape + atom14.shape[idx.ndim:]
    )
    atom37 = _gather(atom14, idx.ndim - 1, gather_idx)
    mask = _table(ATOM37_MASK, atom14)[aatype]
    return atom37 * mask.reshape(mask.shape + (1,) * extra), mask


def atom37_to_atom14(atom37: torch.Tensor, aatype, atom37_mask):
    """Ground-truth atom14 positions [..., N, 14, 3] and their mask
    [..., N, 14] from atom37."""
    idx = _table(A14_TO_A37, atom37)[aatype]  # [..., N, 14]
    exists = _table(ATOM14_MASK, atom37)[aatype] * _gather(atom37_mask, -1,
                                                           idx)
    pos = _gather(atom37, -2, idx[..., None].expand(idx.shape + (3,)))
    return pos * exists[..., None], exists


def compute_backbone_atom37(bb: Rigid, aatype, torsions):
    """Rigids + torsions -> (atom37 [..., N, 37, 3], mask: the atoms not at
    the origin)."""
    atom37 = frames_to_atom37_pos(torsion_angles_to_frames(bb, torsions,
                                                           aatype), aatype)
    return atom37, torch.any(atom37 != 0, dim=-1)
