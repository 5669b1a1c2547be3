"""Evaluation metrics on tensors (any device).

Port of ``dynamicpdb_tpu/analysis/metrics.py``, the reference's metrics of
record: the mean quaternion geodesic distance in degrees (``ave_rot``),
the translation MAE (``ave_trans``), the all-atom MAE/MSE, the RMSD after
Kabsch superposition, the C-alpha RMSD and dRMSD, and the RefAsPred
baselines (the previous frame taken as the prediction). Every epsilon is
the JAX package's: 1e-10 in the masked means and dRMSD, 1e-8 in the
superimposed RMSD, 1e-4 in ``rmsd``.
"""
from __future__ import annotations

import math

import torch


def quaternion_distance_deg(q1, q2):
    """2 acos(|<q1, q2>|) in degrees; inputs normalised first."""
    q1 = q1 / torch.linalg.norm(q1, dim=-1, keepdim=True)
    q2 = q2 / torch.linalg.norm(q2, dim=-1, keepdim=True)
    dot = torch.clamp(torch.abs(torch.sum(q1 * q2, dim=-1)), 0.0, 1.0)
    return torch.rad2deg(2 * torch.arccos(dot))


def average_quaternion_distances(q1, q2, mask=None):
    """[F, N, 4] x2 -> [F] mean geodesic degrees per frame; ``mask``
    ([..., N] or [N]) restricts the mean to real residues."""
    d = quaternion_distance_deg(q1, q2)
    if mask is None:
        return torch.mean(d, dim=-1)
    m = torch.broadcast_to(mask, d.shape)
    return torch.sum(d * m, dim=-1) / (torch.sum(m, dim=-1) + 1e-10)


def average_translation_distances(t1, t2, measurement: str = "MAE",
                                  mask=None):
    err = (t1 - t2) ** 2 if measurement == "MSE" else torch.abs(t1 - t2)
    if mask is None:
        return torch.mean(err, dim=(-1, -2))
    m = torch.broadcast_to(mask[..., None], err.shape)
    return (torch.sum(err * m, dim=(-1, -2))
            / (torch.sum(m, dim=(-1, -2)) + 1e-10))


def masked_atom_error(pred_atom37, gt_atom37, atom37_mask):
    """Per-frame masked MAE and MSE over atom37 coordinates."""
    m = atom37_mask[..., None]
    denom = torch.sum(torch.broadcast_to(m, pred_atom37.shape),
                      dim=(-1, -2, -3))
    diff = gt_atom37 - pred_atom37
    mae = torch.sum(torch.abs(diff) * m, dim=(-1, -2, -3)) / denom
    mse = torch.sum(diff ** 2 * m, dim=(-1, -2, -3)) / denom
    return mae, mse


def kabsch_align(a, b, weights=None):
    """Rotate and translate b onto a (Kabsch with the reflection fix);
    [..., N, 3].

    The SVD's singular vectors may differ in sign from LAPACK's or
    cuSOLVER's to JAX's, and are not unique where H is rank-deficient
    (collinear points); the aligned coordinates are the same either way.
    An all-zero weight set makes the means 0/0 = NaN, as in JAX; the SVD
    then runs on zeros (torch refuses non-finite input) and NaN comes out
    through the means."""
    if weights is None:
        weights = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2, keepdim=True)
    a_mean = torch.sum(a * w, dim=-2, keepdim=True) / wsum
    b_mean = torch.sum(b * w, dim=-2, keepdim=True) / wsum
    a_c, b_c = a - a_mean, b - b_mean
    H = torch.einsum("...ji,...jk->...ik", w * a_c, b_c)
    u, _, vh = torch.linalg.svd(torch.nan_to_num(H), full_matrices=False)
    sgn = torch.sign(torch.linalg.det(u @ vh))
    u = torch.cat([u[..., :, :-1], u[..., :, -1:] * sgn[..., None, None]],
                  dim=-1)
    rot = u @ vh  # b_c @ rot^T lands on a_c
    return torch.einsum("...nj,...ij->...ni", b_c, rot) + a_mean


def superimposed_rmsd(pred, gt, mask=None):
    """RMSD after optimal superposition of pred onto gt; [..., N, 3]."""
    aligned = kabsch_align(gt, pred, weights=mask)
    d2 = torch.sum((aligned - gt) ** 2, dim=-1)
    if mask is not None:
        return torch.sqrt(torch.sum(d2 * mask, -1)
                          / (torch.sum(mask, -1) + 1e-8))
    return torch.sqrt(torch.mean(d2, dim=-1))


def superimposed_rmsd_atom37(pred_atom37, gt_atom37, atom37_mask):
    """Superimposed RMSD of the atom37 cloud as one point set
    ([..., N, 37, 3] and a [..., N, 37] mask -> [...])."""
    return superimposed_rmsd(
        pred_atom37.reshape(pred_atom37.shape[:-3] + (-1, 3)),
        gt_atom37.reshape(gt_atom37.shape[:-3] + (-1, 3)),
        atom37_mask.reshape(atom37_mask.shape[:-2] + (-1,)),
    )


def rmsd(pred, gt, mask=None):
    d2 = torch.sum((pred - gt) ** 2, dim=-1)
    if mask is not None:
        return torch.sqrt(torch.sum(d2 * mask, -1)
                          / (torch.sum(mask, -1) + 1e-4))
    return torch.sqrt(torch.mean(d2, -1))


def drmsd(pred_ca, gt_ca, mask=None):
    """Distance-matrix RMSD over C-alpha coordinates [..., N, 3]."""
    def dmat(x):
        d = x[..., :, None, :] - x[..., None, :, :]
        return torch.sqrt(torch.sum(d * d, -1) + 1e-10)

    diff = (dmat(pred_ca) - dmat(gt_ca)) ** 2
    n = pred_ca.shape[-2]
    if mask is not None:
        pair = mask[..., :, None] * mask[..., None, :]
        total = torch.sum(diff * pair, (-1, -2))
        cnt = torch.sum(pair, (-1, -2)) - torch.sum(mask, -1)
        return torch.sqrt(total / torch.clamp(cnt, min=1))
    total = torch.sum(diff, (-1, -2))
    return torch.sqrt(total / max(n * (n - 1), 1))


def eval_window_metrics(pred_rigids, pred_atom37, gt_rigids, gt_atom37,
                        atom37_mask, res_mask=None) -> dict:
    """The per-protein eval summary: last-frame rotation and translation
    errors, all-atom MAE/MSE, superimposed RMSD, C-alpha dRMSD and RMSD,
    and the RefAsPred baselines from frame F-2. ``res_mask`` ([N] or
    [F, N]) keeps padded residues out of the rigid-frame errors (the
    atom37 metrics are masked by ``atom37_mask``). With one frame there is
    no previous frame and the baselines are NaN. Values are 0-d tensors."""
    if res_mask is None:
        res_mask = atom37_mask[..., 1]  # CA present <=> real residue
    ave_rot = average_quaternion_distances(
        gt_rigids[..., :4], pred_rigids[..., :4], mask=res_mask)
    ave_trans = average_translation_distances(
        gt_rigids[..., 4:], pred_rigids[..., 4:], "MAE", mask=res_mask)
    if gt_rigids.shape[0] >= 2:
        ref = torch.broadcast_to(gt_rigids[-2][None], gt_rigids.shape)
        ref_rot = average_quaternion_distances(
            gt_rigids[..., :4], ref[..., :4], mask=res_mask)[-1]
        ref_trans = average_translation_distances(
            gt_rigids[..., 4:], ref[..., 4:], "MAE", mask=res_mask)[-1]
    else:
        ref_rot = ref_trans = torch.tensor(math.nan, device=gt_rigids.device)
    mae, mse = masked_atom_error(pred_atom37, gt_atom37, atom37_mask)
    ca_mask = atom37_mask[..., 1]
    rmsd_sup = superimposed_rmsd_atom37(pred_atom37, gt_atom37, atom37_mask)
    return {
        "ave_rot": ave_rot[-1],
        "ave_trans": ave_trans[-1],
        "ref_ave_rot": ref_rot,
        "ref_ave_trans": ref_trans,
        "all_atom_mae": mae[-1],
        "all_atom_mse": mse[-1],
        "all_atom_rmsd": rmsd_sup[-1],
        "drmsd_ca": drmsd(pred_atom37[..., 1, :], gt_atom37[..., 1, :],
                          ca_mask)[-1],
        "rmsd_ca": rmsd(pred_atom37[..., 1, :], gt_atom37[..., 1, :],
                        ca_mask)[-1],
    }
