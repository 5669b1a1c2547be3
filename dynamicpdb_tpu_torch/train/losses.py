"""Training losses for the trajectory-diffusion model.

Port of ``dynamicpdb_tpu/train/losses.py``, with its departures from the
reference kept exactly:

    loss = rot_score MSE / scaling^2      (weight 7,  last frame only)
         + trans x0 MSE                   (weight 100, last frame only)
         + torsion angle loss             (weight 1,  last frame only)

  * the translation loss is masked by the loss mask (identical to the
    reference's unmasked mean when every residue is real);
  * the outlier guard is sequential: rot and trans are zeroed when the
    weighted translation loss is >= 100, the torsion loss survives;
  * the torsion loss uses squared distances, so its gradient stays finite
    where the prediction equals the target.

All functions take ONE window ([F, N, ...]). Under sequence parallelism
(``parallel/sp.py``) every rank still computes the loss on the whole
window: the model gathers its outputs back, so the sums over N are global
and the outlier guard reads the global translation loss, as in one
process.
"""
from __future__ import annotations

import torch

from dynamicpdb_tpu_torch.config import ExperimentConfig


def torsion_angle_loss(a, a_gt, a_alt_gt, mask, eps: float = 1e-8):
    """Per-frame AF2 torsion loss with masked normalisation. a: [F, N, 7, 2].
    Returns [F]."""
    norm = torch.sqrt(torch.sum(a**2, dim=-1) + eps**2)
    a = a / (norm[..., None] + eps)
    diff_gt = torch.sum((a - a_gt) ** 2, dim=-1)
    diff_alt = torch.sum((a - a_alt_gt) ** 2, dim=-1)
    min_diff = torch.minimum(diff_gt, diff_alt)
    denom = torch.sum(mask, dim=(-1, -2)) + 1e-2
    return torch.sum(min_diff * mask, dim=(-1, -2)) / denom


def dfold_loss(model_out, batch, conf: ExperimentConfig):
    """Window loss and an aux dict. Frame axis = dim 0; loss on the last
    frame."""
    bb_mask = batch["res_mask"].float()  # [F, N]
    diffuse_mask = 1 - batch["fixed_mask"].float()
    loss_mask = bb_mask * diffuse_mask
    t = batch["t"]

    torsion_all = torsion_angle_loss(
        model_out["angles"],
        batch["torsion_angles_sin_cos"],
        batch["alt_torsion_angles_sin_cos"],
        batch["torsion_angles_mask"],
    )
    torsion_loss = torsion_all[-1] * conf.torsion_loss_weight

    gt_trans_x0 = batch["rigids_0"][..., 4:]
    pred_trans_x0 = model_out["rigids"][..., 4:]
    tmask = loss_mask[-1][..., None]
    trans_loss = (
        torch.sum((gt_trans_x0[-1] - pred_trans_x0[-1]) ** 2 * tmask)
        / (3.0 * torch.sum(loss_mask[-1]) + 1e-10)
    ) * conf.trans_loss_weight

    gt_rot_score = batch["rot_score"]
    pred_rot_score = model_out["rot_score"] * diffuse_mask[..., None]
    rot_scaling = torch.as_tensor(batch["rot_score_scaling"],
                                  device=t.device).expand(t.shape)
    rot_mse = (gt_rot_score - pred_rot_score) ** 2 * loss_mask[..., None]
    rot_all = torch.sum(rot_mse, dim=(-1, -2)) / (
        torch.sum(loss_mask, dim=-1) + 1e-10
    ) / rot_scaling**2
    rot_all = rot_all * conf.rot_loss_weight * (t > conf.rot_loss_t_threshold)
    rot_loss = rot_all[-1]

    # sequential guard: trans_loss is reassigned before any torsion guard
    # could read it, so the torsion loss survives outlier windows
    guard = (trans_loss < 100.0).float()
    rot_loss = rot_loss * guard
    trans_loss = trans_loss * guard

    total = rot_loss + trans_loss + torsion_loss
    aux = {
        "total_loss": total,
        "rot_loss": rot_loss,
        "trans_loss": trans_loss,
        "torsion_loss": torsion_loss,
    }
    return total, aux
