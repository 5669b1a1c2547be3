"""Window featurization on the device.

Port of ``featurize_window`` and ``eval_init_window`` from
``dynamicpdb_tpu/data/featurize.py``: atom37 -> backbone rigids + torsions
+ masks, then t=1 reference noise for sampling. The training-side
functions (forward diffusion, conditioning perturbation) belong to the
training slice.

Raw window layout (one example):
    atom37 [F, N, 37, 3], atom37_mask [N, 37], aatype [N],
    residue_index [N], force [F, N, 3], vel [F, N, 3],
    node_repr [N, Dn], edge_repr [N, N, De]
"""
from __future__ import annotations

import torch

from dynamicpdb_tpu_torch.ops import frames as frame_ops


def featurize_window(raw: dict) -> dict:
    """Geometry featurization (no diffusion): frames, torsions and masks.
    ``raw`` holds tensors, all on one device."""
    atom37 = raw["atom37"].float()
    mask37 = raw["atom37_mask"].float()
    aatype = raw["aatype"].long()
    F = atom37.shape[0]

    atom37 = atom37 * mask37[None, ..., None]
    res_mask = mask37[:, 1]  # C-alpha presence

    rigids_0 = frame_ops.atom37_to_frames(aatype, atom37, mask37)["backbone_rigid"]
    torsions = frame_ops.atom37_to_torsion_angles(aatype, atom37, mask37)

    def tile(x):
        return x[None].expand((F,) + x.shape)

    return {
        "aatype": tile(aatype),
        "seq_idx": tile(raw["residue_index"].long()),
        "res_mask": tile(res_mask),
        "fixed_mask": torch.zeros((F,) + res_mask.shape, device=atom37.device),
        "rigids_0": rigids_0.to_tensor_7(),
        "torsion_angles_sin_cos": torsions["torsion_angles_sin_cos"],
        "alt_torsion_angles_sin_cos": torsions["alt_torsion_angles_sin_cos"],
        "torsion_angles_mask": torsions["torsion_angles_mask"],
        "atom37_pos": atom37,
        "atom37_mask": tile(mask37),
        "force": raw["force"].float(),
        "vel": raw["vel"].float(),
        "node_repr": raw["node_repr"].float(),
        "edge_repr": raw["edge_repr"].float(),
    }


def eval_init_window(feats: dict, diffuser, *, generator=None,
                     noise: dict | None = None) -> dict:
    """t=1 reference-noise init for sampling. ``noise`` may carry the
    sample_ref draws (rot_axis, rot_u, trans_z) instead of ``generator``."""
    F, N = feats["res_mask"].shape
    rigids_t = diffuser.sample_ref((F, N), generator=generator, **(noise or {}))
    rot_scaling, trans_scaling = diffuser.score_scaling(1.0)
    device = rigids_t.device
    out = dict(feats)
    out.update(
        {
            "rigids_t": rigids_t,
            "t": torch.ones((F,), device=device),
            "rot_score_scaling": rot_scaling.expand(F).to(device),
            "trans_score_scaling": trans_scaling.expand(F).to(device),
        }
    )
    return out
