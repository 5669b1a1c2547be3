"""Window featurization on the device.

Port of ``featurize_window`` and ``eval_init_window`` from
``dynamicpdb_tpu/data/featurize.py``: atom37 -> backbone rigids + torsions
+ masks, the training-time forward diffusion and conditioning
perturbation, and the t=1 reference noise for sampling. Every stochastic
function takes its draws through ``noise=`` (so a test can hand it the
numbers JAX drew) or a ``torch.Generator``.

Raw window layout (one example):
    atom37 [F, N, 37, 3], atom37_mask [N, 37], aatype [N],
    residue_index [N], force [F, N, 3], vel [F, N, 3],
    node_repr [N, Dn], edge_repr [N, N, De]
"""
from __future__ import annotations

import torch

from dynamicpdb_tpu_torch.ops import frames as frame_ops
from dynamicpdb_tpu_torch.ops import so3
from dynamicpdb_tpu_torch.ops.rigid import Rigid


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


def perturb_conditioning_rigids(rigids_0, trans_std: float,
                                rot_std_rad: float, *, generator=None,
                                noise: dict | None = None):
    """Exposure-bias robustifier: compose a small random SE(3) error onto
    the conditioning frames (all but the last) of rigids_0 [F, N, 7],
    leaving the target frame clean. Per-residue Gaussian rotation vector
    (std rot_std_rad) composed in the local frame and Gaussian translation
    (std trans_std, Angstrom), both scaled by one u ~ U(0, 1) per window.
    ``noise`` may carry the draws: u (scalar), rot and trans ([F, N, 3]
    standard normals)."""
    noise = dict(noise or {})
    shape = rigids_0.shape[:-1] + (3,)
    dev = rigids_0.device
    u = noise.get("u")
    if u is None:
        u = torch.rand((), generator=generator, device=dev)
    rot = noise.get("rot")
    if rot is None:
        rot = torch.randn(shape, generator=generator, device=dev)
    trans = noise.get("trans")
    if trans is None:
        trans = torch.randn(shape, generator=generator, device=dev)
    rotvec = rot_std_rad * u * rot
    dtrans = trans_std * u * trans
    q = so3.quat_multiply(rigids_0[..., :4], so3.rotvec_to_quat(rotvec))
    pert = torch.cat([q, rigids_0[..., 4:] + dtrans], dim=-1)
    return torch.cat([pert[:-1], rigids_0[-1:]], dim=0)


def diffuse_training_window(feats: dict, diffuser, min_t: float, *,
                            generator=None, noise: dict | None = None) -> dict:
    """Sample t ~ U(min_t, 1) and noise all F frames. ``noise`` may carry
    t (scalar) and the forward marginal's draws rot_axis [F, N, 3],
    rot_u [F, N] and trans_z [F, N, 3]."""
    noise = dict(noise or {})
    dev = feats["rigids_0"].device
    t = noise.get("t")
    if t is None:
        t = min_t + (1.0 - min_t) * torch.rand((), generator=generator,
                                               device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    diff = diffuser.forward_marginal(
        Rigid.from_tensor_7(feats["rigids_0"]), t, generator=generator,
        rot_axis=noise.get("rot_axis"), rot_u=noise.get("rot_u"),
        trans_z=noise.get("trans_z"))
    F = feats["rigids_0"].shape[0]
    out = dict(feats)
    out.update(
        {
            "rigids_t": diff["rigids_t"],
            "rot_score": diff["rot_score"],
            "trans_score": diff["trans_score"],
            "rot_score_scaling": diff["rot_score_scaling"].expand(F).to(dev),
            "trans_score_scaling": diff["trans_score_scaling"].expand(F).to(dev),
            "t": t.expand(F),
        }
    )
    return out


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
