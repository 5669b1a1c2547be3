"""Reverse-diffusion sampling and autoregressive rollout.

Port of ``set_t_feats``, ``reverse_sample`` and ``rollout`` from
``dynamicpdb_tpu/sampling/reverse.py``; the JAX scans are Python loops.

  * reverse steps = linspace(min_t, 1, num_t) reversed, dt = 1/num_t;
  * for t > min_t: model forward -> scores -> SE(3) reverse SDE step;
  * at t = min_t the model's x0 prediction is taken directly;
  * the rollout slides the window: rigids_0 <- cat(pred[1:], pred[-1:]).

``refresh_conditioning``, ``batched_rollout``, classifier-free guidance and
the Picard sampler are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from dynamicpdb_tpu_torch.models.score_network import score_forward
from dynamicpdb_tpu_torch.ops.rigid import Rigid


def set_t_feats(diffuser, feats: dict[str, Any], t: float) -> dict[str, Any]:
    """Set t and the score scalings on a featurized window."""
    F = feats["res_mask"].shape[0]
    device = feats["res_mask"].device
    rot_s, trans_s = diffuser.score_scaling(t)
    out = dict(feats)
    out["t"] = torch.full((F,), float(t), device=device)
    out["rot_score_scaling"] = rot_s.expand(F)
    out["trans_score_scaling"] = trans_s.expand(F)
    return out


def diffuse_mask_of(feats: dict[str, Any]):
    return (1 - feats["fixed_mask"].float()) * feats["res_mask"].float()


@torch.no_grad()
def reverse_sample(model, diffuser, init_feats: dict[str, Any], *,
                   num_t: int = 10, min_t: float = 0.01,
                   noise_scale: float = 1.0, center: bool = True,
                   generator: torch.Generator | None = None):
    """Run the reverse diffusion for one window whose rigids_t holds the
    reference noise (``data/featurize.eval_init_window``). The SDE noise
    comes from ``generator``. Returns the final rigids, atom37, atom14 and
    angles."""
    reverse_steps = torch.linspace(min_t, 1.0, num_t).flip(0).tolist()
    dt = 1.0 / num_t
    diffuse_mask = diffuse_mask_of(init_feats)

    rigids_t7 = init_feats["rigids_t"]
    for t in reverse_steps[:-1]:
        feats = set_t_feats(diffuser, dict(init_feats, rigids_t=rigids_t7), t)
        out = score_forward(model, diffuser, feats)
        rigids_t7 = diffuser.reverse(
            Rigid.from_tensor_7(rigids_t7), out["rot_score"],
            out["trans_score"], t, dt, diffuse_mask=diffuse_mask,
            center=center, noise_scale=noise_scale, generator=generator,
        ).to_tensor_7()

    # final step at t = min_t: take the model x0 directly
    feats = set_t_feats(diffuser, dict(init_feats, rigids_t=rigids_t7), min_t)
    out = score_forward(model, diffuser, feats)
    return {k: out[k] for k in ("rigids", "atom37", "atom14", "angles")}


@torch.no_grad()
def rollout(model, diffuser, init_feats: dict[str, Any], *, n_steps: int,
            num_t: int = 10, min_t: float = 0.01, noise_scale: float = 1.0,
            center: bool = True, fast_x0: bool = False,
            generator: torch.Generator | None = None):
    """Autoregressive extension: each step denoises a fresh window, then
    slides it. Only the rigid window slides; the force, velocity and torsion
    channels stay those of ``init_feats``, as in the reference.

    ``fast_x0=True`` runs ONE forward per frame: the network predicts x0
    from the clean reference frames, rigids_t and t enter only the score
    conversion, and the sampler's last step takes x0 directly, so the
    returned frames equal the full num_t-step sampler's.

    Returns (atom37_traj [n_steps, N, 37, 3], rigid_traj [n_steps, N, 7]).
    """
    F, N = init_feats["res_mask"].shape
    device = init_feats["res_mask"].device
    rigids_0 = init_feats["rigids_0"]
    atoms, rigids = [], []
    for _ in range(n_steps):
        feats = dict(init_feats, rigids_0=rigids_0)
        if fast_x0:
            identity = torch.zeros((F, N, 7), device=device)
            identity[..., 0] = 1.0
            feats["rigids_t"] = identity
            out = score_forward(model, diffuser,
                                set_t_feats(diffuser, feats, min_t))
        else:
            feats["rigids_t"] = diffuser.sample_ref((F, N), generator=generator)
            out = reverse_sample(
                model, diffuser, feats, num_t=num_t, min_t=min_t,
                noise_scale=noise_scale, center=center, generator=generator,
            )
        pred = out["rigids"]
        rigids_0 = torch.cat([pred[1:], pred[-1:]], dim=0)
        atoms.append(out["atom37"][-1])
        rigids.append(pred[-1])
    return torch.stack(atoms), torch.stack(rigids)
