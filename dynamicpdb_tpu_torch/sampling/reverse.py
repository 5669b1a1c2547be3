"""Reverse-diffusion sampling and autoregressive rollout.

Port of ``dynamicpdb_tpu/sampling/reverse.py`` (``set_t_feats``,
``reverse_sample``, ``make_sampler``, ``refresh_window_conditioning``,
``rollout``, ``batched_rollout``); the JAX scans are Python loops.

  * reverse steps = linspace(min_t, 1, num_t) reversed, dt = 1/num_t;
  * for t > min_t: model forward -> scores -> SE(3) reverse SDE step;
    with classifier-free guidance (``cfg_gamma``) a second forward without
    the reference frames guides the translation score;
  * at t = min_t the model's x0 prediction is taken directly;
  * the rollout slides the window: rigids_0 <- cat(pred[1:], pred[-1:]);
  * ``batched_rollout`` runs the rollout of several windows, one after
    another (the network has no batch axis), each with its own generator.

The parallel-in-time sampler is ``sampling/picard.py``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
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
                   cfg_gamma: float | None = None, aux_traj: bool = False,
                   generator: torch.Generator | None = None,
                   noise: list | None = None):
    """Run the reverse diffusion for one window whose rigids_t holds the
    reference noise (``data/featurize.eval_init_window``).

    The SDE noise of step s comes from ``noise[s]``, a (rot_z, trans_z)
    pair of [F, N, 3] standard normals, when given (one pair for each of
    the num_t - 1 SDE steps), else from ``generator``. ``cfg_gamma``
    mixes the translation scores of a forward with and one without the
    reference frames: unref + cfg_gamma (ref - unref). Returns the final
    rigids, atom37, atom14 and angles; with ``aux_traj`` also prot_traj
    [num_t, F, N, 37, 3] and rigid_traj [num_t, F, N, 7], time-forward:
    the final prediction first, then each SDE step's prediction from the
    last step (smallest t) back to the first (t = 1)."""
    reverse_steps = torch.linspace(min_t, 1.0, num_t).flip(0).tolist()
    dt = 1.0 / num_t
    diffuse_mask = diffuse_mask_of(init_feats)
    if noise is not None and len(noise) != num_t - 1:
        raise ValueError(f"noise has {len(noise)} steps, the sampler takes "
                         f"{num_t - 1}")

    rigids_t7 = init_feats["rigids_t"]
    atoms, rigids = [], []
    for s, t in enumerate(reverse_steps[:-1]):
        feats = set_t_feats(diffuser, dict(init_feats, rigids_t=rigids_t7), t)
        out = score_forward(model, diffuser, feats)
        trans_score = out["trans_score"]
        if cfg_gamma is not None:
            unref = score_forward(model, diffuser, feats,
                                  drop_ref=True)["trans_score"]
            trans_score = unref + cfg_gamma * (trans_score - unref)
        rot_z, trans_z = noise[s] if noise is not None else (None, None)
        rigids_t7 = diffuser.reverse(
            Rigid.from_tensor_7(rigids_t7), out["rot_score"], trans_score,
            t, dt, diffuse_mask=diffuse_mask, center=center,
            noise_scale=noise_scale, generator=generator, rot_z=rot_z,
            trans_z=trans_z,
        ).to_tensor_7()
        if aux_traj:
            atoms.append(out["atom37"])
            rigids.append(out["rigids"])

    # final step at t = min_t: take the model x0 directly
    feats = set_t_feats(diffuser, dict(init_feats, rigids_t=rigids_t7), min_t)
    out = score_forward(model, diffuser, feats)
    result = {k: out[k] for k in ("rigids", "atom37", "atom14", "angles")}
    if aux_traj:
        result["prot_traj"] = torch.stack([out["atom37"]] + atoms[::-1])
        result["rigid_traj"] = torch.stack([out["rigids"]] + rigids[::-1])
    return result


def make_sampler(model, diffuser, *, num_t: int = 10, min_t: float = 0.01,
                 noise_scale: float = 1.0, center: bool = True,
                 cfg_gamma: float | None = None, aux_traj: bool = False):
    """A single-window sampler with its settings bound:
    ``fn(init_feats, generator=None, noise=None)`` -> ``reverse_sample``'s
    result."""

    def fn(init_feats, generator=None, noise=None):
        return reverse_sample(
            model, diffuser, init_feats, num_t=num_t, min_t=min_t,
            noise_scale=noise_scale, center=center, cfg_gamma=cfg_gamma,
            aux_traj=aux_traj, generator=generator, noise=noise)

    return fn


def refresh_window_conditioning(pred_rigids_t7, pred_angles, dt_ps: float):
    """The slidable conditioning channels of the NEXT window, re-derived
    from a window of predicted frames: vel[f] = (ca[f] - ca[f-1]) / dt_ps
    (the backward difference the release data defines velocities by; ca is
    the rigid translation, frame 0 backfilled), and the predicted torsion
    angles; both then slide like the rigids, cat(x[1:], x[-1:]). Forces
    cannot be re-derived without a force field and stay frozen.

    Returns (vel [F, N, 3], angles [F, N, 7, 2])."""
    ca = pred_rigids_t7[..., 4:]
    vel = (ca[1:] - ca[:-1]) / dt_ps
    vel = torch.cat([vel[:1], vel], dim=0)  # backfill frame 0
    next_vel = torch.cat([vel[1:], vel[-1:]], dim=0)
    next_angles = torch.cat([pred_angles[1:], pred_angles[-1:]], dim=0)
    return next_vel, next_angles


@torch.no_grad()
def rollout(model, diffuser, init_feats: dict[str, Any], *, n_steps: int,
            num_t: int = 10, min_t: float = 0.01, noise_scale: float = 1.0,
            center: bool = True, fast_x0: bool = False,
            refresh_conditioning: bool = False, dt_ps: float = 1.0,
            generator: torch.Generator | None = None):
    """Autoregressive extension: each step denoises a fresh window, then
    slides it. By default only the rigid window slides; the force,
    velocity and torsion channels stay those of ``init_feats``, as in the
    reference. ``refresh_conditioning=True`` re-derives the velocities
    from the predicted translations (over ``dt_ps``) and slides the
    predicted torsion angles (``refresh_window_conditioning``); forces
    stay frozen either way.

    ``fast_x0=True`` runs ONE forward per frame: the network predicts x0
    from the clean reference frames, rigids_t and t enter only the score
    conversion, and the sampler's last step takes x0 directly, so the
    returned frames equal the full num_t-step sampler's.

    Returns (atom37_traj [n_steps, N, 37, 3], rigid_traj [n_steps, N, 7]).
    """
    F, N = init_feats["res_mask"].shape
    device = init_feats["res_mask"].device
    rigids_0 = init_feats["rigids_0"]
    vel, angles = init_feats["vel"], init_feats["torsion_angles_sin_cos"]
    atoms, rigids = [], []
    for _ in range(n_steps):
        feats = dict(init_feats, rigids_0=rigids_0)
        if refresh_conditioning:
            feats["vel"], feats["torsion_angles_sin_cos"] = vel, angles
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
        if refresh_conditioning:
            vel, angles = refresh_window_conditioning(pred, out["angles"],
                                                      dt_ps)
        atoms.append(out["atom37"][-1])
        rigids.append(pred[-1])
    return torch.stack(atoms), torch.stack(rigids)


def window_generators(seed: int, n: int, device) -> list[torch.Generator]:
    """One generator per window on ``device``, window b's seeded from
    (seed, b)."""
    return [torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence([seed, b]).generate_state(1, np.uint64)[0]))
            for b in range(n)]


@torch.no_grad()
def batched_rollout(model, diffuser, init_feats_batch: dict[str, Any], *,
                    n_steps: int, num_t: int = 10, min_t: float = 0.01,
                    noise_scale: float = 1.0, center: bool = True,
                    fast_x0: bool = False, seed: int = 0):
    """``rollout`` over B featurized windows stacked on axis 0 ([B, F, N,
    ...]; different proteins padded to one N, or different starting
    windows), window b with the generator ``window_generators(seed, B)[b]``.
    The windows run one after another: the network has no batch axis, and
    every GlobalStatNorm statistic stays per window as under the JAX
    package's ``vmap``. The returned frames do not depend on the noise (the
    network predicts x0 from the clean reference frames; see ``rollout``),
    so replicas of one window differ only through their conditioning.

    Returns (atom37_traj [B, n_steps, N, 37, 3], rigid_traj [B, n_steps, N,
    7])."""
    B = init_feats_batch["res_mask"].shape[0]
    gens = window_generators(seed, B, init_feats_batch["res_mask"].device)
    atoms, rigids = [], []
    for b in range(B):
        a, r = rollout(model, diffuser,
                       {k: v[b] for k, v in init_feats_batch.items()},
                       n_steps=n_steps, num_t=num_t, min_t=min_t,
                       noise_scale=noise_scale, center=center,
                       fast_x0=fast_x0, generator=gens[b])
        atoms.append(a)
        rigids.append(r)
    return torch.stack(atoms), torch.stack(rigids)
