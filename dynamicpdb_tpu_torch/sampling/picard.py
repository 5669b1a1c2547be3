"""Parallel-in-time (Picard) reverse-diffusion sampling.

Port of ``dynamicpdb_tpu/sampling/picard.py``. The sequential sampler
(``sampling/reverse.py``) runs the num_t reverse steps in order. Picard
iteration treats the whole reverse chain X = (x_0 .. x_{T-1}) as the fixed
point of X[0] = x_init, X[k+1] = F_k(X[k]) (one reverse SDE step at time
t_k with noise z_k) and sweeps every step per iteration:

    X^{m+1}[k+1] = F_k(X^m[k])   for every k

After m sweeps the first m+1 entries are exact, so T-1 sweeps reach the
sequential chain. The noise z_k is fixed up front, drawn in the order the
sequential sampler draws it, so the fixed point is the sequential answer.

The JAX package ``vmap``s a sweep's T-1 steps into one batch; the port's
network has no batch axis, so a sweep runs its T-1 forwards one after
another, and the stop test (sweep delta > tol) reads the delta on the host
once a sweep. The JAX package measured convergence as wavefront-limited
on this sampler (the reverse Euler-Maruyama map is not a strong
contraction): the sweeps reach T-1 at any useful tolerance.
"""
from __future__ import annotations

from typing import Any

import torch

from dynamicpdb_tpu_torch.models.score_network import score_forward
from dynamicpdb_tpu_torch.ops.rigid import Rigid
from dynamicpdb_tpu_torch.sampling.reverse import diffuse_mask_of, set_t_feats


def draw_reverse_noise(diffuser, shape, num_t: int,
                       generator: torch.Generator | None = None,
                       device=None) -> list:
    """The num_t - 1 (rot_z, trans_z) pairs of standard normals [*shape, 3]
    that ``reverse_sample`` draws from ``generator``, in its order (per
    step: rotation, then translation; None for an SDE the diffuser does not
    run)."""
    conf = diffuser.conf

    def z(on):
        return (torch.randn(tuple(shape) + (3,), generator=generator,
                            device=device) if on else None)

    return [(z(conf.diffuse_rot), z(conf.diffuse_trans))
            for _ in range(num_t - 1)]


@torch.no_grad()
def picard_reverse_sample(model, diffuser, init_feats: dict[str, Any], *,
                          num_t: int = 10, min_t: float = 0.01,
                          noise_scale: float = 1.0, center: bool = True,
                          tol: float = 1e-3, max_sweeps: int | None = None,
                          generator: torch.Generator | None = None,
                          noise: list | None = None):
    """Parallel-in-time reverse sampling for one window.

    ``reverse_sample``'s contract without aux_traj and guidance: the SDE
    noise is ``noise`` (num_t - 1 (rot_z, trans_z) pairs, as
    ``reverse_sample`` takes them) or drawn up front from ``generator`` by
    ``draw_reverse_noise``. Sweeps run while the largest change of the
    chain exceeds ``tol``, at most ``max_sweeps`` (default num_t - 1) of
    them. With tol = 0 and max_sweeps = num_t - 1 the result equals
    ``reverse_sample`` on the same noise.

    Returns {rigids, atom37, atom14, angles, n_sweeps (int), sweep_delta
    (the last sweep's change, a 0-dim tensor; inf without a sweep)}."""
    T = num_t
    reverse_steps = torch.linspace(min_t, 1.0, T).flip(0).tolist()
    dt = 1.0 / T
    if max_sweeps is None:
        max_sweeps = T - 1
    x0 = init_feats["rigids_t"]
    if noise is None:
        noise = draw_reverse_noise(diffuser, x0.shape[:-1], T,
                                   generator=generator, device=x0.device)
    elif len(noise) != T - 1:
        raise ValueError(f"noise has {len(noise)} steps, the sampler takes "
                         f"{T - 1}")
    diffuse_mask = diffuse_mask_of(init_feats)

    def step(k, x7):
        """F_k: one reverse SDE step at t_k with the fixed noise z_k."""
        t = reverse_steps[k]
        feats = set_t_feats(diffuser, dict(init_feats, rigids_t=x7), t)
        out = score_forward(model, diffuser, feats)
        rot_z, trans_z = noise[k]
        return diffuser.reverse(
            Rigid.from_tensor_7(x7), out["rot_score"], out["trans_score"], t,
            dt, diffuse_mask=diffuse_mask, center=center,
            noise_scale=noise_scale, rot_z=rot_z, trans_z=trans_z,
        ).to_tensor_7()

    X = [x0] * T
    delta = torch.tensor(float("inf"), device=x0.device)
    n_sweeps = 0
    while n_sweeps < max_sweeps and float(delta) > tol:  # one sync a sweep
        X_new = [x0] + [step(k, X[k]) for k in range(T - 1)]
        delta = torch.stack([(a - b).abs().max()
                             for a, b in zip(X_new, X)]).max()
        X = X_new
        n_sweeps += 1

    # final step at t = min_t: take the model x0 directly
    feats = set_t_feats(diffuser, dict(init_feats, rigids_t=X[-1]), min_t)
    out = score_forward(model, diffuser, feats)
    result = {k: out[k] for k in ("rigids", "atom37", "atom14", "angles")}
    result["n_sweeps"] = n_sweeps
    result["sweep_delta"] = delta
    return result
