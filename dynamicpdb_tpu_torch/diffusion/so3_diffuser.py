"""SO(3) diffusion on tensors.

Port of ``dynamicpdb_tpu/diffusion/so3_diffuser.py``: the logarithmic
sigma(t) schedule, inverse-CDF angle sampling on the precomputed grid, the
IGSO(3) score and the right-multiplied geodesic random walk of the reverse
SDE. Every stochastic method takes a ``torch.Generator`` or the noise
itself, so a test can hand it the numbers JAX drew.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynamicpdb_tpu_torch.diffusion import igso3
from dynamicpdb_tpu_torch.ops import so3
from dynamicpdb_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class SO3Config:
    num_omega: int = 1000
    num_sigma: int = 1000
    min_sigma: float = 0.1
    max_sigma: float = 1.5
    schedule: str = "logarithmic"
    cache_dir: str | None = ".cache/igso3"
    use_cached_score: bool = False
    series_L: int = 1000


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` for 1-D increasing ``xp``: linear, constant outside."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + delta / torch.where(dx0, 1.0, dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class SO3Diffuser:
    def __init__(self, conf: SO3Config = SO3Config(), device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        self.tables = igso3.build_tables(
            num_sigma=conf.num_sigma,
            num_omega=conf.num_omega,
            min_sigma=conf.min_sigma,
            max_sigma=conf.max_sigma,
            schedule=conf.schedule,
            cache_dir=conf.cache_dir,
            L=conf.series_L,
            device=self.device,
        )

    def _t(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.float32, device=self.device)

    # -- schedule -------------------------------------------------------------
    def sigma(self, t):
        return igso3.sigma_schedule(
            self._t(t), self.conf.min_sigma, self.conf.max_sigma,
            self.conf.schedule,
        )

    def diffusion_coef(self, t):
        sig = self.sigma(t)
        return torch.sqrt(
            2
            * (np.exp(self.conf.max_sigma) - np.exp(self.conf.min_sigma))
            * sig
            / torch.exp(sig)
        )

    def t_to_idx(self, t):
        """Index of sigma(t) in the discrete sigma grid (digitize - 1)."""
        idx = torch.searchsorted(
            self.tables.discrete_sigma, self.sigma(t), right=True) - 1
        return torch.clamp(idx, 0, self.conf.num_sigma - 1)

    # -- sampling -------------------------------------------------------------
    def sample(self, t, shape, *, generator=None, axis=None, u=None):
        """Rotation vectors from IGSO3(sigma(t)); ``shape`` = batch dims.
        ``axis`` [*shape, 3] standard normals and ``u`` [*shape] uniforms
        are drawn from ``generator`` unless given."""
        shape = tuple(shape)
        if axis is None:
            axis = torch.randn(shape + (3,), generator=generator,
                               device=self.device)
        if u is None:
            u = torch.rand(shape, generator=generator, device=self.device)
        x = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        cdf = self.tables.cdf[self.t_to_idx(t)]
        omega = interp(u, cdf, self.tables.discrete_omega)
        return x * omega[..., None]

    def sample_ref(self, shape, *, generator=None, axis=None, u=None):
        return self.sample(1.0, shape, generator=generator, axis=axis, u=u)

    # -- score ----------------------------------------------------------------
    def score(self, vec, t, eps: float = 1e-6):
        """Score of the IGSO3 density as a rotation vector: omega = |vec| +
        eps, scalar scale at the grid-quantized sigma, direction vec/omega.
        ``t`` broadcasts against vec's batch dims (scalar or per frame)."""
        omega = torch.linalg.norm(vec, dim=-1) + eps
        sigma_idx = self.t_to_idx(t)
        if self.conf.use_cached_score:
            score_norms_t = self.tables.score_norms[sigma_idx]
            omega_idx = torch.clamp(
                torch.searchsorted(self.tables.discrete_omega[:-1], omega,
                                   right=True),
                0, self.conf.num_omega - 1,
            )
            while score_norms_t.ndim - 1 < omega.ndim:
                score_norms_t = score_norms_t[..., None, :]
            omega_scores = torch.gather(
                score_norms_t.expand(omega.shape + (self.conf.num_omega,)),
                -1, omega_idx[..., None],
            )[..., 0]
        else:
            sigma = self.tables.discrete_sigma[sigma_idx]
            while sigma.ndim < omega.ndim:
                sigma = sigma[..., None]
            omega_scores = _series_score(omega, sigma, self.conf.series_L)
        return omega_scores[..., None] * vec / (omega[..., None] + eps)

    def score_scaling(self, t):
        return self.tables.score_scaling[self.t_to_idx(t)]

    # -- forward / reverse ------------------------------------------------------
    def forward_marginal(self, rot_0, t, *, generator=None, axis=None, u=None):
        """Noise rotation vectors to time t (scalar): rot_t = rot_0 composed
        on the right with an IGSO3(sigma(t)) sample, and the score at that
        sample. ``axis`` and ``u`` are the sample's draws (see ``sample``)."""
        sampled = self.sample(t, rot_0.shape[:-1], generator=generator,
                              axis=axis, u=u)
        rot_score = self.score(sampled, t)
        return so3.compose_rotvec(rot_0, sampled), rot_score

    def reverse(self, rot_t, score_t, t, dt, noise_scale=1.0, mask=None, *,
                generator=None, z=None):
        """One geodesic-random-walk reverse step; ``z`` (standard normals
        shaped like score_t) is drawn from ``generator`` unless given."""
        g_t = self.diffusion_coef(t)
        if z is None:
            z = torch.randn(score_t.shape, generator=generator,
                            device=score_t.device)
        z = noise_scale * z
        perturb = (g_t**2) * score_t * dt + g_t * np.sqrt(dt) * z
        if mask is not None:
            perturb = perturb * mask[..., None]
        return so3.compose_rotvec(rot_t, perturb)


def _series_score(omega, sigma, L):
    """Exact truncated-series score scale (matches igso3_score_scale)."""
    ls = torch.arange(L, dtype=torch.float32, device=omega.device)
    omega_e = omega[..., None]
    sigma_e = sigma[..., None]
    hi = torch.sin(omega_e * (ls + 0.5))
    dhi = (ls + 0.5) * torch.cos(omega_e * (ls + 0.5))
    lo = torch.sin(omega_e / 2)
    dlo = 0.5 * torch.cos(omega_e / 2)
    coef = (2 * ls + 1) * torch.exp(-ls * (ls + 1) * sigma_e**2 / 2)
    dSigma = torch.sum(coef * (lo * dhi - hi * dlo) / lo**2, dim=-1)
    exp_val = torch.sum(coef * hi / lo, dim=-1)
    return dSigma / (exp_val + 1e-4)
