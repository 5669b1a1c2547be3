"""R^3 VP-SDE diffusion on translations.

Port of ``dynamicpdb_tpu/diffusion/r3_diffuser.py``: linear beta schedule,
closed-form marginal, Euler-Maruyama reverse step with optional
centre-of-mass re-centring, and the coordinate-scaling hooks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynamicpdb_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class R3Config:
    min_b: float = 0.1
    max_b: float = 20.0
    coordinate_scaling: float = 1.0


class R3Diffuser:
    def __init__(self, conf: R3Config = R3Config(), device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)

    def _t(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.float32, device=self.device)

    def _scale(self, x):
        return x * self.conf.coordinate_scaling

    def _unscale(self, x):
        return x / self.conf.coordinate_scaling

    def b_t(self, t):
        return self.conf.min_b + self._t(t) * (self.conf.max_b - self.conf.min_b)

    def marginal_b_t(self, t):
        t = self._t(t)
        return t * self.conf.min_b + 0.5 * t**2 * (self.conf.max_b - self.conf.min_b)

    def diffusion_coef(self, t):
        return torch.sqrt(self.b_t(t))

    def drift_coef(self, x, t):
        return -0.5 * self.b_t(t) * x

    def conditional_var(self, t):
        return 1 - torch.exp(-self.marginal_b_t(t))

    def score_scaling(self, t):
        return 1 / torch.sqrt(self.conditional_var(t))

    def sample_ref(self, shape, *, generator=None, z=None):
        if z is None:
            z = torch.randn(tuple(shape) + (3,), generator=generator,
                            device=self.device)
        return z

    def score(self, x_t, x_0, t, scale: bool = False):
        """Score of p(x_t | x_0); t broadcasts over trailing dims."""
        if scale:
            x_t, x_0 = self._scale(x_t), self._scale(x_0)
        bt = self.marginal_b_t(t)
        return -(x_t - torch.exp(-0.5 * bt) * x_0) / self.conditional_var(t)

    def forward_marginal(self, x_0, t, *, generator=None, z=None):
        """Exact sample of p(x_t | x_0) and its score. x_0 in Angstroms;
        x_t comes back in Angstroms, the score in scaled coordinates. ``z``
        (standard normals shaped like x_0) is drawn from ``generator``
        unless given."""
        x_0 = self._scale(x_0)
        bt = self.marginal_b_t(t)
        if z is None:
            z = torch.randn(x_0.shape, generator=generator, device=x_0.device)
        x_t = torch.exp(-0.5 * bt) * x_0 + torch.sqrt(1 - torch.exp(-bt)) * z
        return self._unscale(x_t), self.score(x_t, x_0, t)

    def reverse(self, x_t, score_t, t, dt, mask=None, center: bool = True,
                noise_scale: float = 1.0, *, generator=None, z=None):
        """One Euler-Maruyama reverse step; ``z`` (standard normals shaped
        like score_t) is drawn from ``generator`` unless given."""
        x_t = self._scale(x_t)
        g_t = self.diffusion_coef(t)
        f_t = self.drift_coef(x_t, t)
        if z is None:
            z = torch.randn(score_t.shape, generator=generator,
                            device=score_t.device)
        z = noise_scale * z
        perturb = (f_t - g_t**2 * score_t) * dt + g_t * np.sqrt(dt) * z
        if mask is not None:
            perturb = perturb * mask[..., None]
            denom = torch.sum(mask, dim=-1)[..., None]
        else:
            denom = float(x_t.shape[-2])
        x_t_1 = x_t - perturb
        if center:
            com = torch.sum(x_t_1, dim=-2) / denom
            x_t_1 = x_t_1 - com[..., None, :]
        return self._unscale(x_t_1)
