"""IGSO(3) (isotropic Gaussian on SO(3)) numerics.

Port of ``dynamicpdb_tpu/diffusion/igso3.py``. The tables are built once in
float64 numpy and cached on disk under the same key and digest as the JAX
package's, so both packages read the same file and hold bit-identical
tables; after that every lookup is a tensor op on the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from dynamicpdb_tpu_torch.utils.platform import resolve_device


def igso3_expansion(
    omega: np.ndarray, sigma: np.ndarray, L: int = 1000
) -> np.ndarray:
    """Truncated series f(omega; sigma) = sum_l (2l+1) e^{-l(l+1)sigma^2/2}
    sin(omega(l+1/2)) / sin(omega/2)."""
    ls = np.arange(L, dtype=np.float64)
    omega = np.asarray(omega, np.float64)[..., None]
    sigma = np.asarray(sigma, np.float64)[..., None]
    p = (
        (2 * ls + 1)
        * np.exp(-ls * (ls + 1) * sigma**2 / 2)
        * np.sin(omega * (ls + 0.5))
        / np.sin(omega / 2)
    )
    return p.sum(axis=-1)


def igso3_score_scale(
    expansion: np.ndarray, omega: np.ndarray, sigma: np.ndarray, L: int = 1000
) -> np.ndarray:
    """d/domega log f(omega; sigma) by the quotient rule, with the
    reference's +1e-4 regulariser in the denominator."""
    ls = np.arange(L, dtype=np.float64)
    omega = np.asarray(omega, np.float64)[..., None]
    sigma = np.asarray(sigma, np.float64)[..., None]
    hi = np.sin(omega * (ls + 0.5))
    dhi = (ls + 0.5) * np.cos(omega * (ls + 0.5))
    lo = np.sin(omega / 2)
    dlo = 0.5 * np.cos(omega / 2)
    dSigma = (
        (2 * ls + 1)
        * np.exp(-ls * (ls + 1) * sigma**2 / 2)
        * (lo * dhi - hi * dlo)
        / lo**2
    ).sum(axis=-1)
    return dSigma / (expansion + 1e-4)


@dataclasses.dataclass(frozen=True)
class IGSO3Tables:
    """Precomputed grids as float32 tensors on one device."""

    discrete_sigma: torch.Tensor  # [num_sigma]
    discrete_omega: torch.Tensor  # [num_omega]
    pdf: torch.Tensor  # [num_sigma, num_omega]
    cdf: torch.Tensor  # [num_sigma, num_omega]
    score_norms: torch.Tensor  # [num_sigma, num_omega]
    score_scaling: torch.Tensor  # [num_sigma]
    cache_file: str | None  # where the tables live on disk, if cached
    cache_hit: bool  # True when they were read from cache_file


def sigma_schedule(
    t, min_sigma: float, max_sigma: float, schedule: str = "logarithmic"
):
    """sigma(t) for a numpy array or a tensor; logarithmic schedule."""
    if schedule != "logarithmic":
        raise ValueError(f"Unrecognized schedule {schedule}")
    if isinstance(t, torch.Tensor):
        return torch.log(t * np.exp(max_sigma) + (1 - t) * np.exp(min_sigma))
    return np.log(t * np.exp(max_sigma) + (1 - t) * np.exp(min_sigma))


def cache_path(cache_dir: str, num_sigma: int, num_omega: int,
               min_sigma: float, max_sigma: float, schedule: str,
               L: int) -> str:
    """The table file's path: the JAX package's key and digest."""
    key = f"{num_sigma}_{num_omega}_{min_sigma}_{max_sigma}_{schedule}_{L}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    return os.path.join(cache_dir, f"igso3_{digest}.npz")


def build_tables(
    *,
    num_sigma: int = 1000,
    num_omega: int = 1000,
    min_sigma: float = 0.1,
    max_sigma: float = 1.5,
    schedule: str = "logarithmic",
    cache_dir: str | None = ".cache/igso3",
    L: int = 1000,
    device="cuda",
) -> IGSO3Tables:
    cache_file = None
    if cache_dir is not None:
        cache_file = cache_path(cache_dir, num_sigma, num_omega, min_sigma,
                                max_sigma, schedule, L)

    hit = cache_file is not None and os.path.exists(cache_file)
    if hit:
        with np.load(cache_file) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        # omega grid skips 0, where the density vanishes
        omega = np.linspace(0, np.pi, num_omega + 1)[1:]
        sigma = np.asarray(
            sigma_schedule(np.linspace(0.0, 1.0, num_sigma), min_sigma,
                           max_sigma, schedule)
        )
        # row by row over sigma: the full [S, O, L] temporary would be GBs
        exp_vals = np.stack([igso3_expansion(omega, s, L=L) for s in sigma])
        pdf = exp_vals * (1 - np.cos(omega)) / np.pi
        cdf = np.cumsum(pdf, axis=-1) / num_omega * np.pi
        score_norms = np.stack(
            [
                igso3_score_scale(exp_vals[i], omega, s, L=L)
                for i, s in enumerate(sigma)
            ]
        )
        score_scaling = np.sqrt(
            np.abs(np.sum(score_norms**2 * pdf, axis=-1) / np.sum(pdf, axis=-1))
        ) / np.sqrt(3)
        arrays = dict(
            discrete_sigma=sigma,
            discrete_omega=omega,
            pdf=pdf,
            cdf=cdf,
            score_norms=score_norms,
            score_scaling=score_scaling,
        )
        if cache_file is not None:
            os.makedirs(cache_dir, exist_ok=True)
            # atomic publish: a concurrent reader never sees a partial file
            tmp = f"{cache_file}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, **arrays)
            os.replace(tmp, cache_file)

    device = resolve_device(device)
    return IGSO3Tables(
        **{
            k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()
        },
        cache_file=cache_file,
        cache_hit=hit,
    )
