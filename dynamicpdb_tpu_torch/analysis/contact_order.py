"""Contact matrix and relative contact order on C-alpha coordinates.

Port of ``dynamicpdb_tpu/analysis/contact_order.py`` (jnp there, torch
here, on whatever device the coordinates are): a contact is a pair closer
than ``cutoff`` whose sequence separation is at least ``min_separation``;
the contact order is the mean separation of contacting pairs over N.
"""
from __future__ import annotations

import torch


def _separation(n: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    return (idx[:, None] - idx[None, :]).abs()


def contact_matrix(ca: torch.Tensor, cutoff: float = 8.0,
                   min_separation: int = 1) -> torch.Tensor:
    """[..., N, 3] -> [..., N, N] boolean contact matrix."""
    d = torch.linalg.norm(ca[..., :, None, :] - ca[..., None, :, :], dim=-1)
    sep = _separation(ca.shape[-2], ca.device)
    return (d < cutoff) & (sep >= min_separation)


def contact_order(ca: torch.Tensor, cutoff: float = 8.0,
                  min_separation: int = 1) -> torch.Tensor:
    """Relative contact order in [0, 1], one per leading index."""
    contacts = contact_matrix(ca, cutoff, min_separation)
    n = ca.shape[-2]
    sep = _separation(n, ca.device).to(torch.float32)
    total = contacts.sum(dim=(-1, -2))
    return (sep * contacts).sum(dim=(-1, -2)) / (total.clamp(min=1) * n)
