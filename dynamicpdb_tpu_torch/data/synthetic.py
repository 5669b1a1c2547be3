"""Synthetic protein windows for requests and test fixtures.

Port of ``make_window`` from ``dynamicpdb_tpu/data/synthetic.py`` (numpy
only): an idealised alpha-helix backbone that wiggles smoothly over time,
random force/velocity channels and fake OmegaFold embeddings, in the raw
window layout of ``data/featurize.py``. The same seed gives the same arrays
as the JAX package's function.
"""
from __future__ import annotations

import numpy as np

from dynamicpdb_tpu_torch.chem import constants as chem

# idealised helix: rise 1.5 A, ~100 deg per residue, radius 2.3 A
_HELIX_RISE = 1.5
_HELIX_TURN = np.deg2rad(100.0)
_HELIX_RADIUS = 2.3


def helix_backbone(n_res: int) -> np.ndarray:
    """[N, 3] C-alpha helix trace."""
    i = np.arange(n_res)
    return np.stack(
        [
            _HELIX_RADIUS * np.cos(_HELIX_TURN * i),
            _HELIX_RADIUS * np.sin(_HELIX_TURN * i),
            _HELIX_RISE * i,
        ],
        axis=-1,
    )


def _rotvec_to_mat(v):
    """[..., 3] rotation vectors -> [..., 3, 3] matrices (Rodrigues)."""
    theta = np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
    k = v / theta
    K = np.zeros(v.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


def make_window(
    n_res: int = 32,
    frame_time: int = 2,
    node_dim: int = 256,
    edge_dim: int = 128,
    seed: int = 0,
    wiggle: float = 0.3,
    rot_wiggle: float = 0.0,
) -> dict:
    """One raw window (numpy dict in the data/featurize.py layout)."""
    rng = np.random.default_rng(seed)
    aatype = rng.integers(0, 20, n_res).astype(np.int32)
    mask37 = np.asarray(chem.restype_atom37_mask)[aatype]  # [N, 37]

    ca = helix_backbone(n_res)
    # N and C near CA along the chain direction; O offset from C
    chain_dir = np.gradient(ca, axis=0)
    chain_dir /= np.linalg.norm(chain_dir, axis=-1, keepdims=True) + 1e-9
    perp = np.cross(chain_dir, [0.0, 0.0, 1.0])
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True) + 1e-9

    atom37_one = np.zeros((n_res, 37, 3))
    atom37_one[:, 1] = ca  # CA
    atom37_one[:, 0] = ca - 1.46 * chain_dir + 0.3 * perp  # N
    atom37_one[:, 2] = ca + 1.52 * chain_dir + 0.3 * perp  # C
    atom37_one[:, 4] = atom37_one[:, 2] + 1.23 * perp  # O
    atom37_one[:, 3] = ca + 1.53 * perp  # CB
    # remaining side-chain atoms scattered near CB
    side = rng.normal(size=(n_res, 37, 3)) * 0.8 + atom37_one[:, 3:4]
    atom37_one = np.where(
        (np.arange(37)[None, :, None] >= 5), side, atom37_one
    )
    atom37_one *= mask37[..., None]

    # temporally correlated wiggle; rot_wiggle > 0 (radians) adds a
    # correlated per-residue rotation about CA
    frames = []
    offset = np.zeros((n_res, 1, 3))
    rotvec = np.zeros((n_res, 3))
    for _ in range(frame_time):
        offset = 0.9 * offset + wiggle * rng.normal(size=(n_res, 1, 3))
        atoms = atom37_one
        if rot_wiggle > 0:
            rotvec = 0.9 * rotvec + rot_wiggle * rng.normal(size=(n_res, 3))
            R = _rotvec_to_mat(rotvec)
            local = atom37_one - atom37_one[:, 1:2]
            atoms = np.einsum("nij,naj->nai", R, local) + atom37_one[:, 1:2]
        frames.append((atoms + offset) * mask37[..., None])
    atom37 = np.stack(frames)

    return {
        "atom37": atom37.astype(np.float32),
        "atom37_mask": mask37.astype(np.float32),
        "aatype": aatype,
        "residue_index": np.arange(n_res, dtype=np.int32),
        "force": rng.normal(size=(frame_time, n_res, 3)).astype(np.float32),
        "vel": rng.normal(size=(frame_time, n_res, 3)).astype(np.float32),
        "node_repr": rng.normal(size=(n_res, node_dim)).astype(np.float32),
        "edge_repr": rng.normal(size=(n_res, n_res, edge_dim)).astype(np.float32),
    }
