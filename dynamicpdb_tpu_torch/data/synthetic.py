"""Synthetic protein windows for requests and test fixtures.

Port of ``make_window`` and ``make_trajectory_npz`` from
``dynamicpdb_tpu/data/synthetic.py`` (numpy only): an idealised
alpha-helix backbone that wiggles smoothly over time, random
force/velocity channels and fake OmegaFold embeddings, in the raw window
layout of ``data/featurize.py``. The same seed gives the same arrays
as the JAX package's function.

``write_release_protein`` (the port's own) writes one protein of the
dynamicPDB release layout from such a trajectory, for the ingestion path
(``tools/ingest_release.py``) to read.
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


def make_trajectory_npz(path, n_res=32, n_frames=64, seed=0, rot_wiggle=0.0):
    """Write a synthetic trajectory bundle in the on-disk dataset layout
    (see data/dataset.py): one npz with positions, per-frame force/vel and
    embeddings; with ``rot_wiggle=0`` the same arrays as the JAX package's
    function, whose residues only translate from frame to frame
    (``make_window`` says what ``rot_wiggle`` adds)."""
    w = make_window(n_res=n_res, frame_time=n_frames, seed=seed,
                    rot_wiggle=rot_wiggle)
    np.savez_compressed(
        path,
        all_atom_positions=w["atom37"],
        all_atom_mask=w["atom37_mask"],
        aatype=np.eye(21, dtype=np.float32)[w["aatype"]],
        residue_index=w["residue_index"],
        force=w["force"],
        vel=w["vel"],
        node_repr=w["node_repr"],
        edge_repr=w["edge_repr"],
    )
    return path


STATEDATA_HEADER = ('#"Step","Potential Energy (kJ/mole)",'
                    '"Kinetic Energy (kJ/mole)","Total Energy (kJ/mole)",'
                    '"Temperature (K)","Box Volume (nm^3)","Density (g/mL)"')


def write_release_protein(root: str, pid: str, *, n_res: int, n_frames: int,
                          seed: int = 0, box: float = 60.0,
                          n_segments: int = 4) -> dict:
    """One protein in the dynamicPDB release layout under ``root``:
    ``{pid}_npt100000.0_ts0.001/`` holding ``{pid}.pdb`` (the first frame's
    atoms), the full-atom coordinates, forces and velocities as segment
    pickles ``{pid}_{T,F,V}/{pid}_{T,F,V}_{i}.pkl`` (the coordinates
    wrapped by one box length along x from the middle frame on), a
    gzip-compressed OpenMM State XML with a cubic box of ``box`` A, and an
    ``{pid}_npt_sim.dat`` StateDataReporter table of one row a frame.
    Returns the directory, the unwrapped [F, N, 37, 3] frames, the atom
    mask, aatype and the atom count."""
    import gzip
    import os
    import pickle

    from dynamicpdb_tpu_torch.analysis.pdb_io import write_pdb

    rng = np.random.default_rng(seed + 1)
    w = make_window(n_res=n_res, frame_time=n_frames, node_dim=1, edge_dim=1,
                    seed=seed)
    d = os.path.join(root, f"{pid}_npt100000.0_ts0.001")
    os.makedirs(d, exist_ok=True)
    write_pdb(os.path.join(d, f"{pid}.pdb"), w["atom37"][0], w["aatype"],
              w["atom37_mask"])
    res, atom = np.nonzero(w["atom37_mask"] > 0.5)  # the PDB's atom order
    traj = w["atom37"][:, res, atom].astype(np.float32)  # [F, A, 3]
    wrapped = traj.copy()
    wrapped[n_frames // 2:, :, 0] += box
    arrays = {"T": wrapped,
              "F": rng.normal(size=traj.shape).astype(np.float32),
              "V": rng.normal(size=traj.shape).astype(np.float32)}
    bounds = np.linspace(0, n_frames, n_segments + 1).astype(int)
    for kind, arr in arrays.items():
        seg_dir = os.path.join(d, f"{pid}_{kind}")
        os.makedirs(seg_dir, exist_ok=True)
        for i in range(n_segments):
            with open(os.path.join(seg_dir, f"{pid}_{kind}_{i}.pkl"),
                      "wb") as f:
                pickle.dump(arr[bounds[i]:bounds[i + 1]], f)
    nm = box / 10.0
    xml = ('<?xml version="1.0" ?>\n<State>\n<PeriodicBoxVectors>\n'
           f' <A x="{nm}" y="0" z="0"/>\n <B x="0" y="{nm}" z="0"/>\n'
           f' <C x="0" y="0" z="{nm}"/>\n</PeriodicBoxVectors>\n</State>\n')
    with open(os.path.join(d, f"{pid}_state_npt100000.0.xml.gz"), "wb") as f:
        f.write(gzip.compress(xml.encode()))
    pot = -5e4 + 100 * rng.normal(size=n_frames)
    kin = 1.2e4 + 50 * rng.normal(size=n_frames)
    temp = 300 + rng.normal(size=n_frames)
    vol = nm ** 3 * (1 + 1e-3 * rng.normal(size=n_frames))
    rows = [f"{(i + 1) * 1000},{pot[i]:.4f},{kin[i]:.4f},"
            f"{pot[i] + kin[i]:.4f},{temp[i]:.4f},{vol[i]:.4f},1.0120"
            for i in range(n_frames)]
    with open(os.path.join(d, f"{pid}_npt_sim.dat"), "w") as f:
        f.write(STATEDATA_HEADER + "\n" + "\n".join(rows) + "\n")
    return dict(dir=d, atom37=w["atom37"], mask=w["atom37_mask"],
                aatype=w["aatype"], n_atoms=int(traj.shape[1]))
