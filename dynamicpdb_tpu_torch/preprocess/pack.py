"""Trajectory packing: raw MD artifacts -> training bundle npz (numpy only).

Port of ``dynamicpdb_tpu/preprocess/pack.py``: topology from one PDB (the
port's ``analysis/pdb_io.read_pdb``) and coordinates from any [F, A, 3]
array (the release's pickles and DCDs, OpenMM reporters) become the
single-bundle npz ``data/dataset.py`` trains on (``pack_trajectory``,
``pack_from_dynamicpdb_release``), or the reference's multi-file layout
(``pack_reference_layout``); forces and velocities are reduced to their
C-alpha rows.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from dynamicpdb_tpu_torch.analysis.pdb_io import read_pdb
from dynamicpdb_tpu_torch.chem import constants as chem


def atom37_from_full_atoms(
    full_xyz: np.ndarray,  # [F, A, 3] simulation atom order
    atom_names: list[str],  # [A] PDB atom names
    atom_resseq: np.ndarray,  # [A] residue number per atom
) -> tuple[np.ndarray, np.ndarray]:
    """Scatter full-atom MD coordinates into atom37 layout. Returns
    (atom37 [F, N, 37, 3], used_mask [N, 37])."""
    resseqs = sorted(set(int(r) for r in atom_resseq))
    res_index = {r: i for i, r in enumerate(resseqs)}
    F, A, _ = full_xyz.shape
    N = len(resseqs)
    atom37 = np.zeros((F, N, 37, 3), np.float32)
    mask = np.zeros((N, 37), np.float32)
    for a in range(A):
        name = atom_names[a]
        if name not in chem.ATOM_ORDER:
            continue
        i = res_index[int(atom_resseq[a])]
        j = chem.ATOM_ORDER[name]
        atom37[:, i, j] = full_xyz[:, a]
        mask[i, j] = 1.0
    return atom37, mask


def select_ca_rows(values: np.ndarray, atom_names: list[str]) -> np.ndarray:
    """[F, A, ...] per-atom values -> [F, N, ...] C-alpha rows
    (atom_select.py:40-56)."""
    ca_idx = [a for a, n in enumerate(atom_names) if n == "CA"]
    return np.asarray(values)[:, ca_idx]


def pack_trajectory(
    out_path: str,
    topology_pdb: str,
    positions: np.ndarray,  # [F, A, 3] full-atom coords (Angstroms)
    atom_names: list[str],
    atom_resseq: np.ndarray,
    *,
    forces: np.ndarray | None = None,  # [F, A, 3] per-atom
    velocities: np.ndarray | None = None,
    node_repr: np.ndarray | None = None,
    edge_repr: np.ndarray | None = None,
) -> str:
    """Write a single-bundle training npz (the layout data/dataset.py reads).

    topology_pdb provides aatype/residue_index; positions provide frames.
    forces/velocities are reduced to C-alpha rows like the reference's
    atom_select step. Missing embeddings default to zeros (train with
    embeddings disabled or attach real OmegaFold npz later).
    """
    _, pdb_mask, aatype, residue_index = read_pdb(topology_pdb)
    atom37, mask = atom37_from_full_atoms(positions, atom_names, atom_resseq)
    n = atom37.shape[1]
    if n != len(aatype):
        raise ValueError(
            f"topology has {len(aatype)} residues, trajectory {n}"
        )
    F = atom37.shape[0]
    ca_force = (
        select_ca_rows(forces, atom_names)
        if forces is not None
        else np.zeros((F, n, 3), np.float32)
    )
    ca_vel = (
        select_ca_rows(velocities, atom_names)
        if velocities is not None
        else np.zeros((F, n, 3), np.float32)
    )
    node = (
        node_repr if node_repr is not None else np.zeros((n, 256), np.float32)
    )
    edge = (
        edge_repr if edge_repr is not None else np.zeros((n, n, 128), np.float32)
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(
        out_path,
        all_atom_positions=atom37.astype(np.float32),
        all_atom_mask=mask,
        aatype=np.eye(21, dtype=np.float32)[aatype],
        residue_index=residue_index.astype(np.int32),
        force=ca_force.astype(np.float32),
        vel=ca_vel.astype(np.float32),
        node_repr=np.asarray(node, np.float32),
        edge_repr=np.asarray(edge, np.float32),
    )
    return out_path


def pack_reference_layout(
    out_dir: str,
    pid: str,
    topology_pdb: str,
    positions: np.ndarray,
    atom_names: list[str],
    atom_resseq: np.ndarray,
    forces: np.ndarray | None = None,
    velocities: np.ndarray | None = None,
):
    """Write the reference's multi-file layout instead: {pid}_new_w_pp.npz +
    {pid}_F_Ca.pkl + {pid}_V_ca.pkl (README.md:184-203) so artifacts stay
    interchangeable with the torch reference."""
    os.makedirs(out_dir, exist_ok=True)
    _, _, aatype, residue_index = read_pdb(topology_pdb)
    atom37, mask = atom37_from_full_atoms(positions, atom_names, atom_resseq)
    npz = os.path.join(out_dir, f"{pid}_new_w_pp.npz")
    np.savez_compressed(
        npz,
        all_atom_positions=atom37.astype(np.float32),
        all_atom_mask=mask,
        aatype=np.eye(21, dtype=np.float32)[aatype],
        residue_index=residue_index.astype(np.int32),
    )
    paths = {"atlas_npz": npz}
    if forces is not None:
        p = os.path.join(out_dir, f"{pid}_F.pkl")
        with open(p.replace(".pkl", "_Ca.pkl"), "wb") as f:
            pickle.dump(select_ca_rows(forces, atom_names), f)
        paths["force_path"] = p
    if velocities is not None:
        p = os.path.join(out_dir, f"{pid}_V.pkl")
        with open(p.replace(".pkl", "_ca.pkl"), "wb") as f:
            pickle.dump(select_ca_rows(velocities, atom_names), f)
        paths["vel_path"] = p
    return paths


def load_segmented_pkl(pid_dir: str, pid: str, kind: str) -> np.ndarray | None:
    """Concatenate the release's tenth-of-trajectory segment pickles.

    The download layout provides {pid}_{kind}/{pid}_{kind}_{i}.pkl for
    kind in T/F/V, "sequentially named from 0 to 9 in chronological
    order" (reference README.md:120-140), alongside the combined
    {pid}_{kind}.pkl. Returns the [F, A, 3] concatenation in numeric
    segment order, or None if the segment directory is absent."""
    import re

    seg_dir = os.path.join(pid_dir, f"{pid}_{kind}")
    if not os.path.isdir(seg_dir):
        return None
    pat = re.compile(re.escape(f"{pid}_{kind}") + r"_(\d+)\.pkl$")
    found = sorted(
        (int(m.group(1)), name)
        for name in os.listdir(seg_dir)
        if (m := pat.fullmatch(name))
    )
    if not found:
        return None
    parts = []
    for _, name in found:
        with open(os.path.join(seg_dir, name), "rb") as f:
            parts.append(np.asarray(pickle.load(f)))
    return np.concatenate(parts, axis=0)


def pack_from_dynamicpdb_release(
    out_path: str,
    pid_dir: str,
    pid: str,
    *,
    node_repr=None,
    edge_repr=None,
    max_frames: int | None = None,
    unwrap: bool = False,
):
    """Pack a protein straight from the dynamicPDB release layout
    (README.md:36-140): {pid}_T.pkl per-frame coordinates, {pid}_F.pkl
    forces, {pid}_V.pkl velocities (all [F, A, 3] full-atom), plus the
    topology {pid}.pdb. Falls back to the segmented {pid}_T/ {pid}_F/
    {pid}_V/ directories when a combined pickle is absent. With
    ``unwrap=True``, removes periodic-box jumps first, reading the box
    from the release's {pid}_state_npt*.xml (post_process.py:10-76
    semantics, no OpenMM needed). Writes the single-bundle training npz."""

    def _load(name):
        p = os.path.join(pid_dir, f"{pid}{name}")
        if os.path.exists(p):
            with open(p, "rb") as f:
                arr = np.asarray(pickle.load(f))
        else:
            arr = load_segmented_pkl(pid_dir, pid, name[1:-4])
            if arr is None:
                return None
        return arr[:max_frames] if max_frames else arr

    positions = _load("_T.pkl")
    if positions is None:
        # minimal downloads may carry only the DCD form of the trajectory
        from dynamicpdb_tpu_torch.preprocess.dcd import (
            read_dcd,
            read_dcd_segments,
        )

        dcd_path = os.path.join(pid_dir, f"{pid}_T.dcd")
        seg_dir = os.path.join(pid_dir, f"{pid}_dcd")
        if os.path.exists(dcd_path):
            positions = read_dcd(dcd_path)["xyz"]
        elif os.path.isdir(seg_dir):
            positions = read_dcd_segments(seg_dir, f"{pid}_dcd")["xyz"]
        if positions is not None and max_frames:
            positions = positions[:max_frames]
    if positions is None:
        raise FileNotFoundError(
            f"no {pid}_T.pkl / {pid}_T/ segments / {pid}_T.dcd / "
            f"{pid}_dcd/ trajectory in {pid_dir}"
        )
    if unwrap:
        from dynamicpdb_tpu_torch.preprocess import pbc

        box = pbc.box_from_release_dir(pid_dir, pid)
        positions = pbc.unwrap_trajectory(positions, box)

    forces = _load("_F.pkl")
    velocities = _load("_V.pkl")

    topo = os.path.join(pid_dir, f"{pid}.pdb")
    # atom names/resseq from the topology PDB ATOM records, in file order
    names, resseq = [], []
    with open(topo) as f:
        for line in f:
            if line.startswith("ENDMDL"):
                break
            if line.startswith("ATOM"):
                names.append(line[12:16].strip())
                resseq.append(int(line[22:26]))
    if positions.shape[1] != len(names):
        raise ValueError(
            f"{pid}: trajectory has {positions.shape[1]} atoms, topology "
            f"{len(names)} — protein-only coordinates are expected "
            "(strip solvent first)"
        )
    return pack_trajectory(
        out_path, topo, positions, names, np.asarray(resseq),
        forces=forces, velocities=velocities,
        node_repr=node_repr, edge_repr=edge_repr,
    )
