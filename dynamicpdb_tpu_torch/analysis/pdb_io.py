"""PDB read and write for atom37 structures (numpy only).

Port of ``dynamicpdb_tpu/analysis/pdb_io.py``, byte for byte in what it
writes: ``write_pdb`` for the eval artifacts (one MODEL per frame) and the
extension's topology file, ``read_pdb`` for the first model's ATOM records.
"""
from __future__ import annotations

import numpy as np

from dynamicpdb_tpu_torch.chem import constants as chem


def write_pdb(
    path: str,
    atom37: np.ndarray,  # [N, 37, 3] or [F, N, 37, 3] (models)
    aatype: np.ndarray,  # [N]
    atom37_mask: np.ndarray | None = None,  # [N, 37]
    b_factors: np.ndarray | None = None,
):
    atom37 = np.asarray(atom37)
    if atom37.ndim == 3:
        atom37 = atom37[None]
    n_res = atom37.shape[1]
    if atom37_mask is None:
        atom37_mask = np.asarray(chem.restype_atom37_mask)[aatype]
    if b_factors is None:
        b_factors = np.zeros((n_res, 37))

    lines = []
    for m, frame in enumerate(atom37):
        if atom37.shape[0] > 1:
            lines.append(f"MODEL     {m + 1:4d}")
        serial = 1
        for i in range(n_res):
            res3 = chem.RESTYPE_1TO3.get(
                chem.RESTYPES_WITH_X[int(aatype[i])], "UNK"
            )
            for a in range(37):
                if atom37_mask[i, a] < 0.5:
                    continue
                name = chem.ATOM37_NAMES[a]
                x, y, z = frame[i, a]
                pad_name = f" {name:<3s}" if len(name) < 4 else name
                lines.append(
                    f"ATOM  {serial:5d} {pad_name:<4s}{res3:>4s} A{i + 1:4d}"
                    f"    {x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}"
                    f"{b_factors[i, a]:6.2f}          {name[0]:>2s}"
                )
                serial += 1
        lines.append("TER")
        if atom37.shape[0] > 1:
            lines.append("ENDMDL")
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_pdb(path: str):
    """Parse first model's ATOM records -> (atom37 [N,37,3], mask [N,37],
    aatype [N], residue_index [N])."""
    coords: dict[tuple, np.ndarray] = {}
    restypes: dict[tuple, int] = {}
    order: list[tuple] = []
    with open(path) as f:
        for line in f:
            if line.startswith("ENDMDL"):
                break
            is_atom = line.startswith("ATOM")
            # selenomethionine is deposited as HETATM MSE but is a standard
            # chain residue; treat as MET (same policy as mmcif.py)
            is_mse = line.startswith("HETATM") and line[17:20] == "MSE"
            if not (is_atom or is_mse):
                continue
            name = line[12:16].strip()
            res3 = "MET" if is_mse else line[17:20].strip()
            if is_mse and name == "SE":
                name = "SD"
            chain = line[21]
            resseq = int(line[22:26])
            icode = line[26] if len(line) > 26 else " "
            # key on (chain, resseq, insertion code): 100/100A/100B are
            # distinct residues (same hazard mmcif.py:216 documents)
            key = (chain, resseq, icode)
            if key not in restypes:
                restypes[key] = chem.RESTYPE_ORDER.get(
                    chem.RESTYPE_3TO1.get(res3, "X"), chem.UNK_RESTYPE
                )
                order.append(key)
            if name in chem.ATOM_ORDER and (key, name) not in coords:
                # first altLoc wins: the not-in-coords guard keeps the
                # first conformer seen for each atom, whatever its label —
                # an explicit ' '/'A' whitelist would silently DROP atoms
                # whose only deposited conformer is 'B' (review finding)
                xyz = np.array(
                    [float(line[30:38]), float(line[38:46]), float(line[46:54])]
                )
                coords[(key, name)] = xyz

    n = len(order)
    atom37 = np.zeros((n, 37, 3), np.float32)
    mask = np.zeros((n, 37), np.float32)
    aatype = np.zeros(n, np.int32)
    residue_index = np.zeros(n, np.int32)
    for i, key in enumerate(order):
        aatype[i] = restypes[key]
        residue_index[i] = key[1]  # insertion-coded residues share resseq
        for a, name in enumerate(chem.ATOM37_NAMES):
            if (key, name) in coords:
                atom37[i, a] = coords[(key, name)]
                mask[i, a] = 1.0
    return atom37, mask, aatype, residue_index
