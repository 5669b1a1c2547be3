"""Periodic-boundary-condition unwrapping for MD trajectories (numpy only).

Port of ``dynamicpdb_tpu/preprocess/pbc.py``. MD engines wrap coordinates
into the periodic box, so a molecule drifting across a face appears to
teleport by one box length. Detection: a jump in the mean displacement
between consecutive frames larger than half the box along an axis;
correction: shift that frame and all later ones back by one box length
(``unwrap_trajectory``; ``unwrap_per_atom`` tracks each atom on its own).

The box comes from the run's OpenMM State XML, which the dynamicPDB release
ships as ``{pid}_state_npt*.xml`` and which carries the PeriodicBoxVectors
without OpenMM: ``box_from_state_xml`` parses it (plain, gzip- or
zlib-compressed, a triclinic box refused), and ``box_from_release_dir``
finds it in the release layout. An explicit box size is the fallback.
"""
from __future__ import annotations

import os

import numpy as np


def unwrap_trajectory(positions: np.ndarray, box_size) -> np.ndarray:
    """Remove box-crossing jumps.

    Args:
        positions: [F, A, 3] wrapped coordinates (Angstroms).
        box_size: scalar or [3] box edge lengths (Angstroms).
    Returns:
        [F, A, 3] unwrapped coordinates (frame 0 unchanged).
    """
    positions = np.asarray(positions, np.float64)
    box = np.broadcast_to(np.asarray(box_size, np.float64), (3,))
    out = positions.copy()
    shift = np.zeros(3)
    for f in range(1, len(positions)):
        delta = (positions[f] - positions[f - 1]).mean(axis=0)
        jump = np.where(np.abs(delta) > box / 2, -np.sign(delta) * box, 0.0)
        shift = shift + jump
        out[f] = positions[f] + shift
    return out


def unwrap_per_atom(positions: np.ndarray, box_size) -> np.ndarray:
    """Stricter per-atom unwrapping (each atom tracked independently) for
    systems where sub-chains cross faces at different times."""
    positions = np.asarray(positions, np.float64)
    box = np.broadcast_to(np.asarray(box_size, np.float64), (3,))
    deltas = np.diff(positions, axis=0)
    jumps = np.where(np.abs(deltas) > box / 2, -np.sign(deltas) * box, 0.0)
    shifts = np.concatenate(
        [np.zeros_like(positions[:1]), np.cumsum(jumps, axis=0)], axis=0
    )
    return positions + shifts


def _read_maybe_compressed(path: str) -> str:
    """Raw text of `path`, transparently decompressing gzip (1f 8b magic) or
    bare zlib (0x78 header) — MD pipelines often compress the per-run State
    XML."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == b"\x1f\x8b":
        import gzip

        blob = gzip.decompress(blob)
    elif blob[:1] == b"\x78":
        import zlib

        blob = zlib.decompress(blob)
    return blob.decode("utf-8", errors="replace")


def box_vectors_from_state_xml(xml_path: str) -> np.ndarray:
    """Full [3,3] periodic box vectors (A) from an OpenMM State XML file
    (written with ``simulation.saveState``; the dynamicPDB release ships one
    per run as `{pid}_state_npt*.xml`, README.md:65). Accepts plain, gzipped,
    or zlib-compressed files. Binary OpenMM checkpoints (.chk) need the
    original System object even under OpenMM itself (the reference rebuilds
    the forcefield to load one, post_process.py:10-49) — use the State XML
    or pass box_size directly."""
    import re

    text = _read_maybe_compressed(xml_path)
    # OpenMM's XmlSerializer writes the box as capital <A .../><B .../><C .../>
    # children of <PeriodicBoxVectors>; accept either case and any attribute
    # spacing
    vecs = re.findall(
        r'<[ABC]\s+x="([^"]+)"\s+y="([^"]+)"\s+z="([^"]+)"',
        text,
        flags=re.IGNORECASE,
    )
    if len(vecs) != 3:
        raise ValueError(f"no periodic box vectors found in {xml_path}")
    return np.array([[float(c) for c in v] for v in vecs]) * 10.0  # nm -> A


def box_from_state_xml(xml_path: str) -> np.ndarray:
    """Box edge lengths (A) from an OpenMM State XML. The unwrap routines
    assume a rectangular box (so does the reference's jump detector,
    post_process.py:51-76); a significantly triclinic box is rejected."""
    vecs = box_vectors_from_state_xml(xml_path)
    diag = np.diag(vecs)
    off = np.abs(vecs - np.diag(diag)).max()
    if off > 1e-3 * np.abs(diag).max():
        raise ValueError(
            f"triclinic box in {xml_path} (off-diagonal up to {off:.3g} A); "
            f"rectangular-box unwrapping does not apply"
        )
    return diag.copy()


def box_from_release_dir(release_dir: str, protein_id: str) -> np.ndarray:
    """Box edge lengths (A) from a dynamicPDB release directory: finds the
    protein's `{pid}_state_npt*.xml` (README.md:133 layout) and parses its
    PeriodicBoxVectors — the no-OpenMM equivalent of the reference's
    get_ckpt_boxsize (post_process.py:10-49)."""
    import glob

    pattern = os.path.join(
        release_dir, protein_id, f"{protein_id}_state_npt*.xml*"
    )
    hits = sorted(glob.glob(pattern)) or sorted(
        glob.glob(os.path.join(release_dir, f"{protein_id}_state_npt*.xml*"))
    )
    if not hits:
        raise FileNotFoundError(
            f"no {protein_id}_state_npt*.xml under {release_dir}; pass "
            f"box_size explicitly"
        )
    return box_from_state_xml(hits[-1])  # latest prolongation state
