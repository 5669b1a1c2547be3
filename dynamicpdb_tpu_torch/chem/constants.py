"""Residue-chemistry constants for backbone and side-chain geometry.

Port of ``dynamicpdb_tpu/chem/constants.py``. The numeric tables live in this
package's own copy of ``tables.npz`` (byte-identical to the JAX package's,
which ``tools/gen_chem_tables.py`` generates from the public AlphaFold2
residue constants) and are exposed as numpy arrays.
"""
from __future__ import annotations

import functools
import os

import numpy as np

RESTYPES = list("ARNDCQEGHILKMFPSTWYV")
RESTYPE_ORDER = {r: i for i, r in enumerate(RESTYPES)}
RESTYPES_WITH_X = RESTYPES + ["X"]
UNK_RESTYPE = 20

ATOM37_NAMES = [
    "N", "CA", "C", "CB", "O", "CG", "CG1", "CG2", "OG", "OG1", "SG", "CD",
    "CD1", "CD2", "ND1", "ND2", "OD1", "OD2", "SD", "CE", "CE1", "CE2", "CE3",
    "NE", "NE1", "NE2", "OE1", "OE2", "CH2", "NH1", "NH2", "OH", "CZ", "CZ2",
    "CZ3", "NZ", "OXT",
]
ATOM_ORDER = {name: i for i, name in enumerate(ATOM37_NAMES)}
CA_IDX = ATOM_ORDER["CA"]

TABLES_PATH = os.path.join(os.path.dirname(__file__), "tables.npz")


@functools.lru_cache(maxsize=None)
def _tables() -> dict:
    with np.load(TABLES_PATH) as z:
        return {k: z[k] for k in z.files}


def __getattr__(name: str):
    # every npz table is a module-level constant (upper-case alias too)
    t = _tables()
    if name in t:
        return t[name]
    low = name.lower()
    if low in t:
        return t[low]
    raise AttributeError(name)


def aatype_from_sequence(seq: str) -> np.ndarray:
    """One-letter amino-acid string -> int aatype array (X/unknown -> 20)."""
    return np.array(
        [RESTYPE_ORDER.get(c, UNK_RESTYPE) for c in seq], dtype=np.int32
    )
