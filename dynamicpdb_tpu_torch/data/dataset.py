"""Host-side window handling.

Port of ``pad_window`` from ``dynamicpdb_tpu/data/dataset.py`` (numpy only).
The rest of that module (CSV manifest, samplers, batching) belongs to the
training slice.
"""
from __future__ import annotations

import numpy as np


def pad_window(raw: dict, pad_to: int) -> dict:
    """Zero-pad the residue axis to pad_to (masks keep semantics)."""
    n = raw["aatype"].shape[0]
    if n == pad_to:
        return raw
    if n > pad_to:
        raise ValueError(
            f"window has {n} residues > pad_to={pad_to}; raise pad_to or "
            f"filter by seq_len (data.filtering.max_len)"
        )
    p = pad_to - n

    def pad(x, axes):
        widths = [(0, 0)] * x.ndim
        for ax in axes:
            widths[ax] = (0, p)
        return np.pad(x, widths)

    out = dict(raw)
    out["atom37"] = pad(raw["atom37"], [1])
    out["atom37_mask"] = pad(raw["atom37_mask"], [0])
    out["aatype"] = pad(raw["aatype"], [0])
    out["residue_index"] = pad(raw["residue_index"], [0])
    out["force"] = pad(raw["force"], [1])
    out["vel"] = pad(raw["vel"], [1])
    out["node_repr"] = pad(raw["node_repr"], [0])
    out["edge_repr"] = pad(raw["edge_repr"], [0, 1])
    return out
