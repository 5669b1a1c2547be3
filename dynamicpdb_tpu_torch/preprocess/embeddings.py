"""Sequence-embedding artifacts: the OmegaFold node/edge representations
that DFOLD reads.

Port of ``dynamicpdb_tpu/preprocess/embeddings.py`` (``validate``,
``zero_embeddings``, ``extract_with_omegafold``): each protein's
``{pid}.npz`` holds node_repr [N, 256] and edge_repr [N, N, 128], made
offline by ``preprocess/extract_embeddings.py`` or by an external
OmegaFold checkout.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np

NODE_DIM = 256
EDGE_DIM = 128


def validate(npz_path: str, n_res: int | None = None) -> dict:
    """Check an embedding npz against the model's input contract."""
    with np.load(npz_path) as z:
        if "node_repr" not in z.files or "edge_repr" not in z.files:
            raise ValueError(
                f"{npz_path}: need node_repr/edge_repr, got {z.files}")
        node, edge = z["node_repr"], z["edge_repr"]
    if node.ndim != 2 or node.shape[1] != NODE_DIM:
        raise ValueError(f"node_repr must be [N, {NODE_DIM}], got {node.shape}")
    if (edge.ndim != 3 or edge.shape[2] != EDGE_DIM
            or edge.shape[0] != edge.shape[1]):
        raise ValueError(
            f"edge_repr must be [N, N, {EDGE_DIM}], got {edge.shape}")
    if edge.shape[0] != node.shape[0]:
        raise ValueError("node/edge residue counts disagree")
    if n_res is not None and node.shape[0] != n_res:
        raise ValueError(f"expected N={n_res}, got {node.shape[0]}")
    if not (np.isfinite(node).all() and np.isfinite(edge).all()):
        raise ValueError(f"{npz_path}: non-finite embedding values")
    return {"n_res": int(node.shape[0])}


def zero_embeddings(n_res: int) -> dict:
    """Placeholder embeddings for ablation / embedding-free training."""
    return {
        "node_repr": np.zeros((n_res, NODE_DIM), np.float32),
        "edge_repr": np.zeros((n_res, n_res, EDGE_DIM), np.float32),
    }


def extract_with_omegafold(
    fasta_path: str,
    out_npz: str,
    *,
    omegafold_repo: str,
    weights_path: str,
    num_cycles: int = 10,
    device: str = "cuda",
) -> str:
    """Run an external OmegaFold checkout's extractor as a subprocess (its
    ``omegafold.__main__.OmegaFoldModel(weights, device).inference(lines,
    num_cycles)`` -> (edge, node) lists of tensors), save the first
    sequence's reprs to ``out_npz`` and validate them against the model's
    contract. Unlike the JAX package's default (cpu), ``device`` defaults
    to the card."""
    script = (
        "import sys, numpy as np, torch;"
        f"sys.path.insert(0, {omegafold_repo!r});"
        "from omegafold.__main__ import OmegaFoldModel;"
        f"m = OmegaFoldModel({weights_path!r}, device={device!r});"
        f"lines = open({fasta_path!r}).read().splitlines();"
        f"edge, node = m.inference(lines, {num_cycles});"
        f"np.savez_compressed({out_npz!r}, node_repr=node[0].cpu().numpy(),"
        " edge_repr=edge[0].cpu().numpy())"
    )
    subprocess.run([sys.executable, "-c", script], check=True)
    validate(out_npz)
    return out_npz
