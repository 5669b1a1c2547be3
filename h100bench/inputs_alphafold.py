"""The AlphaFold2 cell's inputs from its traffic file and ``--seed``: the
distinct query sequences (``inputs.sequences``' draws) and an a3m
alignment of each, the same for the program, the reference and the
control.

Each alignment holds the query and ``msa_rows`` - 1 rows drawn from it:
a row keeps each query residue with its own probability (uniform over
``identity``), and elsewhere holds a gap (``gap_share``) or a uniformly
drawn residue type; after ``insertion_share`` of its positions comes an
insertion of 1-3 lowercase residues.
"""
from __future__ import annotations

import numpy as np

from h100bench import inputs, traffic as gen

_LETTERS = np.frombuffer(gen.AMINO_ACIDS.encode(), np.uint8)


def alignment(query: str, traffic: dict, seed: int) -> list[str]:
    """The a3m lines of ``query``'s alignment."""
    rng = np.random.default_rng(seed)
    n, L = traffic["msa_rows"] - 1, len(query)
    q = np.frombuffer(query.encode(), np.uint8)
    lo, hi = traffic["identity"]
    identity = rng.uniform(lo, hi, n)
    keep = rng.random((n, L)) < identity[:, None]
    gap = rng.random((n, L)) < traffic["gap_share"]
    other = _LETTERS[rng.integers(0, len(_LETTERS), (n, L))]
    cells = np.zeros((n, L, 4), np.uint8)  # a column and its insertion
    cells[..., 0] = np.where(keep, q, np.where(gap, ord("-"), other))
    ins = rng.random((n, L)) < traffic["insertion_share"]
    a, b = traffic["insertion_length"]
    length = rng.integers(a, b + 1, (n, L))
    letters = _LETTERS[rng.integers(0, len(_LETTERS), (n, L, 3))] + 32
    for k in range(3):
        cells[..., 1 + k] = np.where(ins & (length > k), letters[..., k], 0)
    flat = cells.reshape(n, 4 * L)
    lines = [">query", query]
    for i, row in enumerate(flat):
        lines += [f">row{i}", row[row != 0].tobytes().decode("ascii")]
    return lines


def alignments(traffic: dict, seed: int) -> list[list[str]]:
    return [alignment(q, traffic, gen.sub_seed(seed, 5, i))
            for i, q in enumerate(inputs.sequences(traffic, seed))]
