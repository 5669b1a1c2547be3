"""The one traffic generator: every cell's inputs, from its traffic file
and ``--seed``.

A traffic file fixes the mix: the lengths, how many distinct inputs, the
request shape. The seed fixes the content and the order, never the mix.
"""
from __future__ import annotations

import numpy as np

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def sub_seed(seed: int, *path: int) -> int:
    """A seed for one part of a run (a sequence, a sample), from the run's
    seed: any whole number, negative or past 64 bits included."""
    return int(np.random.SeedSequence([abs(int(seed)), int(seed < 0), *path])
               .generate_state(1, np.uint64)[0] >> 1)


def sequence(length: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, length))
