"""Each cell's inputs from its configuration, traffic file and seed, the
same for the program, the reference and the controls."""
from __future__ import annotations

from h100bench import traffic as gen


def sequences(traffic: dict, seed: int) -> list[str]:
    return [gen.sequence(traffic["length"], gen.sub_seed(seed, 1, i))
            for i in range(traffic["distinct"])]
