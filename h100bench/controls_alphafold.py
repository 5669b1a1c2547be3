"""The control of the AlphaFold2 cell's ``correct``: the reference put in
the program's place with TF32 matmuls and convolutions, one precision
below the configuration's float32, read against the float32 reference by
the cell's own comparison (``steps_alphafold.recycle_gaps``: the reprs',
the pseudo-beta positions' and the last pLDDT's gaps). Each reading has
to fail its limit; the benchmark's runs never run this.

    python3 h100bench/controls_alphafold.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with the numbers the cell compares, beside
its limits (``controls.py``'s manner, for the AlphaFold2 driver).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def extract_af2_control(traffic, seed, device, cfg=None) -> dict:
    """The TF32 reference's recycles, each held to the float32 reference's
    pass from the same recycled inputs, as the cell holds the program's."""
    import torch

    from h100bench import inputs_alphafold
    from h100bench.reference import steps_alphafold as steps

    model = steps.alphafold_model(seed, device, cfg)
    lines = inputs_alphafold.alignments(traffic, seed)[0]
    got = []
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        steps.alphafold_sequence(model, "s0", lines, on_recycle=lambda i, o: (
            got.append(steps.host_outputs(o))))
    finally:
        steps.float32_exact()
    return steps.recycle_gaps(got, steps.recycles_on(model, "s0", lines, got))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]
    from h100bench import run

    bench = run.load_json(ROOT, "BENCHMARK.json")
    _, _, traffic, _, _ = run.cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the controls run on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        readings = extract_af2_control(traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings,
                          "limits": traffic["limits"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
