"""The controls of ``correct``: the reference put in the program's place,
in the precision just below the configuration's, read against the
reference by the cell's own comparison. Each reading has to fail its
limit; the benchmark's runs never run this.

    python3 h100bench/controls.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with the numbers the cell compares. The
OmegaFold cell (float32, TF32 off) takes TF32 matmuls and convolutions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def extract_control(config, traffic, seed, device, model_cfg=None) -> dict:
    import torch

    from h100bench import inputs
    from h100bench.reference import steps

    model = steps.omegafold_model(seed, device, model_cfg)
    seq = inputs.sequences(traffic, seed)[0]
    kw = dict(num_cycles=config["num_cycles"],
              num_pseudo_msa=config["num_pseudo_msa"])
    want = steps.omegafold_sequence(model, "s0", seq, **kw)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = steps.omegafold_sequence(model, "s0", seq, **kw)
    finally:
        steps.float32_exact()
    c = got["cycle"]
    return steps.omegafold_gaps(got["node_repr"][c], got["edge_repr"][c],
                                got["confidences"], c, want)


CONTROLS = {"extract": extract_control}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]
    from h100bench import run

    bench = run.load_json(ROOT, "BENCHMARK.json")
    cell, config_entry, traffic, _, _ = run.cell_spec(bench, args.workload)
    config = run.load_json(ROOT, config_entry["file"])
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the controls run on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        readings = CONTROLS[traffic["driver"]](config, traffic, seed, device)
        line["control"] = readings
        print(json.dumps(dict(line, limits=traffic["limits"])), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
