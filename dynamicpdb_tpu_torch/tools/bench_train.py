"""Time the training loop end to end on the card, data path included.

    python3 dynamicpdb_tpu_torch/tools/bench_train.py [--package DIR] \
        [--steps 6] [--profile]

Writes synthetic trajectory bundles (``data/synthetic.make_trajectory_npz``,
8 frames, one per entry of ``LENGTHS``) and runs ``Experiment.train`` as
``train_cli`` wires it (``TrajectoryDataset`` padded to ``max_len``,
``make_sampler``, ``batch_iterator``) on ``configs/release.yaml`` (B = 8,
remat, bfloat16) for ``--steps`` steps. Prints one JSON line per step: its
seconds in ``train_step``, its wait for the batch (``data_seconds``) and
their sum; then a summary over the steps after the first, and the peak
device memory.

``--package DIR`` imports the ``dynamicpdb_tpu_torch`` package under DIR
instead of this checkout's, so that two versions can be timed on one card
in one call (parent, change, change, parent); run this file as a script.

``--profile`` runs the first step unprofiled, then the rest under
``torch.profiler`` and adds the device time of the host-to-device copies
by kind and stream, the device time of everything else, and the wall time
of the profiled steps.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Four bundles make four batches an epoch at B = 8, so of the default six
# steps, steps 2-4 read mid-epoch and step 5 starts the next epoch.
LENGTHS = (256, 200, 256, 200)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def copy_summary(prof) -> dict:
    """{'<copy kind> stream <id>': [ms, count]} of the host-to-device
    copies, and 'other device ms': every other device event's time."""
    out, other = {}, 0.0
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        ms = e.device_time_total / 1e3 if hasattr(e, "device_time_total") \
            else e.cuda_time_total / 1e3
        if "HtoD" in e.name:
            key = f"{e.name} stream {getattr(e, 'device_resource_id', '?')}"
            ms_sum, n = out.get(key, (0.0, 0))
            out[key] = (ms_sum + ms, n + 1)
        else:
            other += ms
    return {"copies": {k: [round(v[0], 3), v[1]] for k, v in out.items()},
            "other_device_ms": round(other, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--package", default=ROOT)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.package))
    import torch

    from dynamicpdb_tpu_torch.config import load_yaml
    from dynamicpdb_tpu_torch.data.dataset import (
        TrajectoryDataset,
        batch_iterator,
        make_sampler,
    )
    from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz
    from dynamicpdb_tpu_torch.train.experiment import Experiment
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    if not torch.cuda.is_available():
        print("bench_train: torch sees no CUDA device", file=sys.stderr)
        return 1
    os.chdir(ROOT)  # configs/release.yaml names the IGSO3 cache relatively
    card = card_line()
    label = os.path.relpath(os.path.abspath(args.package), ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        rows = []
        for i, n in enumerate(LENGTHS):
            path = make_trajectory_npz(os.path.join(tmp, f"p{i}.npz"),
                                       n_res=n, n_frames=8, seed=i)
            rows.append(f"p{i},{path},{n}")
        csv = os.path.join(tmp, "train.csv")
        with open(csv, "w") as f:
            f.write("name,atlas_npz,seq_len\n" + "\n".join(rows) + "\n")
        cfg = load_yaml(os.path.join(ROOT, "configs", "release.yaml"),
                        [f"data.csv_path={csv}"])
        device = resolve_device("cuda")
        dataset = TrajectoryDataset(cfg.data, split="train",
                                    pad_to=cfg.data.filtering.max_len)
        sampler = make_sampler(dataset, cfg.data,
                               batch_size=cfg.experiment.batch_size,
                               seed=cfg.experiment.seed)
        exp = Experiment(cfg, lambda e: batch_iterator(dataset, sampler, e),
                         device=device)
        torch.cuda.reset_peak_memory_stats()
        prof_out = {}
        if args.profile:
            exp.train(max_steps=1)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=acts) as prof:
                exp.train(max_steps=args.steps)
                torch.cuda.synchronize()
            prof_out = dict(copy_summary(prof),
                            profiled_wall_s=time.perf_counter() - t0,
                            profiled_steps=args.steps - 1)
        else:
            exp.train(max_steps=args.steps)
        peak = torch.cuda.max_memory_allocated()
    for m in exp.step_metrics:
        print(json.dumps({"package": label, "step": m["step"],
                          "seconds": m["seconds"],
                          "data_seconds": m["data_seconds"],
                          "total": m["seconds"] + m["data_seconds"]}))
    steady = exp.step_metrics[1:]
    mean = (lambda k: sum(m[k] for m in steady) / len(steady)) if steady \
        else (lambda k: float("nan"))
    print(json.dumps({
        "package": label, "card": card, "steps": len(exp.step_metrics),
        "batch": cfg.experiment.batch_size, "lengths": list(LENGTHS),
        "steady_mean_seconds": mean("seconds"),
        "steady_mean_data_seconds": mean("data_seconds"),
        "steady_mean_total": mean("seconds") + mean("data_seconds"),
        "peak_gib": peak / 2**30, **prof_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
