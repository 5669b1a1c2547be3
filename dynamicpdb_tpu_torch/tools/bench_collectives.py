"""Time the gathers of ``parallel/mesh.py`` on two gloo ranks sharing one
device, as the smoke's split phases run them.

    python dynamicpdb_tpu_torch/tools/bench_collectives.py [--device cuda] \
        [--mb 4 17 34 67] [--reps 5]

Spawns two processes joined with gloo (``tcp://localhost``, a free port),
both on ``--device`` (cuda: cuda:0, shared). For each size (MB a rank
sends), times, after a warm-up call, the median over ``--reps`` calls of
  * ``all_gather``: ``mesh.all_gather`` (gloo: an ``all_to_all_single``
    whose every part is the tensor, through pinned host memory for a CUDA
    tensor);
  * ``gloo_all_gather``: gloo's own ``all_gather`` as the mesh staged it
    before (``.cpu()``, a list of outputs, ``torch.stack``, back to the
    device);
  * ``all_to_all``: ``mesh.all_to_all`` of a tensor of that size.
Each rank checks the gathers against each other (equal bit for bit). Rank
0 prints one JSON line per size with the device's name.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gloo_all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The gather as ``mesh.all_gather`` staged it for gloo before."""
    src = t.contiguous()
    if src.is_cuda:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)


def _timed(fn, device, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _rank(rank: int, port: int, device: str, sizes, reps: int):
    sys.path.insert(0, ROOT)
    from dynamicpdb_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        dev = torch.device("cuda:0" if device == "cuda" else device)
        group = dist.group.WORLD
        g = torch.Generator(device=dev).manual_seed(rank)
        for mb in sizes:
            n = int(mb * 1e6 / 4) // 2 * 2
            x = torch.randn(n, generator=g, device=dev)
            a = mesh.all_gather(x, group)
            b = gloo_all_gather(x, group)
            if not torch.equal(a, b):
                raise RuntimeError("the two gathers differ")
            row = {"mb_a_rank": mb, "ms": {name: 1e3 * _timed(
                lambda fn=fn: fn(x, group), dev, reps) for name, fn in (
                    ("all_gather", mesh.all_gather),
                    ("gloo_all_gather", gloo_all_gather),
                    ("all_to_all", mesh.all_to_all))}}
            if rank == 0:
                row["device"] = (torch.cuda.get_device_name(0)
                                 if dev.type == "cuda" else "cpu")
                print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mb", type=float, nargs="+", default=[4, 17, 34, 67])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_collectives: torch sees no CUDA device", file=sys.stderr)
        return 1
    mp.spawn(_rank, args=(_free_port(), args.device, args.mb, args.reps),
             nprocs=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
