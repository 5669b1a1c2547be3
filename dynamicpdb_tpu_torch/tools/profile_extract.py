"""Where an extraction cycle's time goes: OmegaFold at release width and
depth on the card, under torch.profiler.

    python -m dynamicpdb_tpu_torch.tools.profile_extract [--n-res 256] \
        [--cycles 3] [--dtype float32] [--trace out.json]

Seeded random weights (weights.random_omegafold_state_dict, 795M
parameters) built straight on the card, and a random sequence of --n-res
residues with the pipeline's 16-row pseudo-MSA. After a warm-up cycle it
times --cycles cycles on the host clock around a synchronise and reads the
peak device memory, then profiles one cycle and prints the device time of
each stage (the model's profiler ranges: the PLM and embedders, each
GeoFormer step summed over the 50 blocks, the structure module, atom14 and
the confidence head), the device time by kernel group, and the device's
busy share of the cycle's wall time. Runs only on a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from dynamicpdb_tpu_torch.models.omegafold.model import (
    OmegaFoldConfig,
    omegafold_cycle,
    omegafold_from_state_dict,
)
from dynamicpdb_tpu_torch.models.omegafold.pipeline import (
    RESTYPES,
    make_pseudo_msa,
    tokenize,
)
from dynamicpdb_tpu_torch.utils.platform import resolve_device
from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict

# device kernels by what launches them (first match wins)
GROUPS = (
    ("geometric attention kernel", ("geom_attn_kernel<float, false",
                                    "geom_attn_kernel<__nv_bfloat16, false")),
    ("attention-with-edge-bias kernel", ("geom_attn_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90", "bmm")),
    ("reduction / norm / softmax", ("reduce", "norm", "softmax")),
)


TOP_STAGES = ("plm_and_embedders", "geoformer", "structure_module",
              "atom14_and_confidence")


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise and other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n-res", type=int, default=256)
    parser.add_argument("--cycles", type=int, default=3,
                        help="cycles timed after the warm-up")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32")
    parser.add_argument("--trace", default=None,
                        help="also write a Chrome trace to this path")
    args = parser.parse_args(argv)

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = OmegaFoldConfig()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    model = omegafold_from_state_dict(random_omegafold_state_dict(cfg, 0),
                                      device=device, dtype=dtype)
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list(RESTYPES), args.n_res))
    cyc = make_pseudo_msa(tokenize(seq), num_pseudo_msa=15, num_cycle=1)[0]
    act = model.plm_node_embedder.weight.dtype
    L = args.n_res
    p_msa = torch.as_tensor(cyc["p_msa"], device=device)
    mask = torch.as_tensor(cyc["p_msa_mask"], device=device).to(act)
    prev = (torch.zeros(L, cfg.node_dim, dtype=act, device=device),
            torch.zeros(L, L, cfg.edge_dim, dtype=act, device=device),
            torch.zeros(L, 14, 3, dtype=act, device=device))

    def cycle():
        out = omegafold_cycle(model, p_msa, mask, *prev)
        torch.cuda.synchronize()
        return out

    with torch.inference_mode():
        cycle()  # warm-up: library handles, kernel build and load
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.cycles):
            t0 = time.perf_counter()
            cycle()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        print(f"cycle n_res={L} {args.dtype}: {np.median(times):.2f} ms wall "
              f"(median of {len(times)}: {[round(t, 2) for t in times]}), "
              f"{1e3 / np.median(times):.3f} cycles/s; peak "
              f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            cycle()
            wall_us = (time.perf_counter() - t0) * 1e6

    # a profiler range appears twice: as a host event whose device time is
    # that of the kernels launched inside it (read here), and as an
    # annotation on the device's timeline spanning them, gaps included
    # (skipped: it is no kernel)
    by_kernel = defaultdict(lambda: [0.0, 0])
    stages = defaultdict(lambda: [0.0, 0])
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.key_averages():
        if e.key.startswith("omegafold."):
            if e.device_type != cuda:
                stages[e.key][0] += getattr(e, "device_time_total", 0.0)
                stages[e.key][1] += e.count
        elif e.device_type == cuda:
            by_kernel[e.key][0] += getattr(e, "self_device_time_total", 0.0)
            by_kernel[e.key][1] += e.count
    busy = sum(t for t, _ in by_kernel.values())
    print(f"profiled cycle: {wall_us / 1e3:.2f} ms wall, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}% [{card}]")
    if busy == 0:
        print("the profiler recorded no device time")
        return 1
    # the cycle's four stages add up; the GeoFormer's steps lie inside its
    for name, (t, n) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        name = name[len("omegafold."):]
        kind = "stage" if name in TOP_STAGES else "  geoformer step"
        print(f"{kind} {name}: {t / 1e3:.3f} ms device, {n} calls, "
              f"{100 * t / busy:.1f}% of device time")
    groups = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in by_kernel.items():
        groups[_group(name)][0] += t
        groups[_group(name)][1] += n
    for name, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"group {name}: {t / 1e3:.3f} ms device, {n} launches, "
              f"{100 * t / busy:.1f}% of device time")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"kernel {t / 1e3:8.3f} ms {n:6d}x  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
