"""Where the serving time goes: one rollout frame at release width on the
card, under torch.profiler.

    python -m dynamicpdb_tpu_torch.tools.profile_rollout [--trace out.json]

Seeded random weights (weights.randomize_) and a synthetic 256-residue
window; after a warm-up frame, times one full frame (num_t = 10 forwards)
and one fast_x0 frame (1 forward) on the host clock around a synchronise,
then profiles one full frame and prints the device time by kernel, grouped
by layer, and the device's busy share of the frame's wall time. Runs only
on a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
from collections import defaultdict

import torch

from dynamicpdb_tpu_torch import config as config_lib
from dynamicpdb_tpu_torch.data.featurize import eval_init_window, featurize_window
from dynamicpdb_tpu_torch.data.synthetic import make_window
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu_torch.sampling.reverse import rollout
from dynamicpdb_tpu_torch.utils.platform import resolve_device
from dynamicpdb_tpu_torch.weights import randomize_

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# device kernels by the layer that launches them (first match wins)
GROUPS = (
    ("ipa attention kernel", ("ipa_attn_fwd_kernel",)),
    ("convolution (ConvNet)", ("conv", "cudnn", "implicit_gemm", "xmma_fprop",
                               "nchwToNhwc", "nhwcToNchw")),
    ("matmul (projections)", ("gemm", "cutlass", "xmma", "sm90")),
    ("reduction / norm", ("reduce", "norm", "softmax")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise and other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--trace", default=None,
                        help="also write a Chrome trace to this path")
    args = parser.parse_args(argv)

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = config_lib.apply_overrides(config_lib.Config(), [
        "model.compute_dtype=bfloat16",
        f"diffuser.so3.cache_dir={os.path.join(REPO, '.cache', 'igso3')}",
    ])
    model = randomize_(DFoldScoreNetwork(cfg.model, device=device), 0).eval()
    diffuser = SE3Diffuser(cfg.diffuser, device=device)
    w = make_window(n_res=256, frame_time=cfg.data.frame_time, seed=0)
    g = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        feats = eval_init_window(
            featurize_window({k: torch.as_tensor(v, device=device)
                              for k, v in w.items()}), diffuser, generator=g)

        def frame(fast_x0: bool):
            rollout(model, diffuser, feats, n_steps=1, num_t=10,
                    fast_x0=fast_x0, generator=g)
            torch.cuda.synchronize()

        frame(False)  # warm-up: library handles, cuDNN algorithm choice
        for fast in (False, True):
            t0 = time.perf_counter()
            frame(fast)
            dt = time.perf_counter() - t0
            n_fwd = 1 if fast else 10
            print(f"frame fast_x0={int(fast)}: {dt * 1e3:.2f} ms wall, "
                  f"{dt * 1e3 / n_fwd:.2f} ms per forward [{card}]")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frame(False)
            wall_us = (time.perf_counter() - t0) * 1e6

    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", 0.0)
        by_kernel[e.key][0] += t
        by_kernel[e.key][1] += e.count
    busy = sum(t for t, _ in by_kernel.values())
    print(f"profiled full frame: {wall_us / 1e3:.2f} ms wall, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}% [{card}]")
    if busy == 0:
        print("the profiler recorded no device time")
        return 1
    groups = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in by_kernel.items():
        groups[_group(name)][0] += t
        groups[_group(name)][1] += n
    for name, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"layer {name}: {t / 1e3:.3f} ms device, {n} launches, "
              f"{100 * t / busy:.1f}% of device time")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"kernel {t / 1e3:8.3f} ms {n:6d}x  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
