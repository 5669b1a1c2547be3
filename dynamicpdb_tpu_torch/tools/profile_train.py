"""Where the training time goes: train steps at release width on the card,
under torch.profiler.

    python -m dynamicpdb_tpu_torch.tools.profile_train [--steps 3] \
        [--trace out.json]

configs/release.yaml (B = 8 windows, remat, bfloat16, bf16 AMSGrad state)
with the JAX package's init rules and a batch of 8 copies of one synthetic
256-residue window (the time_batch layout). After two warm-up steps it
times ``--steps`` steps on the host clock, split into the loss and backward
of the 8 windows and the optimizer update (each ended by a synchronise),
reads the peak device memory, then profiles one step and prints the device
time by kernel, grouped by layer, and the device's busy share of the step's
wall time. Runs only on a CUDA device, from the repo root.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from dynamicpdb_tpu_torch import config as config_lib
from dynamicpdb_tpu_torch.data.dataset import pad_window
from dynamicpdb_tpu_torch.data.synthetic import make_window
from dynamicpdb_tpu_torch.train.experiment import Trainer
from dynamicpdb_tpu_torch.utils.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# device kernels by the layer that launches them (first match wins)
GROUPS = (
    ("ipa attention forward kernel", ("ipa_attn_fwd_kernel",)),
    ("ipa attention backward kernels", ("ipa_bwd_",)),
    ("convolution (ConvNet)", ("conv", "cudnn", "implicit_gemm", "xmma_fprop",
                               "xmma_dgrad", "xmma_wgrad", "nchwToNhwc",
                               "nhwcToNchw", "dgrad", "wgrad")),
    ("matmul (projections)", ("gemm", "cutlass", "xmma", "sm90")),
    ("reduction / norm", ("reduce", "norm", "softmax")),
    ("host-device copies", ("memcpy",)),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise and other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--trace", default=None,
                        help="also write a Chrome trace to this path")
    args = parser.parse_args(argv)

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = config_lib.load_yaml(os.path.join(REPO, "configs", "release.yaml"), [
        f"diffuser.so3.cache_dir={os.path.join(REPO, '.cache', 'igso3')}"])
    trainer = Trainer(cfg, device=device)
    B = cfg.experiment.batch_size
    w = pad_window(make_window(n_res=256, frame_time=cfg.data.frame_time,
                               seed=0), cfg.data.filtering.max_len)
    batch = {k: np.stack([w[k]] * B) for k in w}

    def step():
        t0 = time.perf_counter()
        trainer.loss_and_grads(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.optimizer.step()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    for _ in range(2):  # warm-up: library handles, cuDNN algorithm choice
        step()
    torch.cuda.reset_peak_memory_stats()
    for i in range(args.steps):
        fb, opt = step()
        print(f"step {i}: {(fb + opt) * 1e3:.2f} ms wall ({fb * 1e3:.2f} ms "
              f"loss + backward of {B} windows, {opt * 1e3:.2f} ms optimizer "
              f"update), {B / (fb + opt):.2f} windows/s [{card}]")
    print(f"peak max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB [{card}]")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        # annotated ranges (Optimizer.step#...) span kernels already counted
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        by_kernel[e.key][0] += getattr(e, "self_device_time_total", 0.0)
        by_kernel[e.key][1] += e.count
    busy = sum(t for t, _ in by_kernel.values())
    print(f"profiled step: {wall_us / 1e3:.2f} ms wall, device busy "
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
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"kernel {t / 1e3:8.3f} ms {n:6d}x  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
