"""Metrics: an append-only JSON-lines stream, a steps/sec timer and a
profiler trace.

Port of ``dynamicpdb_tpu/utils/logging.py``. Records go to
``<log_dir>/metrics.jsonl``, one JSON object per line with ``step``,
``time`` and the metrics as floats, and ``read_metrics`` reads them back;
there is no TensorBoard mirror. ``profile_trace`` runs ``torch.profiler``
where the JAX package runs ``jax.profiler`` and writes a Chrome trace
(chrome://tracing, Perfetto) instead of an xprof one.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, metrics: dict[str, Any]):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()


def read_metrics(log_dir: str) -> list[dict]:
    path = os.path.join(log_dir, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Profile the block (CPU, and CUDA when a card is present) and write
    ``<log_dir>/trace.json`` at its end; nothing when ``log_dir`` is
    empty."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling steps/sec over the steps ticked since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._n = 0

    def tick(self, n: int = 1):
        self._n += n

    @property
    def steps_per_sec(self) -> float:
        dt = time.time() - self._t0
        return self._n / dt if dt > 0 else float("inf")
