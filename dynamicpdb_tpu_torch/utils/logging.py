"""Metrics: an append-only JSON-lines stream, a steps/sec timer, the
program's profiler spans and a profiler trace.

Port of ``dynamicpdb_tpu/utils/logging.py``. Records go to
``<log_dir>/metrics.jsonl``, one JSON object per line with ``step``,
``time`` and the metrics as floats, and ``read_metrics`` reads them back;
there is no TensorBoard mirror. ``profile_trace`` runs the PyTorch
profiler where the JAX package runs ``jax.profiler`` and writes a Chrome
trace (chrome://tracing, Perfetto) instead of an xprof one.

``span(name)`` marks a layer boundary of the program (``extract.*``,
``omegafold.*``, ``ops.*``): a profiler range while a profiler runs, so it
lies on the device trace's clock, and one branch otherwise.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A profiler range ``name`` around the block while a profiler runs
    (``profile_trace``, ``torch.profiler.profile``); a shared no-op
    context otherwise, so an unprofiled call never enters the profiler."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Profile the block and write ``<log_dir>/trace.json`` (a Chrome
    trace) at its end; nothing when ``log_dir`` is empty.

    A light profile: the program's spans (``span``), and with a card the
    CUDA runtime calls and the device's kernels, copies and sets, each
    runtime call with the correlation id of the device work it issued; no
    operator is recorded. The spans' and the device's timestamps share one
    clock. The profiler's public interface records every operator, so the
    profiler is enabled here through its private entry points with only
    the user scope (``torch.profiler.record_function``) kept."""
    if not log_dir:
        yield
        return
    from torch._C import _autograd, _profiler

    activities = {_profiler.ProfilerActivity.CPU}
    cuda = torch.cuda.is_available()
    if cuda:
        activities.add(_profiler.ProfilerActivity.CUDA)
    config = _profiler.ProfilerConfig(
        _profiler.ProfilerState.KINETO, False, False, False, False, False,
        _profiler._ExperimentalConfig())
    os.makedirs(log_dir, exist_ok=True)
    _autograd._prepare_profiler(config, activities)
    _autograd._enable_profiler(config, activities,
                               {_profiler.RecordScope.USER_SCOPE})
    try:
        yield
        if cuda:
            torch.cuda.synchronize()
    finally:
        result = _autograd._disable_profiler()
    result.save(os.path.join(log_dir, "trace.json"))


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
