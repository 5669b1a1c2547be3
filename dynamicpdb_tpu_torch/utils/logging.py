"""Metrics: an append-only JSON-lines stream and a steps/sec timer.

Port of ``MetricsWriter`` and ``StepTimer`` from
``dynamicpdb_tpu/utils/logging.py``. Records go to
``<log_dir>/metrics.jsonl``, one JSON object per line with ``step``,
``time`` and the metrics as floats; there is no TensorBoard mirror.
"""
from __future__ import annotations

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
