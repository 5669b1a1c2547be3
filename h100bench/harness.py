"""What the drivers share: the op ranges of the traced run, FLOP counting
and the comparisons that decide ``correct``."""
from __future__ import annotations

import contextlib

import numpy as np
from torch.profiler import record_function


@contextlib.contextmanager
def rebound(module, name: str, range_name: str, bounds: list, cost):
    """``module.name`` wrapped in a profiler range ``range_name``, each call
    appending ``cost(args, kwargs, result)`` (its least time, s) to
    ``bounds``; restored on exit."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        with record_function(range_name):
            out = fn(*args, **kwargs)
        bounds.append(cost(args, kwargs, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def count_flops(fn):
    """(result of ``fn()``, the FLOPs ``FlopCounterMode`` counts in it)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, counter.get_total_flops()


def max_rel_gap(got, want) -> float:
    """Largest elementwise gap over the reference's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def norm_rel_gap(got, want) -> float:
    """The norm of the difference over the reference's norm (every
    element, float64)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
