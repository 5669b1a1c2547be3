"""What the per-layer metric files share: each file under ``metrics/``
names its quantity and its unit of work, and reads it through one of these
from the reduced trace (``trace.Trace``) and the run's counters. A reader
that finds nothing to read returns None, and the metric is left out.

The profiler records every host op, which slows the host's side of a
traced unit, so a share of time takes its denominator from the run's
untraced window (``window_s`` over ``window_work``) and only its device
seconds from the traced units."""
from __future__ import annotations

from h100bench import costs


def untraced_s_per_work(counters) -> float | None:
    work, seconds = counters.get("window_work"), counters.get("window_s")
    if not work or not seconds:
        return None
    return seconds / work


def idle_pct(trace, counters) -> float | None:
    """Share of an untraced unit's wall time in which the card runs
    nothing: the device seconds a unit of work in the traced units (the
    union over every stream) against the untraced window's seconds a unit
    of work."""
    per_work = untraced_s_per_work(counters)
    traced_work = counters.get("traced_work")
    if per_work is None or not traced_work:
        return None
    return 100.0 * (1.0 - trace.busy_s / traced_work / per_work)


def mfu_pct(counters, config) -> float | None:
    """Model FLOPs of the untraced window's units (the reference's count a
    unit) over its seconds at the configuration's dtype peak."""
    flops, units = counters.get("flops_per_unit"), counters.get(
        "window_units")
    seconds = counters.get("window_s")
    if not flops or not units or not seconds:
        return None
    peak = costs.peak_flops(config["compute_dtype"])
    return 100.0 * flops * units / (seconds * peak)


def roofline_pct(bound_s: float, device_s: float) -> float | None:
    """Least time over device time, in %; None when the op never ran."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def op_roofline(trace, counters, config, range_name: str,
                bound_key: str = "op_bounds") -> float | None:
    """Roofline share of the op the harness wrapped in ``range_name``:
    the least time of every profiled call over the device time their
    ranges issued."""
    bounds = counters.get(bound_key, {}).get(range_name)
    ranges = trace.in_window(range_name)
    if not bounds or not ranges:
        return None
    return roofline_pct(sum(bounds), trace.range_device_s(ranges))
