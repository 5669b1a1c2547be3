"""Reduce a ``torch.profiler`` trace, in memory, to what the per-layer
metrics read.

The harness profiles a stated number of whole units (steps, requests or
sequences) after its timed window, each inside a ``bench.unit`` range.
Device activity is every kernel, copy and set that a CUDA runtime call
issued, on every stream; busy time is the union of their intervals, never
their sum, so a copy on a side stream that overlaps a kernel counts once. Device time is attributed to a host range (an op the
harness wraps, an autograd node, a program span) through the runtime call
that issued it: a call made on the range's thread inside the range owns
the device work it started, whichever stream ran it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

UNIT = "bench.unit"
OP_PREFIX = "bench.op."  # an op the harness wraps, not what the host does


def _is_harness_label(name: str) -> bool:
    """A range a driver opens around what the host does for its unit
    (``bench.sequence``, ...)."""
    return name.startswith("bench.") and not name.startswith(OP_PREFIX)


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu"))


def union_length(intervals) -> int:
    """Total length covered by [start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    """The reduced trace. ``ranges[name]``: (start, end, thread) of every
    host range of that name; ``device``: (start, end, name, correlation)
    of every device activity; ``window``: (start, end) of the profiled
    units, in ns; ``units``: how many were profiled."""

    def __init__(self, events, skip_units: int = 1):
        self.ranges: dict[str, list] = defaultdict(list)
        runtime = []  # (start, thread, correlation, name)
        device_raw = []
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if "CUDA" in str(e.device_type()):
                # the profiler's copy of a host range on the device's
                # timeline is no device work; its id may equal a runtime
                # call's, which are numbered apart
                if not getattr(e, "is_user_annotation", bool)():
                    device_raw.append((start, end, name, e.correlation_id()))
                continue
            tid = e.start_thread_id()
            if _is_runtime(name):
                runtime.append((start, tid, e.correlation_id(), name))
            else:
                self.ranges[name].append((start, end, tid))
        issued = {c for _, _, c, _ in runtime}
        self.device = sorted(d for d in device_raw if d[3] in issued)
        units = sorted(self.ranges.get(UNIT, []))[skip_units:]
        if not units:
            raise ValueError("the trace holds no profiled unit")
        self.units = len(units)
        self.window = (units[0][0], units[-1][1])
        self.main_thread = units[0][2]
        lo, hi = self.window
        self.runtime = sorted(r for r in runtime if lo <= r[0] <= hi)
        self._rt_start = [r[0] for r in self.runtime]
        self._by_corr = defaultdict(list)
        for s, e, _, c in self.device:
            self._by_corr[c].append((s, e))

    # -- the window --------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def device_intervals(self):
        return clip([(s, e) for s, e, _, _ in self.device], *self.window)

    @property
    def busy_s(self) -> float:
        return union_length(self.device_intervals()) * 1e-9

    # -- attribution -------------------------------------------------------
    def in_window(self, name: str):
        lo, hi = self.window
        return [r for r in self.ranges.get(name, []) if lo <= r[0] <= hi]

    def names_like(self, fragment: str) -> list[str]:
        return [n for n in self.ranges if fragment in n]

    def _issued(self, ranges) -> set:
        corr = set()
        for s, e, tid in ranges:
            i = bisect.bisect_left(self._rt_start, s)
            while i < len(self.runtime) and self.runtime[i][0] <= e:
                if self.runtime[i][1] == tid:
                    corr.add(self.runtime[i][2])
                i += 1
        return corr

    def range_device_s(self, ranges, exclude=()) -> float:
        """Device seconds of the work the runtime calls inside ``ranges``
        ((start, end, thread) host ranges) issued, less what calls inside
        ``exclude`` issued; nested ranges count their work once."""
        corr = self._issued(ranges) - self._issued(exclude)
        return sum(e - s for c in corr for s, e in self._by_corr[c]) * 1e-9

    # -- the breakdown -----------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list:
        lo, hi = self.window
        by_name: dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            if s < hi and e > lo:
                by_name[name] += min(e, hi) - max(s, lo)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns * 1e-9] for name, ns in top]

    def _labels(self, times) -> list[str]:
        """For each of the sorted ``times``: the innermost harness range and
        the innermost other host range that the main thread was in. Host
        ranges on one thread nest, so one sweep with a stack finds them."""
        rs = sorted((s, -e, name) for name, lst in self.ranges.items()
                    for s, e, tid in lst if tid == self.main_thread)
        stack, out, i = [], [], 0
        for t in times:
            while i < len(rs) and rs[i][0] <= t:
                s, neg_e, name = rs[i]
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((-neg_e, name))
                i += 1
            while stack and stack[-1][0] <= t:
                stack.pop()
            harness = next((n for _, n in reversed(stack)
                            if n != UNIT and _is_harness_label(n)), UNIT)
            other = stack[-1][1] if stack and not stack[-1][1].startswith(
                "bench.") else None
            out.append(harness + ("/" + other if other else ""))
        return out

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time in the window, summed by what the host was
        doing when each gap began, the largest ``n`` labels."""
        lo, hi = self.window
        busy = merged(self.device_intervals())
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        by_label: dict[str, int] = defaultdict(int)
        for (s, e), label in zip(gaps, self._labels([g[0] for g in gaps])):
            by_label[label] += e - s
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
        return [[label[:200], ns * 1e-9] for label, ns in top]
