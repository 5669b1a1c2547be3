"""Share of the roofline of the kernel calls inside the AlphaFold2 model:
every ``ops.node_attention``, ``ops.geom_attention`` and
``ops.geom_triangle`` span of the profiled alignments within an
``alphafold.*`` span that says its shape (``costs_alphafold``), the sum
of their least times over the device time their spans issued."""
import bisect

from h100bench import costs_alphafold
from h100bench.readers import roofline_pct

OPS = ("ops.node_attention", "ops.geom_attention", "ops.geom_triangle")
PARENTS = ("alphafold.msa_row_attention", "alphafold.msa_column_attention",
           "alphafold.triangle_attention",
           "alphafold.triangle_multiplication")


def read(trace, counters, config):
    if "n_res" not in counters:
        return None
    parents = sorted((s, e, tid, name) for name in PARENTS
                     for s, e, tid in trace.in_window(name))
    starts = [p[0] for p in parents]
    calls, bound = [], 0.0
    for name in OPS:
        for s, e, tid in trace.in_window(name):
            i = bisect.bisect_right(starts, s) - 1
            while i >= 0 and not (parents[i][2] == tid
                                  and parents[i][1] >= e):
                i -= 1
            if i < 0:
                continue
            b = costs_alphafold.call_bound_s(parents[i][3], config, counters)
            if b is not None:
                calls.append((s, e, tid))
                bound += b
    if not calls:
        return None
    return roofline_pct(bound, trace.range_device_s(calls))
