"""CPU test of the reader of the program's ``ops.geom_triangle`` spans,
``geom_triangle_device_ms``, on a fake trace of two profiled sequences.

    python -m pytest h100bench/tests -q
"""
from __future__ import annotations

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from h100bench import run, trace  # noqa: E402
from h100bench.tests.test_h100bench_harness import Ev, fake_trace  # noqa: E402

NAME = "geom_triangle_device_ms.extract"


def reader():
    return run.load_module(os.path.join(BENCH, "metrics", NAME + ".py"),
                           "h100bench_metric_" + NAME).read


def sequence(o: int, corr: int) -> list:
    """One 200 ns sequence from ``o``: two cycles; the first cycle's
    triangle span holds a nested one (as a wrapper calling a wrapper
    would), and its three kernels; the second cycle's span one kernel. A
    geom_attention kernel outside the spans is not the branch's."""
    c = [corr + i for i in range(5)]
    return [
        Ev("bench.unit", o, 200),
        Ev("omegafold.cycle", o + 10, 90),
        Ev("ops.geom_attention", o + 12, 10),
        Ev("cudaLaunchKernel", o + 13, 1, corr=c[0]),
        Ev("geom_attn_kernel", o + 14, 8, cuda=True, corr=c[0]),
        Ev("ops.geom_triangle", o + 30, 30),
        Ev("ops.geom_triangle", o + 31, 20),
        Ev("cudaLaunchKernel", o + 32, 1, corr=c[1]),
        Ev("tri_proj_kernel", o + 33, 6, cuda=True, corr=c[1]),
        Ev("cudaLaunchKernel", o + 34, 1, corr=c[2]),
        Ev("tri_mm_kernel", o + 40, 4, cuda=True, corr=c[2]),
        Ev("cudaLaunchKernel", o + 52, 1, corr=c[3]),
        Ev("tri_out_kernel", o + 53, 2, cuda=True, corr=c[3]),
        Ev("omegafold.cycle", o + 100, 50),
        Ev("ops.geom_triangle", o + 110, 20),
        Ev("cudaLaunchKernel", o + 111, 1, corr=c[4]),
        Ev("tri_proj_kernel", o + 112, 8, cuda=True, corr=c[4]),
    ]


def test_reads_the_branch_per_cycle_nested_spans_once():
    t = trace.Trace(sequence(0, 1) + sequence(200, 11) + sequence(400, 21),
                    skip_units=1)
    # 6 + 4 + 2 + 8 ns a sequence, two cycles a sequence: 10 ns a cycle,
    # though the first cycle's kernels lie in two nested spans
    assert reader()(t, {}, {}) == pytest.approx(10e-6)


def test_reads_none_without_the_span():
    assert reader()(fake_trace(), {}, {}) is None
