"""CPU tests of the readers of the program's spans: ``plm_device_ms``,
``geom_kernels_device_ms`` and ``data_wait_ms`` on a fake trace of two
profiled sequences, built as ``test_h100bench_harness.fake_trace`` builds
one.

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


def reader(name: str):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                           "h100bench_metric_" + name).read


def sequence(o: int, corr: int) -> list:
    """One 200 ns sequence from ``o``: two cycles, device work issued under
    each span (ids from ``corr``). Nested ``ops.geom_attention`` spans
    issue one kernel; ``omegafold.readback`` overlaps ``extract.fetch``; a
    second thread opens an ``extract.pipeline`` span the main thread's
    data time must not take in."""
    c = [corr + i for i in range(7)]
    return [
        Ev("bench.unit", o, 200),
        Ev("extract.pipeline", o, 10),
        Ev("omegafold.cycle", o + 10, 90),
        Ev("omegafold.inputs", o + 10, 10),
        Ev("cudaMemcpyAsync", o + 11, 1, corr=c[0]),
        Ev("Memcpy HtoD", o + 12, 4, cuda=True, corr=c[0]),
        Ev("omegafold.plm", o + 20, 30),
        Ev("cudaLaunchKernel", o + 21, 1, corr=c[1]),
        Ev("plm_gemm", o + 22, 30, cuda=True, corr=c[1]),
        Ev("bench.op.geom", o + 50, 20),
        Ev("ops.geom_attention", o + 50, 20),
        Ev("ops.geom_attention", o + 55, 10),
        Ev("cudaLaunchKernel", o + 56, 1, corr=c[2]),
        Ev("geom_attn_kernel", o + 56, 20, cuda=True, corr=c[2]),
        Ev("bench.op.geom", o + 70, 10),
        Ev("ops.node_attention", o + 70, 10),
        Ev("cudaLaunchKernel", o + 71, 1, corr=c[3]),
        Ev("node_attn_kernel", o + 76, 5, cuda=True, corr=c[3]),
        Ev("omegafold.cycle", o + 100, 50),
        Ev("omegafold.inputs", o + 100, 10),
        Ev("omegafold.plm", o + 110, 20),
        Ev("cudaLaunchKernel", o + 111, 1, corr=c[4]),
        Ev("plm_gemm", o + 112, 10, cuda=True, corr=c[4]),
        Ev("extract.pipeline", o + 120, 20, tid=2),
        Ev("omegafold.readback", o + 150, 15),
        Ev("cudaMemcpyAsync", o + 151, 1, corr=c[5]),
        Ev("Memcpy DtoH", o + 152, 4, cuda=True, corr=c[5]),
        Ev("extract.fetch", o + 160, 30),
        Ev("cudaMemcpyAsync", o + 161, 1, corr=c[6]),
        Ev("Memcpy DtoH", o + 170, 10, cuda=True, corr=c[6]),
        # the profiler's copy of a span on the device's timeline
        Ev("omegafold.cycle", o + 10, 90, cuda=True, corr=c[1],
           annotation=True),
    ]


@pytest.fixture
def spans_trace():
    """A warm-up sequence (skipped), then two profiled ones."""
    return trace.Trace(sequence(0, 1) + sequence(200, 11)
                       + sequence(400, 21), skip_units=1)


def test_plm_reads_its_spans_per_cycle(spans_trace):
    # 30 + 10 ns a sequence, two cycles a sequence
    assert reader("plm_device_ms.extract")(spans_trace, {}, {}) == \
        pytest.approx(20e-6)


def test_geom_kernels_count_nested_spans_once(spans_trace):
    # 20 + 5 ns a sequence, though two nested spans issued the 20 ns
    value = reader("geom_kernels_device_ms.extract")(spans_trace, {}, {})
    assert value == pytest.approx(12.5e-6)
    # the same device time as the harness's ranges around the wrappers
    cycles = len(spans_trace.in_window("omegafold.cycle"))
    assert value * cycles == pytest.approx(1e3 * spans_trace.range_device_s(
        spans_trace.in_window("bench.op.geom")))


def test_data_wait_is_idle_time_inside_the_data_spans(spans_trace):
    # the data spans' union a sequence: [0, 20), [100, 110), [150, 190);
    # idle in them 20 - 4, 10 and 40 - 4 - 10: 52 ns (the other thread's
    # span, idle 18 ns, is not the main thread's)
    assert reader("data_wait_ms.extract")(spans_trace, {}, {}) == \
        pytest.approx(52e-6)


@pytest.mark.parametrize("name", ["plm_device_ms.extract",
                                  "geom_kernels_device_ms.extract",
                                  "data_wait_ms.extract"])
def test_readers_find_nothing_without_the_spans(name):
    assert reader(name)(fake_trace(), {}, {}) is None
