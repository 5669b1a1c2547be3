"""CPU tests of the benchmark's harness: discovery by name, the refusal
without a card, the trace arithmetic, the window rule, the op counts, the
import isolation.

    python -m pytest h100bench/tests -q
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from h100bench import costs, harness, run, trace  # noqa: E402


# ---------------------------------------------------------------------------
# the trace arithmetic
# ---------------------------------------------------------------------------
class Ev:
    """A stand-in for a profiler event."""

    def __init__(self, name, start, dur, *, cuda=False, corr=0, tid=1,
                 annotation=False):
        self._v = (name, start, dur, cuda, corr, tid, annotation)

    def is_user_annotation(self):
        return self._v[6]

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_union_counts_overlaps_once():
    assert trace.union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_length([(0, 10), (2, 3), (10, 12)]) == 12
    assert trace.union_length([]) == 0


def fake_trace():
    """Two units; the first (skipped) 0-100, the second 100-200. In the
    second, two kernels on two streams overlap (110-150 and 130-160), a
    copy runs 180-190, one kernel was issued inside an op range, and the
    profiler's copy of a host range on the device's timeline spans all
    (its id equal to a runtime call's)."""
    ev = [
        Ev("bench.unit", 0, 100), Ev("bench.unit", 100, 100),
        Ev("cudaLaunchKernel", 10, 1, corr=1),
        Ev("k0", 20, 30, cuda=True, corr=1),
        Ev("bench.train_step", 100, 100),
        Ev("bench.op.x", 104, 4),
        Ev("cudaLaunchKernel", 105, 1, corr=2),
        Ev("cudaLaunchKernelExC", 120, 1, corr=3),
        Ev("cudaMemcpyAsync", 170, 1, corr=4),
        Ev("aten::item", 160, 20),
        Ev("k1", 110, 40, cuda=True, corr=2),
        Ev("k2", 130, 30, cuda=True, corr=3),
        Ev("Memcpy HtoD", 180, 10, cuda=True, corr=4),
        Ev("bench.unit", 100, 100, cuda=True, corr=3, annotation=True),
    ]
    return trace.Trace(ev, skip_units=1)


def test_trace_idle_is_a_union_over_streams():
    t = fake_trace()
    assert t.units == 1 and t.window == (100, 200)
    assert t.busy_s == pytest.approx(60e-9)  # 110-160 and 180-190
    from h100bench.readers import idle_pct
    # 60 ns busy in one unit against an untraced unit of 100 ns, of 80 ns
    untraced = {"window_work": 2.0, "window_s": 200e-9, "traced_work": 1.0}
    assert idle_pct(t, untraced) == pytest.approx(40.0)
    assert idle_pct(t, dict(untraced, window_s=160e-9)) == pytest.approx(25.0)
    assert idle_pct(t, {"traced_work": 1.0}) is None
    assert t.range_device_s(t.in_window("bench.op.x")) == pytest.approx(
        40e-9)
    gaps = dict(t.idle_gaps())
    assert gaps["bench.train_step"] == pytest.approx(20e-9)  # 100-110, 190-200
    assert gaps["bench.train_step/aten::item"] == pytest.approx(20e-9)
    assert not any(label.startswith("bench.op.") for label in gaps)
    assert [n for n, _ in t.top_device_ops()][:2] == ["k1", "k2"]


# ---------------------------------------------------------------------------
# the window rule
# ---------------------------------------------------------------------------
def test_mfu_reads_the_untraced_window():
    from h100bench.readers import mfu_pct

    counters = {"flops_per_unit": 495e12, "window_units": 3,
                "window_s": 6.0}
    assert mfu_pct(counters, {"compute_dtype": "float32"}) == pytest.approx(
        50.0)
    assert mfu_pct({}, {"compute_dtype": "float32"}) is None


def test_window_counts_the_unit_in_flight():
    class Slow:
        def unit(self):
            time.sleep(0.3)
            return 2.0

    work, units, seconds = run.run_window(Slow(), 1.0)
    assert units == 4 and work == 8.0  # the 4th ends past 1 s and counts
    assert seconds >= 1.2


# ---------------------------------------------------------------------------
# the op counts against a brute-force count
# ---------------------------------------------------------------------------
def test_gated_attention_counts_match_counted_contractions():
    from h100bench.reference.ops.geom_attention import _gated_attention_plain

    B, R, H, Lq, L, d, c = 3, 2, 2, 5, 5, 6, 4
    x = torch.randn(B, R, L, d)
    w = torch.randn(d, R, H, 2 * c)
    b = torch.randn(R, H, 1, 2 * c)
    _, flops = harness.count_flops(lambda: _gated_attention_plain(
        x, w, b, w, b, torch.zeros(1, R, H, Lq, L), None, c, 0.5))
    ew = B * R * H * (4 * Lq * L + 4 * Lq * c)
    assert flops == costs.gated_attention_cost(B, R, H, Lq, L, d, c) - ew


def test_bounds_take_the_larger_time():
    assert costs.bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert costs.bound_s(1.0, 3.35e12, "float32") == pytest.approx(1.0)
    assert costs.peak_flops("float32") == 495e12


# ---------------------------------------------------------------------------
# no card, no result
# ---------------------------------------------------------------------------
def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "extract-omegafold-n256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


# ---------------------------------------------------------------------------
# a cell, a configuration and a metric are found by name
# ---------------------------------------------------------------------------
DUMMY_DRIVER = '''
import contextlib, time
from torch.profiler import record_function
from h100bench import harness


class Session:
    def __init__(self, config, traffic, seed, device):
        self.counters = {"size": config["size"]}

    def unit(self):
        with record_function("bench.request"):
            time.sleep(0.02)
        return 3.0

    def traced(self):
        return contextlib.nullcontext()

    def reset_counters(self):
        pass

    def check(self):
        return {"dummy_gap": harness.check(0.0, 1.0)}
'''
DUMMY_METRIC = '''
def read(trace, counters, config):
    return float(trace.units * counters["size"])
'''


@pytest.fixture
def added_cell(tmp_path, monkeypatch):
    """A copy of the benchmark with one more configuration, traffic,
    driver, metric and cell, added as files and entries only; torch told
    that a card is there (the dummy driver needs none)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (root / "h100bench/configs/dummy-config.json").write_text(
        json.dumps({"size": 5, "compute_dtype": "float32"}))
    (root / "h100bench/traffic/dummy-mix.json").write_text(json.dumps(
        {"driver": "dummy", "rate_metric": "dummy_rate", "work_unit": "items",
         "trace_units": 2}))
    (root / "h100bench/drivers/dummy.py").write_text(DUMMY_DRIVER)
    (root / "h100bench/metrics/dummy_units.dummy.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy-config", "source": "test",
                             "file": "h100bench/configs/dummy-config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "items/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy-cell"]})
    bench["per_layer"].append({"name": "dummy_units.dummy", "unit": "units",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "dummy_rate",
                               "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    fake = types.SimpleNamespace(
        is_available=lambda: True, device_count=lambda: 1,
        set_device=lambda d: None, get_device_name=lambda i=0: "test card",
        reset_peak_memory_stats=lambda d=None: None,
        max_memory_allocated=lambda d=None: 2**30,
        max_memory_reserved=lambda d=None: 2**31)
    for k, v in vars(fake).items():
        monkeypatch.setattr(torch.cuda, k, v)
    cpu_profile = torch.profiler.profile

    def profile(*args, activities=None, **kwargs):  # no CUDA to trace here
        return cpu_profile(*args, activities=[
            torch.profiler.ProfilerActivity.CPU], **kwargs)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    return root


@pytest.mark.parametrize("trace_flag", [0, 1])
def test_added_cell_runs(added_cell, capsys, trace_flag):
    mod = run.load_module(str(added_cell / "h100bench/run.py"),
                          "copied_run")
    saved = list(sys.path)
    try:
        rc = mod.main(["--workload", "dummy-cell", "--seed", str(2**40 + 3),
                       "--seconds", "0.2", "--trace", str(trace_flag)])
    finally:
        sys.path[:] = saved
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check dummy_gap")
    if trace_flag:
        assert res["metrics"]["dummy_units.dummy"]["value"] == 10.0
        assert res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {"dummy_rate", "peak_mem_gib",
                                       "setup_s"}
        assert res["metrics"]["peak_mem_gib"]["value"] == 1.0


# ---------------------------------------------------------------------------
# what the benchmark runs loads neither JAX nor the JAX package, and the
# reference nothing of the port
# ---------------------------------------------------------------------------
def _program_modules() -> list[str]:
    """The port's modules the drivers import."""
    mods = set()
    for name in os.listdir(os.path.join(BENCH, "drivers")):
        tree = ast.parse(open(os.path.join(BENCH, "drivers", name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "") \
                    .startswith("dynamicpdb_tpu_torch"):
                mods.add(node.module)
    return sorted(mods)


def _bench_modules(sub: str = "") -> tuple[list[str], list[str]]:
    """(files loaded by path: the drivers and metrics, module names: the
    rest) of the benchmark under ``sub``, its tests left out."""
    paths, names = [], []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        rel = os.path.relpath(d, ROOT)
        if "tests" in rel.split(os.sep) or "__pycache__" in rel:
            continue
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            if os.path.exists(os.path.join(d, "__init__.py")):
                names.append(".".join(rel.split(os.sep) + [f[:-3]])
                             .removesuffix(".__init__"))
            else:
                paths.append(os.path.join(d, f))
    return paths, names


def _loaded_top_names(paths: list[str], modules: list[str]) -> set:
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"for i, p in enumerate({paths!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'm{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    paths, names = _bench_modules()
    names = _loaded_top_names(paths, names + _program_modules())
    assert "dynamicpdb_tpu_torch" in names  # the drivers' program is there
    assert not names & {"jax", "jaxlib", "flax", "dynamicpdb_tpu"}


def test_reference_loads_nothing_of_the_port():
    paths, names = _bench_modules("reference")
    assert not paths and len(names) > 10
    names = _loaded_top_names(paths, names)
    assert not names & {"dynamicpdb_tpu_torch", "dynamicpdb_tpu", "jax"}
