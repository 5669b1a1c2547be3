"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; ``h100bench/configs/<config>.json`` holds the sizes,
``h100bench/traffic/<traffic>.json`` the mix and the driver that runs it
(``h100bench/drivers/<driver>.py``), and each per-layer metric is read by
``h100bench/metrics/<metric>.py``. A cell, a configuration or a metric is
added by adding such files and entries.

A run loads and warms up (``setup_s``, from the process's start), then
runs whole units (steps, requests, sequences) closed-loop until the first
one that ends at or after ``--seconds``: every rate is all the work of the
window over all of its time. With ``--trace 1`` it then profiles the
traffic file's ``trace_units`` units (after one that warms the profiler
up) and reports the per-layer metrics instead. Last, with the program's
state freed, the driver holds the outputs against the plain reference in
``h100bench/reference`` (``correct``). The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# modules a run may not hold once its window has closed (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamicpdb_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record of it)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout, so only a
    checkout's first run builds."""
    cache = os.path.join(ROOT, ".cache", "h100bench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv_compute")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str):
    """(cell, configuration entry, traffic, end-to-end metrics, per-layer
    metrics) of the cell ``name``: the metrics whose ``workloads`` list
    the cell, or that list none."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells: "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    traffic = load_json(BENCH, "traffic", cell["traffic"] + ".json")

    def applies(m):
        return name in m.get("workloads", [name])

    return (cell, config, traffic,
            [m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def run_window(session, seconds: float, ends=None) -> tuple[float, int, float]:
    """Whole units until the first that ends at or after ``seconds``:
    (work done, units, window seconds); each unit's end (s into the
    window) is appended to ``ends`` when given."""
    work, units = 0.0, 0
    t0 = time.perf_counter()
    while True:
        work += session.unit()
        units += 1
        elapsed = time.perf_counter() - t0
        if ends is not None:
            ends.append(elapsed)
        if elapsed >= seconds:
            return work, units, elapsed


def profile_units(torch, session, n: int):
    """Profile one unit that warms the profiler up, then ``n`` whole units,
    each in a ``bench.unit`` range; returns the reduced trace and the
    profiled units' work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from h100bench.trace import Trace

    work = 0.0
    with session.traced(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(1 + n):
            if i == 1:
                session.reset_counters()
                work = 0.0
            with record_function("bench.unit"):
                work += session.unit()
    return Trace(prof.profiler.kineto_results.events(), skip_units=1), work


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_cache_dirs()
    # the checkout's root, not this folder, so no file here shadows a
    # module of the standard library
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, config_entry, traffic, e2e, per_layer = cell_spec(bench,
                                                            args.workload)
    config = load_json(ROOT, config_entry["file"])

    import torch

    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    driver = load_module(os.path.join(BENCH, "drivers",
                                      traffic["driver"] + ".py"),
                         "h100bench_driver_" + traffic["driver"])

    torch.cuda.reset_peak_memory_stats(device)
    session = driver.Session(config, traffic, args.seed, device)
    setup_s = process_age_s()
    ends: list[float] = []
    work, units, window_s = run_window(session, args.seconds, ends)
    measured = {traffic["rate_metric"]: work / window_s,
                "setup_s": setup_s,
                "peak_mem_gib": torch.cuda.max_memory_allocated(device)
                / 2**30}
    memory_peak_bytes = torch.cuda.max_memory_reserved(device)
    counters = dict(session.counters, window_units=units,
                    window_work=work, window_s=window_s)
    print(f"card: {power_limit()}; window: {units} units, {work} "
          f"{traffic['work_unit']} in {window_s:.3f} s; each unit's end (s): "
          f"{[round(t, 3) for t in ends]}", file=sys.stderr)

    trace = None
    if args.trace:
        trace, traced_work = profile_units(torch, session,
                                           traffic["trace_units"])
        counters.update(session.counters, traced_units=trace.units,
                        traced_work=traced_work)
        print(f"tracing overhead: traced rate "
              f"{traced_work / trace.window_s} against untraced "
              f"{work / window_s} {traffic['work_unit']}/s "
              f"(same run, same seed)", file=sys.stderr)

    t_check = time.perf_counter()
    checks = session.check()  # frees the program's state first
    print(f"the reference's check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    # the window's own counts stand; the profiled units came after it
    counters = dict(session.counters, **{
        k: v for k, v in counters.items() if k.startswith("window_")
        or k.startswith("traced_")})
    attempted = counters["window_units"] + (
        1 + counters["traced_units"] if trace is not None else 0)

    found = loaded_forbidden()
    if found:
        print(f"the run holds modules it may not load: {found}: no result",
              file=sys.stderr)
        return 4

    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted,
        "failed": 0,
        "device": dict(device_info(torch, chips),
                       memory_peak_bytes=memory_peak_bytes),
    }
    if trace is None:
        result["metrics"] = {m["name"]: {"value": measured[m["name"]],
                                         "unit": m["unit"]} for m in e2e}
    else:
        metrics = {}
        for m in per_layer:
            reader = load_module(os.path.join(BENCH, "metrics",
                                              m["name"] + ".py"),
                                 "h100bench_metric_" + m["name"])
            value = reader.read(trace, counters, config)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
