#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynamicpdb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. setup: the card's name and power limit (nvidia-smi), device checks;
  1. build: every kernel under dynamicpdb_tpu_torch/csrc, one nvcc each;
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the release shapes and at a ragged N, with errors, tolerances and
     times;
  3. serve: the release-width model with seeded random weights is saved,
     loaded by serve_cli and driven over HTTP (healthz + 4 rollouts), with
     the kernel launch counts of that run checked against the model's
     structure; then the same path at a small width on the card and on the
     CPU, which must agree.
The line before the last is the kernel report, the last line
{"ok": true, "device": {...}}. Any failed check exits nonzero; with no CUDA
device, or without the package beside it, the script exits 1 and prints no
result.
"""
from __future__ import annotations

import faulthandler
import glob
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RELEASE_OVERRIDES = [
    # configs/release.yaml at the serving shapes; the dataclass defaults
    # carry the rest of it (c_s 256, c_z 128, c_hidden 256, 8 heads, 8/12
    # points, 4 blocks, frame_time 2, num_t 10, max_len 256)
    "model.compute_dtype=bfloat16",
    f"diffuser.so3.cache_dir={os.path.join(ROOT, '.cache', 'igso3')}",
]
# small width for the card-against-CPU check and the CPU rehearsal
SMALL_OVERRIDES = [
    "model.node_embed_size=16", "model.edge_embed_size=8",
    "model.node_repr_dim=32", "model.edge_repr_dim=16",
    "model.ipa.c_s=16", "model.ipa.c_z=8", "model.ipa.c_hidden=8",
    "model.ipa.no_heads=2", "model.ipa.no_qk_points=2",
    "model.ipa.no_v_points=3", "model.ipa.num_blocks=2",
    "diffuser.so3.num_omega=100", "diffuser.so3.num_sigma=50",
    "diffuser.so3.series_L=100",
    f"diffuser.so3.cache_dir={os.path.join(ROOT, '.cache', 'igso3')}",
]

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def ipa_inputs(torch, device, *, F=2, N=256, H=8, C=256, Pq=8, Pv=12, Dz=32,
               masked=56, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    mask = torch.ones((F, N), device=device)
    if masked:
        mask[:, N - masked:] = 0.0
    args = (rnd(F, N, H, C), rnd(F, N, H, C), rnd(F, N, H, C),
            rnd(F, N, H, Pq, 3, scale=2.0), rnd(F, N, H, Pq, 3, scale=2.0),
            rnd(F, N, H, Pv, 3, scale=2.0), rnd(N, N, H), rnd(N, N, Dz), mask,
            0.05 + 0.1 * torch.rand((H,), generator=g, device=device))
    return args, math.sqrt(1.0 / (3 * C))


def ipa_cost(F, N, H, C, Pq, Pv, Dz):
    """(operations, bytes) the forward must do and move: the five
    contractions (2 per multiply-add) plus ~12 elementwise operations per
    logit; each input read once, each output written once, float32."""
    ops = F * H * N * N * (2 * C + 2 * 3 * Pq + 2 * C + 2 * 3 * Pv + 2 * Dz + 12)
    n_in = 3 * F * N * H * C + 2 * F * N * H * Pq * 3 + F * N * H * Pv * 3 \
        + N * N * H + N * N * Dz + F * N + H
    n_out = F * N * H * C + F * N * H * Pv * 3 + F * N * H * Dz + F * H * N
    return ops, 4 * (n_in + n_out)


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


IPA_ATOL = 1e-4  # real rows: float32 both sides, sums in another order
IPA_LSE_RTOL = 2e-7  # masked-row lse sits near -1e5: 2.5 float32 ulps there


def ipa_errors(got, want, args) -> dict:
    """Max abs error of the kernel's (o, o_pt, o_pair) against the plain
    version, separately on real and pad query rows, each with its tolerance.

    Real rows: 1e-4. A pad row (mask_i = 0) has every logit near
    -inf = -1e5, where float32 rounds to 2^-7 = 0.0078: each logit carries
    up to half of that in either version, so the softmax weights may differ
    by 2 x 0.0078 relative and the output by that much of the largest value
    it averages."""
    mask = args[8]
    real = mask.bool()[..., None, None]  # against [F, N, H, ...]
    out = {}
    for name, g, w, val in zip(("o", "o_pt", "o_pair"), got[:3], want[:3],
                               (args[2], args[5], args[7])):
        diff = (g - w).abs().reshape(g.shape[:3] + (-1,))
        pad_tol = 2 * 2.0 ** -7 * float(val.abs().max())
        out[name] = dict(
            real=float(diff.masked_fill(~real, 0).max()),
            pad=float(diff.masked_fill(real, 0).max()),
            tol_real=IPA_ATOL, tol_pad=pad_tol)
    lse_bad = (got[3] - want[3]).abs() > IPA_ATOL + IPA_LSE_RTOL * want[3].abs()
    out["lse"] = dict(max=float((got[3] - want[3]).abs().max()),
                      ok=not bool(lse_bad.any()))
    return out


def kernel_phase(torch, device, card: str) -> dict:
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

    report = None
    for label, shape in (
        ("release", dict(N=256, masked=56)),
        ("ragged", dict(N=203, masked=11)),
    ):
        args, c_qk = ipa_inputs(torch, device, seed=len(label), **shape)
        got = ipa_mod.ipa_attention(*args, c_qk)
        torch.cuda.synchronize()
        want = ipa_mod.ipa_attention_plain(*args, c_qk)
        errs = ipa_errors(got, want, args)
        for name in ("o", "o_pt", "o_pair"):
            e = errs[name]
            print(f"kernel ipa_attention_fwd {label}: {name} max_abs_err "
                  f"real rows {e['real']:.3e} (tol {e['tol_real']:.0e}), pad "
                  f"rows {e['pad']:.3e} (tol {e['tol_pad']:.3e})")
            check(e["real"] <= e["tol_real"] and e["pad"] <= e["tol_pad"],
                  f"ipa_attention_fwd {label} {name} out of tolerance: {e}")
        print(f"kernel ipa_attention_fwd {label}: lse max_abs_err "
              f"{errs['lse']['max']:.3e} (tol {IPA_ATOL:.0e} + "
              f"{IPA_LSE_RTOL:.0e}*|lse|)")
        check(errs["lse"]["ok"], f"ipa_attention_fwd {label} lse out of "
              "tolerance")
        if label == "release":
            F, N, H, C = args[0].shape
            Pq, Pv, Dz = args[3].shape[-2], args[5].shape[-2], args[7].shape[-1]
            ms = time_ms(torch, lambda: ipa_mod.ipa_attention(*args, c_qk), 50)
            plain_ms = time_ms(
                torch, lambda: ipa_mod.ipa_attention_plain(*args, c_qk), 20)
            ops, nbytes = ipa_cost(F, N, H, C, Pq, Pv, Dz)
            t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            streams = [errs[n] for n in ("o", "o_pt", "o_pair")]
            report = {
                "name": "ipa_attention_fwd",
                "route": "cuda",
                "source": "dynamicpdb_tpu_torch/csrc/ipa_attention_fwd.cu",
                "replaces": "dynamicpdb_tpu/ops/pallas/ipa_attention.py:39",
                "launches": None,  # filled from the serving run
                "max_abs_err": max(max(e["real"], e["pad"]) for e in streams),
                "max_abs_err_real_rows": max(e["real"] for e in streams),
                "max_abs_err_pad_rows": max(e["pad"] for e in streams),
                "max_abs_err_lse": errs["lse"]["max"],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,  # no single PyTorch call has the pair stream
            }
            print(f"kernel ipa_attention_fwd release: {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {report['bound_ms']:.4f} ms "
                  f"({report['bound_by']}: {ops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB), warm L2 [{card}]")
    return report


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------
def _post(base: str, raw: dict, query: str, timeout: float = 600):
    buf = io.BytesIO()
    np.savez(buf, **raw)
    req = urllib.request.Request(f"{base}/rollout?{query}", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        with np.load(io.BytesIO(resp.read())) as z:
            return {k: z[k] for k in z.files}


def serve_phase(device: str, overrides: list[str], *, lengths, pad_to: int,
                n_steps: int, num_t: int, seed: int = 0, label: str = "serve",
                tag: str = "") -> dict:
    """Seeded random weights -> torch.save -> serve_cli (as its CLI builds
    it) -> HTTP on an ephemeral port: healthz, one full rollout per entry
    of ``lengths``, then the second window again with fast_x0=1. Checks
    shapes, finiteness, the fast_x0 identity and the kernel launch counts
    (zero on the CPU, where the plain version runs). Returns the outputs
    and timings."""
    import torch

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch import serve_cli
    from dynamicpdb_tpu_torch.data.synthetic import make_window
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
    from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
    from dynamicpdb_tpu_torch.weights import randomize_

    cfg = config_lib.apply_overrides(config_lib.Config(), overrides)
    on_card = torch.device(device).type == "cuda"
    per_forward = cfg.model.ipa.num_blocks if on_card else 0

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        model = randomize_(DFoldScoreNetwork(cfg.model, device=device), seed)
        torch.save(model.state_dict(), ckpt)
        del model
        args = serve_cli.parse_args(
            ["--ckpt", ckpt, "--port", "0", "--pad-to", str(pad_to),
             "--device", device, *overrides])
        service = serve_cli.service_from_args(args)
    tables = service.diffuser.so3d.tables
    check(tables.cache_hit, f"IGSO3 table {tables.cache_file} was rebuilt, "
          "not read from the cache")
    server = serve_cli.make_server(service, args.host, args.port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{args.host}:{server.server_address[1]}"
    results = []
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["status"] == "ok" and health["pad_to"] == pad_to,
              f"healthz answered {health}")
        print(f"{label}: healthz {health}")

        windows = [make_window(n_res=n, frame_time=cfg.data.frame_time,
                               node_dim=cfg.model.node_repr_dim,
                               edge_dim=cfg.model.edge_repr_dim, seed=seed + i)
                   for i, n in enumerate(lengths)]
        # every window in full, then the second again with fast_x0
        requests = [(w, 0) for w in windows] + [(windows[1], 1)]
        ipa_mod.launches = 0  # the main path's count starts here
        for i, (window, fast) in enumerate(requests):
            n = int(window["aatype"].shape[0])
            raw = {k: window[k] for k in serve_cli.RAW_KEYS}
            before = ipa_mod.launches
            t0 = time.perf_counter()
            out = _post(base, raw, f"n_steps={n_steps}&num_t={num_t}"
                        f"&fast_x0={fast}&seed={seed}")
            dt = time.perf_counter() - t0
            launched = ipa_mod.launches - before
            expect = per_forward * n_steps * (1 if fast else num_t)
            check(out["atom_traj"].shape == (n_steps, n, 37, 3)
                  and out["rigid_traj"].shape == (n_steps, n, 7),
                  f"request {i}: shapes {out['atom_traj'].shape} "
                  f"{out['rigid_traj'].shape}")
            check(bool(np.isfinite(out["atom_traj"]).all()
                       and np.isfinite(out["rigid_traj"]).all()),
                  f"request {i}: non-finite output")
            check(launched == expect, f"request {i}: {launched} kernel "
                  f"launches, expected {expect}")
            results.append(dict(n=n, fast_x0=fast, seconds=dt,
                                launches=launched, out=out))
            print(f"{label}: request {i} n_res={n} pad_to={pad_to} "
                  f"n_steps={n_steps} num_t={num_t} fast_x0={fast}: "
                  f"{dt:.3f} s, {n_steps / dt:.2f} frames/s, "
                  f"{launched} kernel launches{tag}")
        launches = ipa_mod.launches

        # the x0-predictor's frames do not depend on the reverse trajectory:
        # fast_x0 must reproduce the full sampler (same forwards, same
        # inputs); 1e-4 of the coordinates' scale covers reduction-order
        # differences between the two runs' kernels
        full, fast = results[1]["out"], results[-1]["out"]
        for key in ("atom_traj", "rigid_traj"):
            err = float(np.abs(full[key] - fast[key]).max())
            tol = 1e-4 * max(1.0, float(np.abs(full[key]).max()))
            print(f"{label}: fast_x0 vs full {key} max_abs_err {err:.3e} "
                  f"tol {tol:.3e}")
            check(err <= tol, f"fast_x0 {key} differs by {err} > {tol}")

        try:
            _post(base, {"aatype": np.zeros(3, np.int32)}, "n_steps=1")
            check(False, "a window without its keys was accepted")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"missing keys answered {e.code}, not 400")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    return dict(results=results, launches=launches)


def main() -> int:
    faulthandler.dump_traceback_later(600, exit=True)
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "dynamicpdb_tpu_torch")):
        print("chip_smoke: dynamicpdb_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dynamicpdb_tpu_torch.ops import _build
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    # phase 0
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    device = resolve_device("cuda")
    print(f"setup: {kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # phase 1
    names = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    built = _build.build(names)
    for b in built.values():
        print(f"build: {b.name} in {b.seconds:.2f} s -> "
              f"{os.path.relpath(b.path, ROOT)}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build: {b.name}: {line.strip()}")
    print(f"build: {len(built)} kernel(s) in {time.perf_counter() - t0:.2f} s")

    # phase 2
    report = kernel_phase(torch, device, card)

    # phase 3: the main path at release width
    t0 = time.perf_counter()
    serve = serve_phase("cuda", RELEASE_OVERRIDES, lengths=(256, 200, 97),
                        pad_to=256, n_steps=4, num_t=10, tag=f" [{card}]")
    report["launches"] = serve["launches"]
    print(f"serve: release width, 4 requests in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    # the same path at a small width, on the card and on the CPU
    small = {}
    for dev in ("cuda", "cpu"):
        small[dev] = serve_phase(dev, SMALL_OVERRIDES, lengths=(16, 12, 9),
                                 pad_to=16, n_steps=3, num_t=2,
                                 label=f"small-{dev}")
    for i, (a, b) in enumerate(zip(small["cuda"]["results"],
                                   small["cpu"]["results"])):
        for key in ("atom_traj", "rigid_traj"):
            err = float(np.abs(a["out"][key] - b["out"][key]).max())
            tol = 1e-3 * max(1.0, float(np.abs(b["out"][key]).max()))
            print(f"small: request {i} card vs CPU {key} max_abs_err "
                  f"{err:.3e} tol {tol:.3e}")
            check(err <= tol, f"small request {i} {key}: card and CPU "
                  f"differ by {err} > {tol}")

    print(f"total: {time.perf_counter() - t_start:.2f} s wall [{card}]")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": [report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
