"""Leaf modules of the PyTorch port against the JAX package, on the CPU: the
SO(3) maps ``rotvec_to_rotmat``, ``rotmat_to_rotvec``, ``hat`` and
``rotation_geodesic_distance`` (``ops/so3.py``), ``read_metrics`` and
``profile_trace`` (``utils/logging.py``), and ``utils/compile_cache.py``
(the kernel libraries' directory and its toolchain manifest); and the
library call ``tools/bench_ipa.py`` times beside the IPA kernels, which
must compute the plain version's o and o_pt.

Tolerances: float32 on both sides through sin, cos and atan2, 5e-6
absolute at unit scale (the bar of tests/test_torch_geometry.py for the
same conversions); ``hat`` only moves numbers, so it is exact. The
geodesic distance is 2 arccos(|q1 . q2|), whose slope grows without bound
as the dot product nears 1: one float32 ulp there (6e-8) moves the angle
by 2 sqrt(2 x 6e-8) = 7e-4, so 1e-3.
"""
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.ops import so3 as jso3
from dynamicpdb_tpu.utils import logging as jlogging
from dynamicpdb_tpu_torch.ops import _build
from dynamicpdb_tpu_torch.ops import so3
from dynamicpdb_tpu_torch.utils import compile_cache
from dynamicpdb_tpu_torch.utils import logging as plogging

torch.set_num_threads(1)

ATOL = 5e-6


def rotvecs(seed: int) -> np.ndarray:
    """Rotation vectors from 0 to just under pi, and a few tiny ones."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.concatenate([rng.uniform(0, np.pi - 1e-3, 56),
                            [0.0, 1e-7, 1e-5, 1e-4, 1e-3, 2e-3, 0.5, 3.0]])
    return (axis * angle[:, None]).astype(np.float32)


def test_rotvec_rotmat_maps_match_jax():
    v = rotvecs(0)
    m = so3.rotvec_to_rotmat(torch.as_tensor(v))
    np.testing.assert_allclose(m.numpy(), np.asarray(jso3.rotvec_to_rotmat(
        jnp.asarray(v))), rtol=0, atol=ATOL)
    back = so3.rotmat_to_rotvec(m)
    np.testing.assert_allclose(back.numpy(), np.asarray(jso3.rotmat_to_rotvec(
        jnp.asarray(m.numpy()))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), v, rtol=0, atol=5e-4)


def test_hat_matches_jax():
    v = rotvecs(1).reshape(4, 16, 3)
    h = so3.hat(torch.as_tensor(v))
    assert h.shape == (4, 16, 3, 3)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jso3.hat(v)))
    np.testing.assert_array_equal(h.numpy(), -h.transpose(-1, -2).numpy())


def test_rotation_geodesic_distance_matches_jax():
    rng = np.random.default_rng(2)
    q1 = rng.normal(size=(32, 4)).astype(np.float32)
    q2 = np.concatenate([rng.normal(size=(30, 4)), q1[30:31], -q1[31:]]
                        ).astype(np.float32)
    got = so3.rotation_geodesic_distance(torch.as_tensor(q1),
                                         torch.as_tensor(q2))
    want = np.asarray(jso3.rotation_geodesic_distance(q1, q2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # arccos at |dot| = 1: both clip to 0 for q and -q
    assert float(got[-2]) < 1e-3 and float(got[-1]) < 1e-3


def test_read_metrics_reads_what_both_write(tmp_path):
    w = plogging.MetricsWriter(str(tmp_path))
    w.write(1, {"loss": 0.5, "grad_norm": np.float32(2.0)})
    w.write(2, {"loss": torch.tensor(0.25)})
    w.close()
    got = plogging.read_metrics(str(tmp_path))
    assert got == jlogging.read_metrics(str(tmp_path))
    assert [r["step"] for r in got] == [1, 2]
    assert got[1]["loss"] == 0.25


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """The light profile keeps the program's spans and drops the ops."""
    with plogging.profile_trace(None):
        pass  # nothing to write
    assert plogging.span("leaf.none") is plogging.span("leaf.none")
    with plogging.profile_trace(str(tmp_path / "prof")):
        for _ in range(3):
            with plogging.span("leaf.matmul"):
                torch.tanh(torch.ones(64, 64) @ torch.ones(64, 64))
    assert not torch.autograd._profiler_enabled()
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    names = [e.get("name") for e in trace["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("leaf.matmul") == 3
    assert not [n for n in names if n.startswith("aten::")]


def test_profile_trace_private_entry_points_keep_their_signatures():
    """``profile_trace`` enables the profiler through torch's private
    entry points (the public one records every op); a torch whose
    signatures differ fails here, not in a profile."""
    from torch._C import _autograd, _profiler

    def params(fn):
        head = fn.__doc__.splitlines()[0]
        inner = head[head.index("(") + 1:head.rindex(")")]
        return [p.split(":")[0].strip() for p in inner.split(", ") if p]

    assert params(_autograd._prepare_profiler)[:2] == ["config",
                                                       "activities"]
    assert params(_autograd._enable_profiler) == ["config", "activities",
                                                  "scopes"]
    assert params(_autograd._disable_profiler) == []
    assert "_ProfilerResult" in _autograd._disable_profiler.__doc__
    assert hasattr(_autograd._ProfilerResult, "save")
    assert params(_profiler.ProfilerConfig.__init__)[:8] == [
        "self", "state", "report_input_shapes", "profile_memory",
        "with_stack", "with_flops", "with_modules", "experimental_config"]
    assert hasattr(_profiler.RecordScope, "USER_SCOPE")


def test_compile_cache_points_the_kernel_build_dir(tmp_path, monkeypatch,
                                                   caplog):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = _build.BUILD_DIR
    assert default == os.path.join(os.path.dirname(os.path.dirname(
        compile_cache.__file__)), "build")
    monkeypatch.setattr(compile_cache, "toolchain",
                        lambda: {"nvcc": None, "torch": torch.__version__})
    path = compile_cache.enable_persistent_cache(str(tmp_path / "kernels"))
    assert path == _build.BUILD_DIR == str(tmp_path / "kernels")
    assert _build.library_path("geom_attention").startswith(path + os.sep)
    with open(os.path.join(path, "MANIFEST.json")) as f:
        assert json.load(f) == {"toolchain": {"nvcc": None,
                                              "torch": torch.__version__}}
    # unchanged toolchain: quiet; another torch: warned, not raised
    with caplog.at_level(logging.WARNING):
        compile_cache.enable_persistent_cache(path)
        assert "STALE" not in caplog.text
        monkeypatch.setattr(compile_cache, "toolchain",
                            lambda: {"nvcc": "V0", "torch": "0.0"})
        compile_cache.enable_persistent_cache(path)
    assert "STALE kernel cache" in caplog.text
    # no path: the directory in use stays
    assert compile_cache.enable_persistent_cache() == path


def test_compile_cache_without_nvcc_records_none(monkeypatch):
    if os.path.exists(os.path.join(os.environ.get("CUDA_HOME",
                                                  "/usr/local/cuda"),
                                   "bin", "nvcc")):
        pytest.skip("nvcc is present: its version is recorded")
    monkeypatch.setenv("PATH", "")
    assert compile_cache.nvcc_version() is None
    assert compile_cache.toolchain()["torch"] == torch.__version__


def test_bench_ipa_library_call_is_the_ipa_forward():
    """``scaled_dot_product_attention`` on ``sdpa_operands`` (points folded
    into the dot product, bias, norms and mask in the float mask) gives the
    plain IPA forward's o and o_pt on the real rows, to float32 rounding
    (1e-5 at unit scale, the forward's bar in test_torch_ipa_attention)."""
    import chip_smoke
    from dynamicpdb_tpu_torch.ops.ipa_attention import ipa_attention_plain
    from dynamicpdb_tpu_torch.tools import bench_ipa

    args, c_qk = chip_smoke.ipa_inputs(torch, torch.device("cpu"), N=40, C=16,
                                       H=2, Pq=3, Pv=4, Dz=8, masked=7,
                                       seed=1)
    o, o_pt = bench_ipa.sdpa_outputs(bench_ipa.sdpa_operands(*args, c_qk), 16)
    want = ipa_attention_plain(*args, c_qk)
    real = args[8].bool()
    for got, w in ((o, want[0]), (o_pt, want[1])):
        assert got.shape == w.shape
        np.testing.assert_allclose(got[real].numpy(), w[real].numpy(),
                                   rtol=0, atol=1e-5)
