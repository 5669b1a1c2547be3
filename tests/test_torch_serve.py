"""The serving slice of the PyTorch port as a whole.

The JAX RolloutService and the port's, on the same window and the same
weights (a JAX init with its zero-initialised layers re-drawn, mapped by
weights.state_dict_from_jax), return the same trajectories: the returned
frames do not depend on the sampler's noise (an x0-predictor; see
sampling/reverse.py), so no noise is shared. Tolerance: float32 on both
sides through 3 autoregressive steps of 2 forwards each, 2e-4 of the
coordinates' scale.

Also: the port's HTTP server (healthz, a rollout, 400 and 404), and a CPU
rehearsal of chip_smoke.py's serving phase at a small width."""
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.serve_cli import RAW_KEYS as JAX_RAW_KEYS
from dynamicpdb_tpu.serve_cli import RolloutService as JaxService
from dynamicpdb_tpu.train.experiment import Trainer
from dynamicpdb_tpu_torch import config as port_config
from dynamicpdb_tpu_torch import serve_cli
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_model import live_params, port_cfg, to_numpy_tree
from tests.test_train import TINY_CFG

torch.set_num_threads(1)

PAD_TO = 16


def _raw(n_res, seed):
    w = make_window(n_res=n_res, frame_time=2, seed=seed, rot_wiggle=0.1)
    return {k: w[k] for k in serve_cli.RAW_KEYS}


@pytest.fixture(scope="module")
def services():
    trainer = Trainer(TINY_CFG)
    params, _ = trainer.init_params(jax.random.PRNGKey(1),
                                    make_window(n_res=PAD_TO, frame_time=2))
    params = live_params(params, 11)
    cfg = port_cfg(port_config.Config, TINY_CFG)
    net = DFoldScoreNetwork(cfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(params), cfg.model),
                        strict=True)
    port = serve_cli.RolloutService(
        net, SE3Diffuser(cfg.diffuser, device="cpu"), pad_to=PAD_TO, step=5)
    return JaxService(trainer, params, pad_to=PAD_TO), port


def test_raw_keys_match():
    assert serve_cli.RAW_KEYS == JAX_RAW_KEYS


@pytest.mark.parametrize("fast_x0", [False, True])
def test_rollout_service_matches_jax(services, fast_x0):
    jax_service, port = services
    raw = _raw(12, 3)
    kw = dict(n_steps=3, num_t=2, fast_x0=fast_x0)
    want = jax_service.extend(raw, **kw)
    got = port.extend(raw, **kw)
    for key in ("atom_traj", "rigid_traj"):
        assert got[key].shape == want[key].shape
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], atol=2e-4 * scale,
                                   rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def server(services):
    _, port = services
    srv = serve_cli.make_server(port, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(base, raw, query):
    buf = io.BytesIO()
    np.savez(buf, **raw)
    req = urllib.request.Request(f"{base}/rollout?{query}", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


def test_http_round_trip(server, services):
    with urllib.request.urlopen(f"{server}/healthz", timeout=60) as resp:
        h = json.loads(resp.read())
    assert h["status"] == "ok" and h["pad_to"] == PAD_TO and h["step"] == 5
    raw = _raw(9, 4)
    out = _post(server, raw, "n_steps=2&num_t=2&seed=3")
    assert out["atom_traj"].shape == (2, 9, 37, 3)
    assert out["rigid_traj"].shape == (2, 9, 7)
    direct = services[1].extend(raw, n_steps=2, num_t=2, seed=3)
    np.testing.assert_array_equal(out["atom_traj"], direct["atom_traj"])


def test_http_errors(server):
    def expect(code, url, body=None):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(url, data=body),
                                   timeout=60)
        assert e.value.code == code
        return json.loads(e.value.read())["error"]

    raw = _raw(9, 4)
    raw.pop("force")
    buf = io.BytesIO()
    np.savez(buf, **raw)
    assert "missing keys" in expect(400, f"{server}/rollout?n_steps=2",
                                    buf.getvalue())
    assert "n_steps" in expect(400, f"{server}/rollout", buf.getvalue())
    big = io.BytesIO()
    np.savez(big, **_raw(20, 1))
    assert "pad_to" in expect(400, f"{server}/rollout?n_steps=1",
                              big.getvalue())
    expect(404, f"{server}/nope")


def test_cli_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    ckpt = tmp_path / "w.pt"
    torch.save({}, ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--ckpt", str(ckpt)])


def test_chip_smoke_serve_phase_rehearsal_on_cpu():
    out = chip_smoke.serve_phase("cpu", chip_smoke.SMALL_OVERRIDES,
                                 lengths=(16, 12, 9), pad_to=16, n_steps=3,
                                 num_t=2, label="rehearsal")
    assert [r["n"] for r in out["results"]] == [16, 12, 9, 12]
    assert out["launches"] == 0  # CPU tensors: the plain version, no kernel
