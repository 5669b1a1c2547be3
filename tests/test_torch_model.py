"""Score network of the PyTorch port against the JAX package.

Weights: a JAX init of the TINY model (tests/test_model.py), every
zero-initialised parameter re-drawn from a seed (else the IPA output and
the backbone update never reach the output), mapped by
``weights.state_dict_from_jax`` and loaded with ``strict=True``. The same
featurized window goes through both networks at F = 2 and 3, unpadded and
padded.

Tolerance: float32 on both sides, but four IPA blocks of softmax,
normalisation and 5x5 convolutions compound the summation-order
differences; the comparison is 2e-4 relative to each output's largest
magnitude (a few hundred float32 ulps), checked elementwise."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.data.featurize import diffuse_training_window, featurize_window
from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu.models.score_network import DFoldScoreNetwork, score_forward
from dynamicpdb_tpu.train.export_torch import reference_state_dict_from_flax
from dynamicpdb_tpu_torch import config as port_config
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser as TSE3
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork as TNet
from dynamicpdb_tpu_torch.models.score_network import score_forward as t_score_forward
from dynamicpdb_tpu_torch.weights import randomize_, state_dict_from_jax
from tests.test_model import TINY_MODEL, TINY_SE3

torch.set_num_threads(1)

OUT_KEYS = ("rigids", "angles", "unorm_angles", "atom14", "atom37",
            "rot_score", "trans_score")


def port_cfg(cls, jax_cfg):
    """The port's config dataclass holding the same values."""
    return port_config._from_dict(cls, dataclasses.asdict(jax_cfg))


def live_params(params, seed: int):
    """``params`` with every all-zero leaf re-drawn: N(0, (0.1/fan_in)^2)
    for kernels, N(0, 0.01^2) for vectors."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(params["params"])
    for k, v in sorted(flat.items()):
        v = np.asarray(v)
        if not v.any():
            std = 0.1 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim >= 2 else 0.01
            flat[k] = (rng.normal(size=v.shape) * std).astype(np.float32)
    return {"params": flax.traverse_util.unflatten_dict(flat)}


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_outputs_close(got: dict, want: dict, keys=OUT_KEYS, rel=2e-4):
    for k in keys:
        w = np.asarray(want[k], np.float64)
        g = got[k].double().numpy() if torch.is_tensor(got[k]) else got[k]
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0, err_msg=k)


def window_feats(n_res, frame_time, pad_to, seed):
    from dynamicpdb_tpu.data.dataset import pad_window

    w = make_window(n_res=n_res, frame_time=frame_time, seed=seed, rot_wiggle=0.1)
    w = pad_window(w, pad_to)
    return featurize_window(jax.tree_util.tree_map(jnp.asarray, w))


@pytest.fixture(scope="module")
def setup():
    diffuser = SE3Diffuser(TINY_SE3)
    model = DFoldScoreNetwork(TINY_MODEL)
    feats = diffuse_training_window(
        jax.random.PRNGKey(1), window_feats(10, 3, 10, 0), diffuser, 0.01)
    params = live_params(jax.jit(model.init)(jax.random.PRNGKey(0), feats), 7)
    jfwd = jax.jit(lambda p, f: score_forward(model, p, diffuser, f))

    mcfg = port_cfg(port_config.ModelConfig, TINY_MODEL)
    net = TNet(mcfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(params), mcfg),
                        strict=True)
    tdiff = TSE3(port_cfg(port_config.SE3Config, TINY_SE3), device="cpu")
    return params, jfwd, diffuser, net, tdiff


def test_state_dict_matches_reference_export(setup):
    params = setup[0]
    mcfg = port_cfg(port_config.ModelConfig, TINY_MODEL)
    ref = {k: v for k, v in reference_state_dict_from_flax(params, TINY_MODEL)
           .items() if not k.startswith("embedding_layer.")}
    mine = state_dict_from_jax(to_numpy_tree(params), mcfg)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k].numpy(), ref[k], err_msg=k)
    assert sorted(mine) == sorted(TNet(mcfg, device="cpu").state_dict())


def test_unknown_params_rejected(setup):
    params = to_numpy_tree(setup[0])
    params["params"]["aatype_embed"] = {"embedding": np.zeros((21, 16))}
    with pytest.raises(ValueError, match="aatype_embed"):
        state_dict_from_jax(params, port_cfg(port_config.ModelConfig, TINY_MODEL))


@pytest.mark.parametrize("frame_time", [2, 3])
@pytest.mark.parametrize("n_real", [10, 7], ids=["unpadded", "padded"])
def test_score_forward_matches_jax(setup, frame_time, n_real):
    params, jfwd, diffuser, net, tdiff = setup
    feats = diffuse_training_window(
        jax.random.PRNGKey(2), window_feats(n_real, frame_time, 10, 5),
        diffuser, 0.01)
    want = jfwd(params, feats)
    tfeats = {k: torch.as_tensor(np.array(v)) for k, v in feats.items()}
    with torch.no_grad():
        got = t_score_forward(net, tdiff, tfeats)
    assert_outputs_close(got, want)


def test_randomize_reaches_every_parameter():
    mcfg = port_cfg(port_config.ModelConfig, TINY_MODEL)
    a = randomize_(TNet(mcfg, device="cpu"), seed=3).state_dict()
    b = randomize_(TNet(mcfg, device="cpu"), seed=3).state_dict()
    for k in a:
        assert a[k].abs().sum() > 0, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TNet(port_cfg(port_config.ModelConfig, TINY_MODEL))


def test_bf16_policy_matches_jax(setup):
    """compute_dtype=bfloat16 on both sides, same params. bf16 keeps 8
    significant bits (2^-9 relative per rounding) and the two frameworks
    round at different places (XLA fuses and keeps float32 intermediates,
    PyTorch rounds every op's output), so outputs agree to 1e-2 of their
    scale. The normalised angles are left out: dividing by |(sin, cos)|
    amplifies those differences without bound where that norm is small;
    the raw pairs (unorm_angles) and the atoms built from the angles are
    compared."""
    params = setup[0]
    cfg = dataclasses.replace(TINY_MODEL, compute_dtype="bfloat16")
    diffuser = SE3Diffuser(TINY_SE3)
    feats = diffuse_training_window(
        jax.random.PRNGKey(2), window_feats(10, 2, 10, 5), diffuser, 0.01)
    model = DFoldScoreNetwork(cfg)
    want = jax.jit(lambda p, f: score_forward(model, p, diffuser, f))(
        params, feats)
    mcfg = port_cfg(port_config.ModelConfig, cfg)
    net = TNet(mcfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(params), mcfg),
                        strict=True)
    with torch.no_grad():
        got = t_score_forward(net, setup[4],
                              {k: torch.as_tensor(np.array(v))
                               for k, v in feats.items()})
    assert got["atom37"].dtype == torch.float32  # geometry stays float32
    assert_outputs_close(
        got, want, keys=("rigids", "unorm_angles", "atom14", "atom37",
                         "rot_score", "trans_score"), rel=1e-2)
