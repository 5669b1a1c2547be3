"""Reference-format export in the PyTorch port (``train/export_torch.py``)
against the JAX package's ``export_reference_checkpoint`` on the same
parameters, on the CPU: equal keys and arrays (the dead embedder entries
included), equal ``conf``, ``epoch``, ``step`` and ``optimizer``; the round
trip through the port's ``train/import_torch``; the CLI on a ``train_cli``
checkpoint; the aatype embedding refused by a strict export and dropped
by ``--no-strict``, as JAX's export does.

Weights: a JAX init of the TINY model with every zero leaf re-drawn
(``tests/test_torch_model.live_params``), carried across by
``weights.state_dict_from_jax``. The export copies numbers, so everything
is bit-equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.models.score_network import DFoldScoreNetwork as JNet
from dynamicpdb_tpu.train import export_torch as jexport
from dynamicpdb_tpu_torch import config as port_config
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib
from dynamicpdb_tpu_torch.train import export_torch, import_torch
from dynamicpdb_tpu_torch.weights import state_dict_from_jax
from tests.test_model import TINY_MODEL
from tests.test_torch_model import (
    AATYPE_MODEL,
    live_params,
    port_cfg,
    to_numpy_tree,
    window_feats,
)

torch.set_num_threads(1)


def jax_params(model_cfg, seed=7):
    from dynamicpdb_tpu.data.featurize import featurize_window

    w = make_window(n_res=10, frame_time=2, seed=0)
    feats = featurize_window(jax.tree_util.tree_map(jax.numpy.asarray, w))
    feats["t"] = jax.numpy.asarray(0.5)
    feats["rigids_t"] = feats["rigids_0"]
    params = jax.jit(JNet(model_cfg).init)(jax.random.PRNGKey(0), feats)
    return to_numpy_tree(live_params(params, seed))


@pytest.fixture(scope="module")
def same_params():
    params = jax_params(TINY_MODEL)
    mcfg = port_cfg(port_config.ModelConfig, TINY_MODEL)
    return params, mcfg, state_dict_from_jax(params, mcfg)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def assert_payloads_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    assert sorted(got["model"]) == sorted(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got["model"][k], v), k
    assert got["conf"].model == want["conf"].model
    for k in ("optimizer", "epoch", "step"):
        assert got[k] == want[k], k


def test_export_matches_jax(same_params, tmp_path):
    params, mcfg, sd = same_params
    jexport.export_reference_checkpoint(str(tmp_path / "jax.pth"), params,
                                        TINY_MODEL, epoch=3, step=40)
    export_torch.export_reference_checkpoint(str(tmp_path / "port.pth"), sd,
                                             mcfg, epoch=3, step=40)
    got, want = load(tmp_path / "port.pth"), load(tmp_path / "jax.pth")
    assert_payloads_equal(got, want)
    assert any(k.startswith("embedding_layer.") for k in got["model"])
    np.testing.assert_array_equal(
        export_torch._dead_embedder_entries(mcfg)[
            "embedding_layer.node_ln.weight"], 1.0)


def test_round_trip_through_import(same_params, tmp_path):
    _, mcfg, sd = same_params
    net = DFoldScoreNetwork(mcfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    path = str(tmp_path / "ref.pth")
    export_torch.export_reference_checkpoint(path, net.state_dict(), mcfg,
                                             step=5)
    back = DFoldScoreNetwork(mcfg, device="cpu")
    extras = import_torch.import_reference_checkpoint(path, back)
    assert extras["step"] == 5
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    feats = {k: torch.as_tensor(np.array(v))
             for k, v in window_feats(10, 2, 10, 5).items()}
    with torch.no_grad():
        a, b = net(feats), back(feats)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_on_a_train_cli_checkpoint(same_params, tmp_path, capsys):
    """The checkpoint's saved model config rebuilds the architecture; a
    bare state dict needs model.* overrides."""
    params, mcfg, sd = same_params
    cfg = port_config.Config(model=mcfg)
    ckpt = str(tmp_path / "step_40.ckpt")
    ckpt_lib.save(ckpt, sd, None, 40, 3, port_config.to_dict(cfg))
    out = export_torch.main(["--ckpt", ckpt, "--out",
                             str(tmp_path / "cli.pth")])
    assert "wrote" in capsys.readouterr().out
    jexport.export_reference_checkpoint(str(tmp_path / "jax.pth"), params,
                                        TINY_MODEL, epoch=3, step=40)
    assert_payloads_equal(load(out), load(tmp_path / "jax.pth"))
    bare = str(tmp_path / "bare.pt")
    torch.save(sd, bare)
    with pytest.raises((KeyError, ValueError), match="model config"):
        export_torch.main(["--ckpt", bare, "--out", str(tmp_path / "x.pth")])


def test_strict_refuses_the_aatype_embedding_as_jax(tmp_path):
    params = jax_params(AATYPE_MODEL)
    mcfg = port_cfg(port_config.ModelConfig, AATYPE_MODEL)
    sd = state_dict_from_jax(params, mcfg)
    assert "score_model.aatype_embed.weight" in sd
    with pytest.raises(ValueError, match="aatype_embed"):
        jexport.export_reference_checkpoint(str(tmp_path / "j.pth"), params,
                                            AATYPE_MODEL)
    with pytest.raises(ValueError, match="aatype_embed"):
        export_torch.export_reference_checkpoint(str(tmp_path / "p.pth"), sd,
                                                 mcfg)
    jexport.export_reference_checkpoint(str(tmp_path / "j.pth"), params,
                                        AATYPE_MODEL, strict=False)
    ckpt = str(tmp_path / "c.ckpt")
    ckpt_lib.save(ckpt, sd, None, 2, 1, port_config.to_dict(
        port_config.Config(model=mcfg)))
    with pytest.raises(ValueError, match="aatype_embed"):
        export_torch.main(["--ckpt", ckpt, "--out", str(tmp_path / "p.pth")])
    export_torch.main(["--ckpt", ckpt, "--out", str(tmp_path / "p.pth"),
                       "--no-strict"])
    got = load(tmp_path / "p.pth")
    assert not any("aatype" in k for k in got["model"])
    want = load(tmp_path / "j.pth")
    got["epoch"], got["step"] = want["epoch"], want["step"]
    assert_payloads_equal(got, want)
    # the written file loads strictly into the network without the option
    off = dataclasses.replace(mcfg, embed=dataclasses.replace(
        mcfg.embed, use_aatype_embedding=False))
    import_torch.import_reference_checkpoint(
        str(tmp_path / "p.pth"), DFoldScoreNetwork(off, device="cpu"))


def test_chip_smoke_export_phase_rehearsal(same_params, tmp_path):
    """chip_smoke.py's phase 11d on the CPU: the CLI's export of a
    train_cli checkpoint read back with a bit-equal forward, and the
    strict refusal of the aatype embedding."""
    import chip_smoke

    _, mcfg, sd = same_params
    ckpt = str(tmp_path / "step_3.ckpt")
    ckpt_lib.save(ckpt, sd, None, 3, 1, port_config.to_dict(
        port_config.Config(model=mcfg)))
    chip_smoke.export_phase(torch, ckpt, str(tmp_path), n_res=9, pad_to=10,
                            device="cpu")
    on = port_cfg(port_config.ModelConfig, AATYPE_MODEL)
    net = DFoldScoreNetwork(on, device="cpu")
    ckpt = str(tmp_path / "aatype.ckpt")
    ckpt_lib.save(ckpt, net.state_dict(), None, 2, 1, port_config.to_dict(
        port_config.Config(model=on)))
    chip_smoke.export_refusal(ckpt, str(tmp_path))
