"""The eval slice of the PyTorch port against the JAX package, on the CPU:
eval_cli (plain, --ema, --ref-ckpt, --save-dir, --extension N --save-dcd
--refresh-conditioning --fast-x0) against JAX eval_cli on the same weights
and windows; reverse_sample with classifier-free guidance and aux_traj fed
JAX's per-step noise; rollout's conditioning refresh; make_sampler;
eval_windows; serve_cli --ema; and a CPU rehearsal of chip_smoke.py's
eval phases.

Weights: a JAX init of a TINY model with every all-zero parameter re-drawn
(tests/test_torch_model.live_params), saved as a JAX checkpoint for JAX
eval_cli and carried to the port by weights.state_dict_from_jax (a
train_cli checkpoint, the EMA of one, or JAX's export_reference_checkpoint
for --ref-ckpt). JAX eval_cli runs twice, once per mode, and every port
run is held against those two runs.

Tolerances, float32 on both sides: metric rows 1e-4 relative and 1e-3
absolute (ave_rot's arccos near 1 turns a float32 rounding of a dot
product into up to 0.02 degrees at one residue; the forward agrees to 2e-4
of its scale, tests/test_torch_model.py, and the metrics take means over
it); coordinates of predicted frames, rollouts and the sampler's reverse
chain 2e-4 of their scale (the forward's bar)."""
import json
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu import config as jcfg
from dynamicpdb_tpu import eval_cli as j_eval_cli
from dynamicpdb_tpu.analysis import pdb_io as jpdb
from dynamicpdb_tpu.data import dataset as jdata
from dynamicpdb_tpu.data.featurize import eval_init_window as j_init
from dynamicpdb_tpu.data.featurize import featurize_window as j_featurize
from dynamicpdb_tpu.preprocess import dcd as jdcd
from dynamicpdb_tpu.sampling import reverse as jrev
from dynamicpdb_tpu.train import checkpoint as jckpt
from dynamicpdb_tpu.train.experiment import Trainer as JTrainer
from dynamicpdb_tpu.train.export_torch import export_reference_checkpoint
from dynamicpdb_tpu_torch import config as pcfg
from dynamicpdb_tpu_torch import eval_cli, serve_cli
from dynamicpdb_tpu_torch.data import dataset as pdata
from dynamicpdb_tpu_torch.data.featurize import eval_init_window as p_init
from dynamicpdb_tpu_torch.data.featurize import featurize_window as p_featurize
from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz
from dynamicpdb_tpu_torch.preprocess import dcd as pdcd
from dynamicpdb_tpu_torch.sampling import reverse as prev
from dynamicpdb_tpu_torch.train import checkpoint as pckpt
from dynamicpdb_tpu_torch.train.experiment import Trainer
from dynamicpdb_tpu_torch.train.import_torch import load_reference_checkpoint
from dynamicpdb_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_model import live_params, to_numpy_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "igso3")
PAD_TO = 12
RAW_KEYS = ("atom37", "atom37_mask", "aatype", "residue_index", "force",
            "vel", "node_repr", "edge_repr")
# the TINY model, the tracked small IGSO3 table, 3 reverse steps;
# cfg_drop_rate 0.1 turns classifier-free guidance on in both eval_clis
TINY = [
    f"data.filtering.max_len={PAD_TO}", "data.num_t=3",
    "diffuser.so3.num_omega=100", "diffuser.so3.num_sigma=50",
    "diffuser.so3.series_L=100", f"diffuser.so3.cache_dir={CACHE}",
    "model.node_embed_size=16", "model.edge_embed_size=8",
    "model.ipa.c_s=16", "model.ipa.c_z=8", "model.ipa.c_hidden=8",
    "model.ipa.no_heads=2", "model.ipa.no_qk_points=2",
    "model.ipa.no_v_points=3", "model.ipa.num_blocks=1",
    "model.cfg_drop_rate=0.1", "experiment.noise_scale=0.5",
]
EXT_FLAGS = ["--extension", "2", "--save-dcd", "--fast-x0",
             "--refresh-conditioning", "--dt-ps", "2.0"]
ROW_RTOL, ROW_ATOL = 1e-4, 1e-3
COORD_REL = 2e-4


def _coords_close(got, want, rel=COORD_REL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


def _rows_close(got_rows, want_rows):
    assert [r["name"] for r in got_rows] == [r["name"] for r in want_rows]
    for g, w in zip(got_rows, want_rows):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "name":
                np.testing.assert_allclose(g[k], w[k], rtol=ROW_RTOL,
                                           atol=ROW_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    rows = []
    for i, n in enumerate((10, 12)):
        path = str(d / f"p{i}.npz")
        make_trajectory_npz(path, n_res=n, n_frames=6, seed=i)
        rows.append(f"p{i},{path},{n}")
    (d / "test.csv").write_text("name,atlas_npz,seq_len\n" + "\n".join(rows)
                                + "\n")
    ov = TINY + [f"data.csv_path={d / 'test.csv'}"]

    # JAX: weights, checkpoint, eval_cli in both modes
    cfg = jcfg.apply_overrides(jcfg.Config(), ov)
    trainer = JTrainer(cfg)
    ds = jdata.TrajectoryDataset(cfg.data, split="test", pad_to=PAD_TO)
    sample = ds.get_window(0, np.random.default_rng(0))
    sample.pop("name")
    params, opt_state = trainer.init_params(jax.random.PRNGKey(0), sample)
    params = live_params(params, 21)
    jckpt.save(str(d / "jax.ckpt"), params, opt_state, 5, 0, cfg)
    j_eval_cli.main(["--ckpt", str(d / "jax.ckpt"), "--save-dir",
                     str(d / "jax_out"), "--metrics-json",
                     str(d / "jax.json")] + ov)
    os.makedirs(d / "jax_ext")
    j_eval_cli.main(["--ckpt", str(d / "jax.ckpt"), "--save-dir",
                     str(d / "jax_ext")] + EXT_FLAGS + ov)
    with open(d / "jax.json") as f:
        want = json.load(f)

    # the port: the same weights as a train_cli checkpoint
    pc = pcfg.apply_overrides(pcfg.Config(), ov)
    sd = state_dict_from_jax(to_numpy_tree(params), pc.model)
    port = Trainer(pc, device="cpu")
    port.model.load_state_dict(sd, strict=True)
    pckpt.save(str(d / "port.ckpt"), port.model, port.optimizer, 5, 0,
               pcfg.to_dict(pc))
    # ... as the EMA of a checkpoint whose model weights are others
    pe = pcfg.apply_overrides(pc, ["experiment.ema_decay=0.99"])
    ema = Trainer(pe, device="cpu")
    for name, p in ema.model.named_parameters():
        ema.optimizer.state[p]["ema"] = sd[name].clone()
    pckpt.save(str(d / "ema.ckpt"), ema.model, ema.optimizer, 5, 0,
               pcfg.to_dict(pe))
    # ... and as a reference-format torch checkpoint
    export_reference_checkpoint(str(d / "ref.pth"), params, cfg.model,
                                step=5)
    return dict(dir=d, ov=ov, want=want, params=params, cfg=cfg,
                trainer=trainer, sd=sd, pc=pc)


def test_eval_cli_matches_jax(run, capsys):
    d = run["dir"]
    got = eval_cli.main(["--ckpt", str(d / "port.ckpt"), "--device", "cpu",
                         "--save-dir", str(d / "port_out"), "--metrics-json",
                         str(d / "port.json")] + run["ov"])
    out = capsys.readouterr().out
    for key in ("ave_rot", "ave_trans", "ave_atom_mae", "ave_atom_rmsd"):
        assert f"{key}: " in out
    _rows_close(got["rows"], run["want"]["rows"])
    with open(d / "port.json") as f:
        written = json.load(f)
    assert written["means"] == got["means"]
    for k, v in run["want"]["means"].items():
        np.testing.assert_allclose(got["means"][k], v, rtol=ROW_RTOL,
                                   atol=ROW_ATOL, err_msg=k)


def test_eval_cli_save_dir_artifacts_match_jax(run):
    d = run["dir"]
    if not (d / "port_out").exists():
        eval_cli.main(["--ckpt", str(d / "port.ckpt"), "--device", "cpu",
                       "--save-dir", str(d / "port_out")] + run["ov"])
    for name in ("p0", "p1"):
        with np.load(d / "port_out" / f"{name}_pred.npz") as g, \
                np.load(d / "jax_out" / f"{name}_pred.npz") as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                _coords_close(g[k], w[k], err_msg=k)
        for suffix in (".pdb", "_gt.pdb"):
            got = jpdb.read_pdb(str(d / "port_out" / f"{name}{suffix}"))
            want = jpdb.read_pdb(str(d / "jax_out" / f"{name}{suffix}"))
            _coords_close(got[0], want[0], err_msg=suffix)
            for a, b in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(a, b)
        html = [(d / out / f"{name}.html").read_text()
                for out in ("port_out", "jax_out")]
        figs = [json.loads(h.split('id="figure-data">')[1]
                           .split("</script>")[0]) for h in html]
        for tg, tw in zip(figs[0]["data"], figs[1]["data"]):
            for ax in "xyz":
                _coords_close(tg[ax], tw[ax])
        assert figs[0]["layout"] == figs[1]["layout"]


def test_eval_cli_ema_evaluates_the_ema_weights(run):
    d = run["dir"]
    got = eval_cli.main(["--ckpt", str(d / "ema.ckpt"), "--device", "cpu",
                         "--ema"] + run["ov"])
    _rows_close(got["rows"], run["want"]["rows"])
    # the same checkpoint without --ema evaluates its other weights
    other = eval_cli.main(["--ckpt", str(d / "ema.ckpt"), "--device", "cpu"]
                          + run["ov"])
    assert abs(other["means"]["all_atom_mae"]
               - got["means"]["all_atom_mae"]) > 1e-3
    with pytest.raises(ValueError, match="ema_decay"):
        eval_cli.main(["--ckpt", str(d / "port.ckpt"), "--device", "cpu",
                       "--ema"] + run["ov"])


def test_eval_cli_ref_ckpt_reads_a_reference_checkpoint(run):
    d = run["dir"]
    got = eval_cli.main(["--ckpt", str(d / "ref.pth"), "--ref-ckpt",
                         "--device", "cpu"] + run["ov"])
    _rows_close(got["rows"], run["want"]["rows"])
    with pytest.raises(SystemExit, match="no EMA"):
        eval_cli.main(["--ckpt", str(d / "ref.pth"), "--ref-ckpt", "--ema",
                       "--device", "cpu"] + run["ov"])


def test_reference_unpickler_stubs_missing_classes(run, tmp_path):
    """A reference checkpoint pickles an OmegaConf object, 'module.'
    prefixes and the dead embedding_layer.* entries: the conf loads as a
    stub, the weights load strictly into the port's model."""
    mod = types.ModuleType("config_module_absent_at_load")

    class DictConfig:
        pass

    DictConfig.__module__ = mod.__name__
    DictConfig.__qualname__ = "DictConfig"
    mod.DictConfig = DictConfig
    sd = {f"module.{k}": v for k, v in run["sd"].items()}
    sd["module.embedding_layer.node_ln.weight"] = torch.ones(16)
    path = str(tmp_path / "ref.pth")
    sys.modules[mod.__name__] = mod
    try:
        conf = DictConfig()
        conf.model = {"ipa": {"c_s": 16}}
        torch.save({"model": sd, "conf": conf, "optimizer": None,
                    "epoch": 1, "step": 9}, path)
    finally:
        del sys.modules[mod.__name__]
    payload = load_reference_checkpoint(path)
    assert type(payload["conf"]).__name__ == "DictConfig"
    assert payload["conf"].state["model"] == {"ipa": {"c_s": 16}}
    got = eval_cli.main(["--ckpt", path, "--ref-ckpt", "--device", "cpu"]
                        + run["ov"])
    _rows_close(got["rows"], run["want"]["rows"])


def test_eval_cli_extension_with_dcd_and_refresh_matches_jax(run):
    d = run["dir"]
    out = eval_cli.main(["--ckpt", str(d / "port.ckpt"), "--device", "cpu",
                         "--save-dir", str(d / "port_ext")] + EXT_FLAGS
                        + run["ov"])
    assert [os.path.basename(p) for p in out["extension"]] == [
        "p0_extension.npz", "p1_extension.npz"]
    for name in ("p0", "p1"):
        with np.load(d / "port_ext" / f"{name}_extension.npz") as g, \
                np.load(d / "jax_ext" / f"{name}_extension.npz") as w:
            assert g["atom_traj"].shape == (2, PAD_TO, 37, 3)
            for k in ("atom_traj", "rigid_traj"):
                _coords_close(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g["aatype"], w["aatype"])
        got = pdcd.read_dcd(str(d / "port_ext" / f"{name}_extension.dcd"))
        want = jdcd.read_dcd(str(d / "jax_ext" / f"{name}_extension.dcd"))
        _coords_close(got["xyz"], want["xyz"])
        topo = jpdb.read_pdb(str(d / "port_ext" / f"{name}_topology.pdb"))
        assert got["xyz"].shape == (2, int(topo[1].sum()), 3)
        with open(d / "port_ext" / f"{name}_extension.dcd", "rb") as fg, \
                open(d / "jax_ext" / f"{name}_extension.dcd", "rb") as fw:
            assert fg.read(116) == fw.read(116)  # header, title, atom count


def test_eval_cli_default_device_raises_without_a_card(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_cli.main(["--ckpt", str(run["dir"] / "port.ckpt")] + run["ov"])


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
def _spy(diffuser, chain):
    """Record every reverse step's output frames (tensor-7 as numpy); on
    the JAX side through an ordered debug callback, which runs inside the
    jitted scan."""
    orig = diffuser.reverse

    def reverse(*a, **k):
        out = orig(*a, **k)
        if torch.is_tensor(out.trans):
            chain.append(out.to_tensor_7().numpy())
        else:
            jax.debug.callback(lambda x: chain.append(np.array(x)),
                               out.to_tensor_7(), ordered=True)
        return out

    diffuser.reverse = reverse
    return orig


@pytest.mark.parametrize("cfg_gamma", [None, 2.0], ids=["no-cfg", "cfg"])
def test_reverse_sample_with_jax_noise(run, cfg_gamma):
    """Every reverse step's frames, the final prediction and the aux
    trajectories equal JAX's when the port is fed the normals JAX drew
    (its key split per step, then into rotation and translation)."""
    trainer, params = run["trainer"], run["params"]
    ds = jdata.TrajectoryDataset(run["cfg"].data, split="test", pad_to=PAD_TO)
    raw = next(jdata.eval_windows(ds))
    raw.pop("name")
    num_t, (k_init, k_rev) = 4, jax.random.split(jax.random.PRNGKey(3))
    jf = j_init(k_init, j_featurize({k: jnp.asarray(raw[k]) for k in RAW_KEYS}),
                trainer.diffuser)
    j_chain, p_chain = [], []
    _spy(trainer.diffuser, j_chain)
    try:
        want = jax.jit(lambda p, k, f: jrev.reverse_sample(
            k, trainer.model, p, trainer.diffuser, f, num_t=num_t,
            noise_scale=1.0, cfg_gamma=cfg_gamma, aux_traj=True))(
                params, k_rev, jf)
        jax.effects_barrier()
    finally:
        del trainer.diffuser.reverse

    F, N = jf["res_mask"].shape
    noise, key = [], k_rev
    for _ in range(num_t - 1):
        key, sub = jax.random.split(key)
        k_rot, k_trans = jax.random.split(sub)
        noise.append(tuple(torch.as_tensor(np.array(
            jax.random.normal(k, (F, N, 3)))) for k in (k_rot, k_trans)))
    model = Trainer(run["pc"], device="cpu")
    model.model.load_state_dict(run["sd"])
    pf = p_init(p_featurize({k: torch.as_tensor(raw[k]) for k in RAW_KEYS}),
                model.diffuser)
    pf["rigids_t"] = torch.as_tensor(np.array(jf["rigids_t"]))
    orig = _spy(model.diffuser, p_chain)
    sampler = prev.make_sampler(model.model, model.diffuser, num_t=num_t,
                                noise_scale=1.0, cfg_gamma=cfg_gamma,
                                aux_traj=True)
    got = sampler(pf, noise=noise)

    assert len(p_chain) == len(j_chain) == num_t - 1
    for s, (g, w) in enumerate(zip(p_chain, j_chain)):
        sign = np.sign(np.sum(g[..., :4] * w[..., :4], -1, keepdims=True))
        _coords_close(g[..., :4] * sign, w[..., :4], err_msg=f"step {s}")
        _coords_close(g[..., 4:], w[..., 4:], err_msg=f"step {s}")
    assert got["prot_traj"].shape == (num_t, F, N, 37, 3)
    assert got["rigid_traj"].shape == (num_t, F, N, 7)
    for k in ("atom37", "prot_traj", "rigid_traj"):
        _coords_close(got[k], want[k], err_msg=k)
    if cfg_gamma is not None:  # guidance moved the chain
        model.diffuser.reverse = orig
        plain = []
        _spy(model.diffuser, plain)
        prev.reverse_sample(model.model, model.diffuser, pf, num_t=num_t,
                            noise_scale=1.0, noise=noise)
        assert np.abs(plain[-1][..., 4:] - p_chain[-1][..., 4:]).max() > 1e-3
    with pytest.raises(ValueError, match="noise has 2 steps"):
        sampler(pf, noise=noise[:2])


def test_refresh_window_conditioning_matches_jax():
    rng = np.random.default_rng(4)
    r7 = rng.normal(size=(3, 7, 7)).astype(np.float32)
    ang = rng.normal(size=(3, 7, 7, 2)).astype(np.float32)
    got = prev.refresh_window_conditioning(torch.as_tensor(r7),
                                           torch.as_tensor(ang), 2.5)
    want = jrev.refresh_window_conditioning(jnp.asarray(r7), jnp.asarray(ang),
                                            2.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_rollout_refresh_full_sampler_equals_fast_x0(run):
    """The refreshed rollout's frames do not depend on the sampler's noise:
    the full num_t sampler returns fast_x0's frames, and refreshing moves
    them away from the frozen rollout's."""
    t = Trainer(run["pc"], device="cpu")
    t.model.load_state_dict(run["sd"])
    ds = pdata.TrajectoryDataset(run["pc"].data, split="test", pad_to=PAD_TO)
    raw = next(pdata.eval_windows(ds))
    feats = p_featurize({k: torch.as_tensor(raw[k]) for k in RAW_KEYS})
    kw = dict(n_steps=3, num_t=3, dt_ps=2.0,
              generator=torch.Generator().manual_seed(0))
    full = prev.rollout(t.model, t.diffuser, feats, refresh_conditioning=True,
                        **kw)
    fast = prev.rollout(t.model, t.diffuser, feats, refresh_conditioning=True,
                        fast_x0=True, **kw)
    frozen = prev.rollout(t.model, t.diffuser, feats, fast_x0=True, **kw)
    for a, b in zip(full, fast):
        _coords_close(a, b)
    assert float((frozen[0] - fast[0]).abs().max()) > 1e-4


def test_evaluate_decompose(run, tmp_path):
    """evaluate(decompose=True) adds the four parts' errors; the "model"
    part decodes the predicted rigids and angles as the network does, so
    it equals the row's all-atom error. With aux_traj and save_dir the
    reverse trajectory is saved beside the prediction."""
    from dynamicpdb_tpu_torch.sampling.evaluate import evaluate

    t = Trainer(run["pc"], device="cpu")
    t.model.load_state_dict(run["sd"])
    ds = pdata.TrajectoryDataset(run["pc"].data, split="test", pad_to=PAD_TO)
    rows, means = evaluate(t.model, t.diffuser, pdata.eval_windows(ds),
                           num_t=3, decompose=True, aux_traj=True,
                           save_dir=str(tmp_path))
    _rows_close([{k: r[k] for k in w} for r, w in
                 zip(rows, run["want"]["rows"])], run["want"]["rows"])
    for r in rows:
        for part in ("floor", "rigids_only", "torsion_only", "model"):
            assert math.isfinite(r[f"{part}_mae"])
        np.testing.assert_allclose(r["model_mae"], r["all_atom_mae"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["model_rmsd"], r["all_atom_rmsd"],
                                   rtol=1e-4)
    assert means["model_mae"] == pytest.approx(
        np.mean([r["model_mae"] for r in rows]))
    with np.load(tmp_path / "p0_pred.npz") as z:
        assert z["prot_traj"].shape == (3, 2, PAD_TO, 37, 3)


def test_eval_windows_match_jax(run):
    jds = jdata.TrajectoryDataset(run["cfg"].data, split="test",
                                  pad_to=PAD_TO)
    pds = pdata.TrajectoryDataset(run["pc"].data, split="test",
                                  pad_to=PAD_TO)
    pairs = list(zip(pdata.eval_windows(pds), jdata.eval_windows(jds)))
    assert len(pairs) == 2
    for a, b in pairs:
        assert a["name"] == b["name"] and sorted(a) == sorted(b)
        for k in RAW_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# serve_cli --ema
# ---------------------------------------------------------------------------
def test_serve_cli_ema(run):
    d = run["dir"]
    argv = ["--ckpt", str(d / "ema.ckpt"), "--device", "cpu", "--pad-to",
            str(PAD_TO)] + run["ov"]
    service = serve_cli.service_from_args(serve_cli.parse_args(argv
                                                               + ["--ema"]))
    assert service.step == 5
    for k, v in service.model.state_dict().items():
        torch.testing.assert_close(v, run["sd"][k], rtol=0, atol=0)
    plain = serve_cli.service_from_args(serve_cli.parse_args(argv))
    assert any(not torch.equal(v, run["sd"][k])
               for k, v in plain.model.state_dict().items())
    with pytest.raises(ValueError, match="ema_decay"):
        serve_cli.service_from_args(serve_cli.parse_args(
            ["--ckpt", str(d / "port.ckpt"), "--device", "cpu", "--ema"]
            + run["ov"]))


# ---------------------------------------------------------------------------
# chip_smoke.py's eval phases, rehearsed on the CPU at a small width
# ---------------------------------------------------------------------------
def test_chip_smoke_eval_phases_rehearsal_on_cpu(tmp_path):
    out = chip_smoke.eval_card_vs_cpu(str(tmp_path), devices=("cpu",))
    assert out["cpu"]["rows"] and out["cpu"]["rows"] == out["cpu-ref"]["rows"]


def test_chip_smoke_eval_phase_rehearsal_on_cpu(tmp_path):
    """Phase 6's path (train_cli -> eval_cli, the extension with its DCD,
    evaluate plain and guided with aux_traj) on the tiny config."""
    config = os.path.join(ROOT, "configs", "tiny.yaml")
    extra = ["model.node_repr_dim=256", "model.edge_repr_dim=128",
             "experiment.batch_size=2", "data.filtering.max_len=16",
             "data.num_t=3", f"diffuser.so3.cache_dir={CACHE}"]
    train = chip_smoke.train_phase("cpu", config, extra, lengths=(16, 12),
                                   n_frames=6, max_steps=2,
                                   tmp=str(tmp_path))
    ev = chip_smoke.eval_phase("cpu", config, train["ckpt"], train["csv"],
                               extra, str(tmp_path / "eval"))
    assert [r["name"] for r in ev["rows"]] == ["prot0", "prot1"]
    assert ev["launches"] == 0  # CPU tensors: the plain version, no kernel
    assert len(ev["seconds"]["cfg"]) == 2
