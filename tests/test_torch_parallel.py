"""Data parallelism in the PyTorch port against the JAX package, on the CPU.

  * the sharding rules (``param_spec``, ``zero_spec``, ``sharded_fraction``)
    against the JAX functions on the same parameters, carried across by
    ``weights.state_dict_from_jax``; ``local_batch_indices``;
  * the meshes (a 'seq' axis among them) and the refusals (a mesh the
    world cannot fill, NCCL with two ranks on one card);
  * a 2-rank gloo step (``tools/dp_step.py`` under
    ``python -m torch.distributed.run``) against the JAX data-parallel step
    on its 8 virtual CPU devices, on the same parameters and JAX's noise;
  * ``grad_accum`` under DP, a ('data', 'model') mesh, ZeRO and
    ``multi_train_step``, each against its plain counterpart in the port;
    ZeRO and a ('data', 'model') mesh with ``embed.use_aatype_embedding``
    on against one process.

Tolerances, float32: the loss to 1e-4 relative, the parameters to the bar
of ``tests/test_torch_train.py::test_five_train_steps_match_jax`` (each
element within 2 lr per step, the whole update within 2e-2 of the norm of
JAX's): a rank sums its windows' gradients and the all-reduce adds the two
sums, another order than one process's, and AMSGrad turns an element whose
gradient is rounding noise into a step of +-lr. Runs that split the same
sums the same way (ZeRO on and off, grad_accum, the 'model' axis) must be
bit-equal: the update is elementwise, and 'model' ranks compute the same
rows.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu import config as jcfg
from dynamicpdb_tpu.parallel import mesh as jmesh
from dynamicpdb_tpu.parallel import sharding as jsharding
from dynamicpdb_tpu_torch import config as pcfg
from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib
from dynamicpdb_tpu_torch.parallel import sharding
from dynamicpdb_tpu_torch.train.experiment import Trainer
from dynamicpdb_tpu_torch.utils import platform
from dynamicpdb_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_model import to_numpy_tree
from tests.test_torch_train import (
    jax_batch_noise,
    jax_config,
    make_pair,
    raw_batch,
    to_port,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 300


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------
def launch(nproc: int, module: str, args: list[str]):
    """``python -m torch.distributed.run --standalone`` (its own free port,
    so parallel test workers never share one) with ``nproc`` ranks, or the
    module in one process without a launcher when ``nproc`` is 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m"]
    if nproc:
        cmd += ["torch.distributed.run", "--standalone",
                f"--nproc_per_node={nproc}", "-m"]
    proc = subprocess.run(cmd + [module] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-6000:])
    return proc


def overrides_of(cfg: pcfg.Config) -> list[str]:
    """``a.b=c`` overrides that turn the default config into ``cfg``."""
    out = []

    def walk(got, default, prefix):
        for f in dataclasses.fields(got):
            g, d = getattr(got, f.name), getattr(default, f.name)
            if dataclasses.is_dataclass(g):
                walk(g, d, f"{prefix}{f.name}.")
            elif g != d:
                v = ("null" if g is None else
                     "(" + ",".join(map(str, g)) + ")" if isinstance(g, tuple)
                     else repr(g) if isinstance(g, float) else str(g))
                out.append(f"{prefix}{f.name}={v}")

    walk(cfg, pcfg.Config(), "")
    return out


def dp_step(nproc: int, out, cfg_args: list[str], *extra: str) -> list[dict]:
    """tools/dp_step.py on ``nproc`` ranks (0: one process); every rank's
    result, in rank order."""
    launch(nproc, "dynamicpdb_tpu_torch.tools.dp_step",
           ["--device", "cpu", "--out", str(out), *extra, *cfg_args])
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
            for r in range(max(nproc, 1))]


def assert_params_close(got: dict, want: dict, start: dict, lr: float,
                        steps: int):
    """Each element within 2 lr per step; the whole update within 2e-2 of
    the norm of ``want``'s update."""
    diff2 = norm2 = 0.0
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2 * lr * steps, err_msg=name)
        diff2 += float((g - w).double().pow(2).sum())
        norm2 += float((w - start[name]).double().pow(2).sum())
    assert math.sqrt(diff2) <= 2e-2 * math.sqrt(norm2), (diff2, norm2)


def assert_results_equal(a: dict, b: dict):
    """Bit-equal parameters, gathered moments, losses and grad norms."""
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert [x["total_loss"] for x in a["aux"]] == [
        x["total_loss"] for x in b["aux"]]
    assert [x["grad_norm"] for x in a["aux"]] == [
        x["grad_norm"] for x in b["aux"]]


# ---------------------------------------------------------------------------
# the sharding rules against JAX
# ---------------------------------------------------------------------------
WIDE_TINY = dict(c_s=128, c_hidden=64)  # some output axes reach 128


@pytest.fixture(scope="module")
def exported():
    """JAX params of a small model whose widths cross the rules'
    thresholds, and the same params as the port's state dict."""
    cfg = jax_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, node_embed_size=128, ipa=dataclasses.replace(
            cfg.model.ipa, **WIDE_TINY)))
    jt, params, _, pt = make_pair(cfg)
    return params, pt


def jax_marks(params, model_cfg, fn) -> dict:
    """``fn(path, leaf)`` of every JAX leaf, carried to the port's names:
    a leaf filled with that number, mapped by state_dict_from_jax."""
    tree = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full(v.shape, fn(path, v), np.float32), params)
    return state_dict_from_jax(to_numpy_tree(tree), model_cfg)


@pytest.mark.parametrize("shape,axes", [((8,), ("data",)),
                                        ((4, 2), ("data", "model")),
                                        ((2, 4), ("data", "model"))])
def test_sharding_rules_match_jax(exported, shape, axes):
    params, pt = exported
    jm = jmesh.make_mesh(shape, axes)
    pm = mesh_lib.Mesh(shape, axes, groups=False)
    m = pm.sizes.get("model", 1)
    # the JAX tree has no linear_rbf (dead in the reference IPA; zeros)
    named = [(n, p) for n, p in pt.model.named_parameters()
             if "linear_rbf" not in n]

    def parts(spec, sizes):
        return math.prod(sizes[a] for a in spec if a is not None)

    j_model = jax_marks(params, pt.cfg.model, lambda path, v: float(
        jsharding.param_spec(path, v, m) != jsharding.P()))
    j_zero = jax_marks(params, pt.cfg.model, lambda path, v: v.size / parts(
        jsharding.zero_spec(path, v, jm), dict(jm.shape)))
    n_model = n_zero = 0
    for name, p in named:
        spec = sharding.param_spec(name, p.shape, m)
        assert float(any(spec)) == float(j_model[name].flatten()[0]), name
        n_model += any(spec)
        zspec = sharding.zero_spec(name, p.shape, pm)
        per_rank = p.numel() / parts(zspec, pm.sizes)
        assert per_rank == float(j_zero[name].flatten()[0]), (name, zspec)
        n_zero += any(zspec)
    assert n_zero > 0
    if m > 1:
        assert n_model > 0  # the case says something
    want = jsharding.sharded_fraction(params["params"], jm)
    assert abs(sharding.sharded_fraction(named, pm) - want) <= 1e-12


@pytest.mark.parametrize("count", [1, 2, 4, 8])
def test_local_batch_indices_match_jax(count):
    for global_batch in (count, 2 * count, 8 * count):
        for index in range(count):
            np.testing.assert_array_equal(
                mesh_lib.local_batch_indices(global_batch, index, count),
                jmesh.local_batch_indices(global_batch, index, count))


# ---------------------------------------------------------------------------
# meshes and refusals
# ---------------------------------------------------------------------------
def test_meshes_in_one_process(monkeypatch):
    mesh = mesh_lib.make_mesh()
    assert mesh.shape == (1,) and mesh.axis_names == ("data",)
    assert mesh_lib.data_size(mesh) == 1 and mesh_lib.data_index(mesh) == 0
    assert mesh_lib.maybe_initialize_distributed(device="cpu") is False
    # one node holds one slice: the slice count is passed, as the JAX
    # tests pass it; a world of 8 is stood in for
    monkeypatch.setattr(mesh_lib, "world", lambda: (5, 8))
    hyb = mesh_lib.make_hybrid_mesh(n_slices=2)
    assert hyb.axis_names == ("slice", "data")
    assert hyb.sizes == {"slice": 2, "data": 4}
    assert hyb.coords == {"slice": 1, "data": 1}
    assert mesh_lib.batch_axes(hyb) == ("slice", "data")
    assert mesh_lib.data_size(hyb) == 8 and mesh_lib.data_index(hyb) == 5
    tp = mesh_lib.make_hybrid_mesh(n_slices=2, model_axis=2)
    assert tp.sizes == {"slice": 2, "data": 2, "model": 2}
    assert mesh_lib.data_size(tp) == 4 and mesh_lib.data_index(tp) == 2
    with pytest.raises(ValueError, match="cannot factor"):
        mesh_lib.make_hybrid_mesh(n_slices=3)
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert mesh_lib.detect_num_slices() == 2
    assert mesh_lib.make_hybrid_mesh().sizes == {"slice": 2, "data": 4}


def test_refusals(monkeypatch):
    # a 'seq' axis (sequence parallelism, parallel/sp.py) is a mesh axis:
    # the meshes once refused here are built, with their sizes and groups
    seq = mesh_lib.make_mesh((1,), ("seq",))
    assert seq.sizes == {"seq": 1} and seq.group("seq") is None
    assert mesh_lib.data_size(seq) == 1 and mesh_lib.grad_axes(seq) == (
        "seq",)
    ds = mesh_lib.Mesh((2, 4), ("data", "seq"), rank=6, groups=False)
    assert ds.sizes == {"data": 2, "seq": 4}
    assert ds.coords == {"data": 1, "seq": 2}
    # 'seq' ranks share their batch rows and sum their gradients
    assert mesh_lib.batch_axes(ds) == ("data",)
    assert mesh_lib.data_size(ds) == 2 and mesh_lib.data_index(ds) == 1
    assert mesh_lib.grad_axes(ds) == ("data", "seq")
    assert ds.partition("seq") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert ds.partition("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert ds.partition("data", "seq") == [list(range(8))]
    with pytest.raises(ValueError, match="holds 2 ranks but the world has 1"):
        mesh_lib.make_mesh((2,), ("data",))
    cfg = pcfg.apply_overrides(pcfg.Config(), [
        "experiment.mesh_shape=(1,1)", "experiment.mesh_axes=(data,seq)"])
    from dynamicpdb_tpu_torch.train_cli import make_run_mesh

    run = make_run_mesh(cfg)
    assert run.sizes == {"data": 1, "seq": 1}
    assert run.partition("seq") == [[0]] and run.group("seq") is None
    # a 'seq' axis with no process group cannot split a window
    with pytest.raises(RuntimeError, match="no process group"):
        from dynamicpdb_tpu_torch.parallel import sp

        sp.enable(mesh_lib.Mesh((2,), ("seq",), groups=False))
    with pytest.raises(ValueError, match="repeated mesh axis"):
        mesh_lib.Mesh((2, 2), ("seq", "seq"), groups=False)
    # NCCL puts one rank on one card: two local ranks and one card raise
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"2 ranks .* NCCL .* sees 1"):
        platform.resolve_device("cuda")
    with pytest.raises(ValueError, match="local rank 1 has no card"):
        platform.resolve_device("cuda", backend="gloo")


# ---------------------------------------------------------------------------
# a 2-rank step against the JAX data-parallel step
# ---------------------------------------------------------------------------
def test_two_rank_step_matches_jax_data_parallel(tmp_path):
    """JAX: make_mesh((8,)), global B = 8, ZeRO on (as
    tests/test_parallel.py:134 runs it); the port: 2 gloo ranks of B = 4 on
    the same exported parameters and JAX's noise for the 8 rows. t is
    drawn from [0.3, 1], as in test_torch_train's unrolled test: at small t
    the float32 IGSO(3) score's rotation terms are rounding noise in both
    packages (ROADMAP Queue C), which no data-parallel split can fix."""
    cfg = dataclasses.replace(jax_config(learning_rate=1e-3),
                              data=jcfg.DataConfig(min_t=0.3))
    jt, params, opt_state, pt = make_pair(cfg)
    start = {k: v.detach().clone() for k, v in pt.model.state_dict().items()}
    batch = raw_batch(8, 8, 10, 2, seed=70)
    key = jax.random.PRNGKey(71)
    mesh = jmesh.make_mesh((8,), ("data",))
    jdp = type(jt)(cfg, mesh=mesh)
    o = jax.tree_util.tree_map(jnp.asarray, opt_state)
    p, o, aux = jdp.compiled_train_step(o)(
        params, o, key, jmesh.shard_batch(
            mesh, jax.tree_util.tree_map(jnp.asarray, batch)))
    payload = str(tmp_path / "payload.pt")
    torch.save(dict(
        state_dict=start,
        batches={k: torch.as_tensor(v)[None] for k, v in batch.items()},
        noises=[jax_batch_noise(key, 8, 2, 10, cfg)]), payload)
    r0, r1 = dp_step(2, tmp_path / "out", overrides_of(pt.cfg) + [
        "experiment.batch_size=4"], "--steps", "1", "--payload", payload)
    assert r0["mesh"] == {"data": 2}
    np.testing.assert_allclose(r0["aux"][0]["total_loss"],
                               float(aux["total_loss"]), rtol=1e-4)
    np.testing.assert_allclose(r0["aux"][0]["grad_norm"],
                               float(aux["grad_norm"]), rtol=1e-3)
    want = state_dict_from_jax(to_numpy_tree(p), pt.cfg.model)
    assert_params_close(r0["params"], want, start,
                        cfg.experiment.learning_rate, 1)
    assert_results_equal(r0, r1)  # the replicas agree to the bit


# ---------------------------------------------------------------------------
# DP variants against plain DP, through the real data path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz

    d = tmp_path_factory.mktemp("dp_manifest")
    rows = []
    for i, (name, n) in enumerate((("1abc", 8), ("2def", 10), ("3ghi", 8))):
        path = str(d / f"{name}.npz")
        make_trajectory_npz(path, n_res=n, n_frames=6, seed=i)
        rows.append(f"{name},{path},{n}")
    csv = d / "train.csv"
    csv.write_text("name,atlas_npz,seq_len\n" + "\n".join(rows) + "\n")
    return str(csv)


def csv_args(csv: str, *overrides: str) -> list[str]:
    return ["--config", os.path.join(ROOT, "configs", "tiny.yaml"),
            "--steps", "3", "--csv", csv, "--pad-to", "12",
            "data.filtering.max_len=12",
            "diffuser.so3.cache_dir=" + os.path.join(ROOT, ".cache", "igso3"),
            *overrides]


@pytest.fixture(scope="module")
def plain_dp(manifest, tmp_path_factory):
    """2 ranks, B = 2 a rank, ZeRO on (the default)."""
    return dp_step(2, tmp_path_factory.mktemp("plain_dp"),
                   csv_args(manifest, "experiment.batch_size=2"))


def test_dp_variants_equal_plain_dp(manifest, plain_dp, tmp_path):
    """grad_accum = 2 under DP, and a 4-rank ('data', 'model') mesh of
    (2, 2) with ZeRO over 'data': the same rows, the same sums, bit-equal
    to 2-rank DP (tests/test_parallel.py:103 and :325)."""
    accum = dp_step(2, tmp_path / "accum", csv_args(
        manifest, "experiment.batch_size=2", "experiment.grad_accum=2"))
    for r in range(2):
        assert_results_equal(accum[r], plain_dp[r])
    tp = dp_step(4, tmp_path / "model", csv_args(
        manifest, "experiment.batch_size=2", "experiment.mesh_shape=(2,2)",
        "experiment.mesh_axes=(data,model)"))
    assert tp[0]["mesh"] == {"data": 2, "model": 2}
    for r in range(4):
        assert_results_equal(tp[r], plain_dp[0])
    # the parameters and their state held between steps fall
    assert tp[0]["state_bytes"] < 0.8 * plain_dp[0]["state_bytes"]
    for r in plain_dp + tp:
        assert r["comm_seconds"][0] > 0


def test_state_digest_tells_states_apart(plain_dp):
    """tools/dp_step.py's digest, which ``--rank0-state`` leaves in place
    of the other ranks' states: the replicas' agree, it is the hash of the
    state saved beside it, and one element moved by one ulp changes it."""
    from dynamicpdb_tpu_torch.tools.dp_step import state_digest

    r0, r1 = plain_dp
    assert r0["digest"] == r1["digest"]
    assert state_digest(r0["params"], r0["optimizer"]) == r0["digest"]
    params = dict(r0["params"])
    name = next(iter(params))
    moved = params[name].clone().reshape(-1)
    moved[0] = torch.nextafter(moved[0], torch.tensor(math.inf))
    params[name] = moved.reshape(params[name].shape)
    assert state_digest(params, r0["optimizer"]) != r0["digest"]
    opt = {**r0["optimizer"], "state": {
        i: dict(st) for i, st in r0["optimizer"]["state"].items()}}
    i = next(iter(opt["state"]))
    opt["state"][i]["mu"] = opt["state"][i]["mu"] + 1.0
    assert state_digest(r0["params"], opt) != r0["digest"]


def test_grad_accum_divides_the_local_batch():
    """2 rows a rank of a global 4: grad_accum = 4 divides the global batch
    but not a rank's, and raises before any collective."""
    cfg = to_port(pcfg.Config, jax_config(grad_accum=4))
    t = Trainer(cfg, device="cpu",
                mesh=mesh_lib.Mesh((2,), ("data",), groups=False))
    with pytest.raises(ValueError, match=r"grad_accum=4 must divide the "
                       r"batch size \(2\)"):
        t.train_step(raw_batch(2, 8, 10, 2, seed=1))


def test_dp_equals_one_process_at_the_global_batch(manifest, plain_dp,
                                                  tmp_path):
    """The same global batch (4) in one process: same windows and noise,
    the gradient summed in another order."""
    (one,) = dp_step(0, tmp_path / "one", csv_args(
        manifest, "experiment.batch_size=4"))
    assert one["mesh"] is None
    start = Trainer(pcfg.load_yaml(os.path.join(ROOT, "configs", "tiny.yaml")),
                    device="cpu").model.state_dict()
    assert_params_close(plain_dp[0]["params"], one["params"], start,
                        1e-4, 3)
    np.testing.assert_allclose([a["total_loss"] for a in plain_dp[0]["aux"]],
                               [a["total_loss"] for a in one["aux"]],
                               rtol=1e-5)
    assert torch.equal(plain_dp[0]["rng"], one["rng"])  # lock step
    for i, st in one["optimizer"]["state"].items():
        for k, v in st.items():
            got = plain_dp[0]["optimizer"]["state"][i][k]
            assert got.shape == v.shape, (i, k)  # gathered whole


def test_aatype_embedding_under_zero_and_model_matches_one_process(
        manifest, tmp_path):
    """``embed.use_aatype_embedding`` on: 2 ranks with ZeRO-1 (the
    embedding's moments split over 'data' along D) against one process at
    the global batch, within the bars above; a 4-rank ('data', 'model')
    mesh of (2, 2) (the embedding replicated over 'model') bit-equal to the
    2 ranks."""
    # D = 64: the embedding [21, 64] is past ZERO_MIN elements
    on = ("model.embed.use_aatype_embedding=true", "model.node_embed_size=64",
          "model.ipa.c_s=64")
    key = "score_model.aatype_embed.weight"
    data = mesh_lib.Mesh((2,), ("data",), groups=False)
    assert sharding.zero_spec(key, (21, 64), data) == (None, "data")
    assert sharding.param_spec(key, (21, 64), 2) == (None, None)
    (one,) = dp_step(0, tmp_path / "one", csv_args(
        manifest, *on, "experiment.batch_size=4"))
    zero = dp_step(2, tmp_path / "zero", csv_args(
        manifest, *on, "experiment.batch_size=2"))
    cfg = pcfg.load_yaml(os.path.join(ROOT, "configs", "tiny.yaml"), list(on))
    start = Trainer(cfg, device="cpu").model.state_dict()
    assert start[key].shape == (21, 64)
    assert not torch.equal(zero[0]["params"][key], start[key])  # it trains
    assert_params_close(zero[0]["params"], one["params"], start, 1e-4, 3)
    np.testing.assert_allclose([a["total_loss"] for a in zero[0]["aux"]],
                               [a["total_loss"] for a in one["aux"]],
                               rtol=1e-5)
    assert_results_equal(zero[0], zero[1])
    tp = dp_step(4, tmp_path / "model", csv_args(
        manifest, *on, "experiment.batch_size=2", "experiment.mesh_shape=(2,2)",
        "experiment.mesh_axes=(data,model)"))
    assert tp[0]["mesh"] == {"data": 2, "model": 2}
    for r in range(4):
        assert_results_equal(tp[r], zero[0])


def test_multi_train_step_equals_k_train_steps():
    cfg = to_port(pcfg.Config, jax_config())
    batches = [raw_batch(2, 8, 10, 2, seed=80 + k) for k in range(3)]
    noises = [jax_batch_noise(jax.random.PRNGKey(90 + k), 2, 2, 10,
                              jax_config()) for k in range(3)]
    a, b = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    for batch, noise in zip(batches, noises):
        want = a.train_step(batch, noise)
    stack = {k: np.stack([bt[k] for bt in batches]) for k in batches[0]}
    got = b.multi_train_step(stack, noises)
    assert got == want
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    # drawn noise: the same generator stream as K calls
    c, d = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    for batch in batches[:2]:
        c.train_step(batch)
    d.multi_train_step({k: v[:2] for k, v in stack.items()})
    for pc, pd in zip(c.model.parameters(), d.model.parameters()):
        assert torch.equal(pc, pd)


# ---------------------------------------------------------------------------
# the sampler under host striding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["time_batch", "length_batch",
                                  "cluster_time_batch", "cluster_length_batch"])
def test_striped_batches_are_the_one_host_batches(tmp_path, mode):
    """Two hosts' batches, row r of a global batch from host r % 2, equal
    the one-host batches window for window; a host loads only the bundles
    of the rows it takes (the others give their frame counts alone). In
    the length modes a batch mixes proteins of one length."""
    from dynamicpdb_tpu_torch.data import dataset as pdata
    from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz

    rows = []
    for i, (name, n, frames) in enumerate((("1abc", 8, 6), ("2def", 8, 9),
                                           ("3ghi", 8, 7), ("4jkl", 10, 12),
                                           ("5mno", 10, 8), ("6pqr", 8, 10))):
        path = str(tmp_path / f"{name}.npz")
        make_trajectory_npz(path, n_res=n, n_frames=frames, seed=i)
        rows.append(f"{name},{path},{n}")
    csv = tmp_path / "train.csv"
    csv.write_text("name,atlas_npz,seq_len\n" + "\n".join(rows) + "\n")
    clusters = tmp_path / "clusters.txt"
    clusters.write_text("1abc_A 6pqr_B\n2def_A\n3ghi_A\n4jkl_A\n5mno_A\n")
    cfg = pcfg.DataConfig(csv_path=str(csv), frame_time=2, sample_mode=mode,
                          cluster_path=str(clusters),
                          filtering=pcfg.FilteringConfig(max_len=16))

    def batches(num_hosts=1, host_index=0, epoch=0):
        ds = pdata.TrajectoryDataset(cfg, pad_to=16)
        loaded, load = [], ds._load_bundle
        ds._load_bundle = lambda path: (loaded.append(path), load(path))[1]
        sampler = pdata.make_sampler(ds, cfg, batch_size=4, seed=3,
                                     num_hosts=num_hosts, host_index=host_index)
        got = list(pdata.batch_iterator(ds, sampler, epoch))
        idx = sampler.global_indices(epoch)[: len(got) * 4]
        taken = {ds.rows[j]["atlas_npz"] for j in idx.reshape(-1, 4)[
            :, host_index::num_hosts].ravel()}
        assert set(loaded) == taken
        return got

    for epoch in (0, 1):
        want = batches(epoch=epoch)
        hosts = [batches(2, h, epoch) for h in (0, 1)]
        assert want and len(hosts[0]) == len(hosts[1]) == len(want)
        for w, h0, h1 in zip(want, *hosts):
            assert sorted(h0) == sorted(h1) == sorted(w)
            for k in w:
                both = np.empty_like(w[k])
                both[0::2], both[1::2] = h0[k], h1[k]
                np.testing.assert_array_equal(both, w[k], err_msg=k)
