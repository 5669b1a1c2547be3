"""Sequence parallelism in the PyTorch port (``parallel/sp.py``) against
one process and against the JAX package, on the CPU.

  * the rectangular plain IPA (a block of query rows against every key)
    and its backward against rows [q0, q0 + Nq) of JAX's
    ``dense_ipa_attention`` at full N and its ``jax.vjp``, masked rows in
    the block;
  * the four collectives, forward and backward, on 2 gloo ranks against
    their one-process definitions;
  * the model's forward and gradients, and the rollout (full sampler and
    fast_x0), under a ('seq',) = 2 mesh (``tools/sp_run.py``) against one
    process, at N = 9, which 2 does not divide, with remat on; the forward
    and gradients again with ``embed.use_aatype_embedding`` on;
  * a train step on a ('data', 'seq') = (1, 2) and a (2, 2) mesh
    (``tools/dp_step.py``) against the JAX Trainer's step on its
    ('data', 'seq') 2x4 mesh (tests/test_parallel.py:184), on the same
    exported parameters and JAX's noise; a ('data', 'seq', 'model') mesh
    against the ('data', 'seq') one.

Tolerances. The collectives move and add numbers: bit-equal. The model
forward: 1e-5 absolute on every output (float32 sums of a rank's rows added
in another order). Gradients: ``test_torch_train.assert_grads_close``'s
bar (1e-3 of each gradient's largest magnitude, floored at 1e-6 of the
model's largest). The rollout: 1e-4 absolute, the bar of JAX's own test
(tests/test_sampler.py:224). The train steps: the bar of
``test_two_rank_step_matches_jax_data_parallel``. The rectangular IPA:
``test_torch_ipa_backward``'s (2e-4 with cotangents zero on pad rows,
2 x 2^-7 of the largest gradient with cotangents on every row), and the
forward's of ``test_torch_ipa_attention`` (1e-5 on real rows).
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu import config as jcfg
from dynamicpdb_tpu.models.ipa import dense_ipa_attention
from dynamicpdb_tpu.parallel import mesh as jmesh
from dynamicpdb_tpu_torch.config import load_yaml
from dynamicpdb_tpu_torch.data.featurize import eval_init_window, featurize_window
from dynamicpdb_tpu_torch.data.synthetic import make_window
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.sampling.reverse import rollout
from dynamicpdb_tpu_torch.train.experiment import RAW_KEYS
from dynamicpdb_tpu_torch.weights import randomize_, state_dict_from_jax
from tests.test_torch_ipa_backward import PAD_RTOL, ZERO_PAD_ATOL
from tests.test_torch_kernels import NAMES, make_inputs
from tests.test_torch_model import to_numpy_tree
from tests.test_torch_parallel import (
    ROOT,
    assert_params_close,
    assert_results_equal,
    dp_step,
    launch,
    overrides_of,
)
from tests.test_torch_train import (
    jax_batch_noise,
    jax_config,
    make_pair,
    raw_batch,
)

torch.set_num_threads(1)

C_B = math.sqrt(1.0 / 3)
TINY = os.path.join(ROOT, "configs", "tiny.yaml")
# two blocks, remat on: the backward re-runs IPA's key gather
SP_OVERRIDES = ["model.remat=true", "model.ipa.num_blocks=2",
                "diffuser.so3.cache_dir=" + os.path.join(ROOT, ".cache",
                                                         "igso3")]


# ---------------------------------------------------------------------------
# (a) the rectangular IPA against JAX's dense IPA at full N
# ---------------------------------------------------------------------------
def _block(d: dict, q0: int, q1: int) -> dict:
    """The query side of ``d`` cut to rows [q0, q1); the keys whole."""
    out = dict(d)
    for n in ("q", "q_pts"):
        out[n] = d[n][:, q0:q1]
    out["bias"], out["pair_z"] = d["bias"][q0:q1], d["pair_z"][q0:q1]
    out["mask"] = d["mask"][:, q0:q1]
    return out


@pytest.mark.parametrize("zero_pad", [True, False],
                         ids=["pad-cotangents-zero", "pad-cotangents-random"])
@pytest.mark.parametrize("q0,q1", [(0, 7), (7, 13)],
                         ids=["first-rows", "last-rows-masked"])
def test_rectangular_ipa_matches_jax_rows(q0, q1, zero_pad):
    """N = 13 with its last 4 residues masked; the block [7, 13) holds
    them. Forward and every input's gradient through the port's autograd
    function (its plain versions on the CPU) against the same rows of JAX's
    dense attention and of its vjp with the cotangents zero off the
    block."""
    d, c_qk = make_inputs(31, F=2, N=13, H=2, C=8, Pq=4, Pv=6, Dz=4,
                          masked=4)
    rng = np.random.default_rng(32)
    jargs = [jnp.asarray(d[n]) for n in NAMES]
    want, vjp = jax.vjp(lambda *a: dense_ipa_attention(*a, c_qk), *jargs)
    cots = []
    for w in want:
        c = np.zeros(w.shape, np.float32)
        block = rng.normal(size=(w.shape[0], q1 - q0) + w.shape[2:])
        if zero_pad:
            m = d["mask"][:, q0:q1]
            block = block * m.reshape(m.shape + (1,) * (block.ndim - 2))
        c[:, q0:q1] = block
        cots.append(c)
    jgrads = dict(zip(NAMES, vjp(tuple(jnp.asarray(c) for c in cots))))

    b = _block(d, q0, q1)
    args = {n: torch.as_tensor(b[n]).requires_grad_(n != "mask")
            for n in NAMES}
    key_mask = torch.as_tensor(d["mask"])
    outs = ipa_mod.ipa_attention(*(args[n] for n in NAMES), c_qk,
                                 key_mask=key_mask)
    real = d["mask"][:, q0:q1].astype(bool)
    for got, w in zip(outs[:3], want):
        np.testing.assert_allclose(got.detach().numpy()[real],
                                   np.asarray(w)[:, q0:q1][real], atol=1e-5)
    # lse: the square call's rows
    lse = ipa_mod.ipa_attention_plain(*(torch.as_tensor(d[n]) for n in NAMES),
                                      c_qk)[3]
    np.testing.assert_allclose(outs[3].numpy(), lse[:, :, q0:q1].numpy(),
                               rtol=1e-6, atol=1e-5)
    loss = sum((o * torch.as_tensor(c[:, q0:q1])).sum()
               for o, c in zip(outs[:3], cots))
    loss.backward()
    for n in NAMES:
        if n == "mask":
            continue
        w = np.asarray(jgrads[n])
        if n in ("q", "q_pts", "bias", "pair_z"):  # the block's rows
            w = w[q0:q1] if n in ("bias", "pair_z") else w[:, q0:q1]
        scale = max(1.0, float(np.abs(w).max()))
        tol = ZERO_PAD_ATOL if zero_pad else PAD_RTOL * scale
        np.testing.assert_allclose(args[n].grad.numpy(), w, atol=tol,
                                   rtol=0, err_msg=n)


def test_square_call_is_the_rectangular_call_with_one_mask():
    d, c_qk = make_inputs(33, N=11, masked=3)
    args = [torch.as_tensor(d[n]) for n in NAMES]
    a = ipa_mod.ipa_attention_plain(*args, c_qk)
    b = ipa_mod.ipa_attention_plain(*args, c_qk, key_mask=args[8].clone())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# (b), (c), (e): two ranks of tools/sp_run.py against one process
# ---------------------------------------------------------------------------
N_RES = 9  # 2 'seq' ranks do not divide it
ROWS = 5


def _window():
    from dynamicpdb_tpu_torch.data.dataset import pad_window

    w = pad_window(make_window(n_res=N_RES - 1, frame_time=2, seed=3,
                               rot_wiggle=0.1), N_RES)
    return featurize_window({k: torch.as_tensor(np.asarray(w[k]))
                             for k in RAW_KEYS})


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """One launch of 2 ranks (every part of sp_run) and the one-process
    results on the same payload."""
    tmp = tmp_path_factory.mktemp("sp_run")
    cfg = load_yaml(TINY, SP_OVERRIDES)
    model = DFoldScoreNetwork(cfg.model, device="cpu")
    randomize_(model, 3)
    diffuser = SE3Diffuser(cfg.diffuser, device="cpu")
    g = torch.Generator().manual_seed(4)
    feats = _window()
    out = model(feats)
    cots = {k: torch.randn(v.shape, generator=g) for k, v in out.items()}
    sum(torch.sum(out[k] * c) for k, c in cots.items()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    init = eval_init_window(feats, diffuser,
                            generator=torch.Generator().manual_seed(5))
    roll = dict(init_feats=init, n_steps=2, num_t=3, noise_scale=0.1, seed=6)
    with torch.no_grad():
        want_roll = {
            mode: rollout(model, diffuser, init, n_steps=2, num_t=3,
                          noise_scale=0.1, fast_x0=fast,
                          generator=torch.Generator().manual_seed(6))
            for mode, fast in (("full", False), ("fast_x0", True))}

    def rn(*shape):
        return torch.randn(shape, generator=g)

    coll = dict(x=rn(2, 2, ROWS, 3), n_res=N_RES, g_rows=rn(2, 2, N_RES, 3),
                g_replicated=rn(2, 2, N_RES, 3), g_sum=rn(2, 2, ROWS, 3),
                g_halo=rn(2, 2, ROWS + 4, 3))
    payload = tmp / "payload.pt"
    torch.save(dict(state_dict=model.state_dict(), collectives=coll,
                    forward=dict(feats=feats, cotangents=cots),
                    rollout=roll), payload)
    launch(2, "dynamicpdb_tpu_torch.tools.sp_run",
           ["--device", "cpu", "--config", TINY, "--payload", str(payload),
            "--out", str(tmp / "out"), *SP_OVERRIDES])
    ranks = [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(ranks=ranks, coll=coll, outputs=out, grads=grads,
                rollout=want_roll, model=model)


def _expected_collective(name: str, coll: dict, r: int):
    """(output, input gradient) of rank r, from the whole-window
    definitions."""
    x, S = coll["x"], 2
    F, D = x.shape[1], x.shape[-1]
    whole = torch.cat(list(x), 1)

    def rows_of(g):  # the padded window's rows of rank r
        g = torch.cat([g, g.new_zeros(F, S * ROWS - N_RES, D)], 1)
        return g[:, r * ROWS:(r + 1) * ROWS]

    if name == "rows":  # every rank's keys take every rank's gradient
        return whole[:, :N_RES], sum(rows_of(g) for g in coll["g_rows"])
    if name == "replicated":
        return whole[:, :N_RES], rows_of(coll["g_replicated"][r])
    if name == "sum":
        return x.sum(0), coll["g_sum"].sum(0)
    zero = torch.zeros(F, 2, D)
    top = x[r - 1][:, -2:] if r > 0 else zero
    bot = x[r + 1][:, :2] if r + 1 < S else zero
    g = coll["g_halo"]
    gx = g[r][:, 2:2 + ROWS].clone()
    if r > 0:
        gx[:, :2] += g[r - 1][:, -2:]
    if r + 1 < S:
        gx[:, -2:] += g[r + 1][:, :2]
    return torch.cat([top, x[r], bot], 1), gx


@pytest.mark.parametrize("name", ["rows", "replicated", "sum", "halo"])
def test_collective_forward_and_backward(sp_runs, name):
    for r, res in enumerate(sp_runs["ranks"]):
        got_y, got_g = res["collectives"][name]
        want_y, want_g = _expected_collective(name, sp_runs["coll"], r)
        assert torch.equal(got_y, want_y), (name, r)
        assert torch.equal(got_g, want_g), (name, r)


def test_model_forward_under_seq_matches_one_process(sp_runs):
    for res in sp_runs["ranks"]:
        assert res["mesh"] == {"seq": 2}
        for k, want in sp_runs["outputs"].items():
            got = res["forward"]["outputs"][k]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        # IPA's key gather runs in the forward and again in the remat
        # backward, with the halos and the statistics
        assert res["sp_calls"]["forward"] > 0


def test_model_gradients_under_seq_match_one_process(sp_runs):
    want = sp_runs["grads"]
    floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
    for res in sp_runs["ranks"]:
        got = res["forward"]["grads"]
        for name, w in want.items():
            scale = max(float(w.abs().max()), floor / 1e-3)
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=1e-3 * scale, rtol=0,
                                       err_msg=name)


@pytest.fixture(scope="module")
def sp_aatype_runs(tmp_path_factory):
    """The forward part alone, with ``embed.use_aatype_embedding`` on: one
    launch of 2 ranks and the one-process outputs and gradients. The
    embedding is added on a rank's rows, before the node mask."""
    tmp = tmp_path_factory.mktemp("sp_aatype")
    overrides = SP_OVERRIDES + ["model.embed.use_aatype_embedding=true"]
    cfg = load_yaml(TINY, overrides)
    model = randomize_(DFoldScoreNetwork(cfg.model, device="cpu"), 8)
    feats = _window()
    out = model(feats)
    g = torch.Generator().manual_seed(9)
    cots = {k: torch.randn(v.shape, generator=g) for k, v in out.items()}
    sum(torch.sum(out[k] * c) for k, c in cots.items()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    assert float(grads["score_model.aatype_embed.weight"].abs().max()) > 0
    payload = tmp / "payload.pt"
    torch.save(dict(state_dict=model.state_dict(),
                    forward=dict(feats=feats, cotangents=cots)), payload)
    launch(2, "dynamicpdb_tpu_torch.tools.sp_run",
           ["--device", "cpu", "--config", TINY, "--payload", str(payload),
            "--out", str(tmp / "out"), *overrides])
    ranks = [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(ranks=ranks, outputs=out, grads=grads)


def test_aatype_embedding_forward_under_seq_matches_one_process(
        sp_aatype_runs):
    test_model_forward_under_seq_matches_one_process(sp_aatype_runs)


def test_aatype_embedding_gradients_under_seq_match_one_process(
        sp_aatype_runs):
    assert "score_model.aatype_embed.weight" in sp_aatype_runs["grads"]
    test_model_gradients_under_seq_match_one_process(sp_aatype_runs)


@pytest.mark.parametrize("mode", ["full", "fast_x0"])
def test_rollout_under_seq_matches_one_process(sp_runs, mode):
    """JAX tests/test_sampler.py:224 for the port: every rank draws the
    same noise and returns the one-process frames."""
    for res in sp_runs["ranks"]:
        for got, want in zip(res["rollout"][mode], sp_runs["rollout"][mode]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                       rtol=0)


def test_inactive_sp_is_the_identity():
    """Without a 'seq' axis every function is the identity and the model
    takes its one-process path."""
    x = torch.randn(2, 5, 3)
    with sp.activated(None):
        assert not sp.is_active()
        for y in (sp.gather_rows(x, 5), sp.gather_replicated(x, 5),
                  sp.all_reduce_sum(x), sp.halo_exchange(x, 2),
                  sp.take_rows(x, 5, 1)):
            assert y is x or torch.equal(y, x)
        assert sp.row_range(9) == (0, 9, 9)


def test_row_range_pads_to_the_seq_size():
    from dynamicpdb_tpu_torch.parallel.mesh import Mesh

    for n, S, want in ((9, 2, [(0, 5, 10), (5, 5, 10)]),
                       (5, 4, [(0, 2, 8), (2, 2, 8), (4, 2, 8), (6, 2, 8)])):
        for s in range(S):
            m = Mesh((S,), ("seq",), rank=s, groups=False)
            assert sp.row_range(n, m) == want[s]
    # a rank past the window's end holds pad rows only: no edge rows
    m = Mesh((4,), ("seq",), rank=3, groups=False)
    edge = np.zeros((1, 5, 5, 2))
    assert sp.host_edge_rows({"edge_repr": edge}, m)["edge_repr"].shape == (
        1, 0, 5, 2)
    with pytest.raises(RuntimeError, match="no process group"):
        sp.enable(m)


# ---------------------------------------------------------------------------
# (d) a train step under ('data', 'seq') against JAX's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_sp_step(tmp_path_factory):
    """The JAX Trainer's step on a ('data', 'seq') 2x4 mesh: global B = 2
    windows of N = 9 (8 real), t from [0.3, 1]; the port's payload of the
    same parameters, batch and noise."""
    cfg = dataclasses.replace(jax_config(learning_rate=1e-3),
                              data=jcfg.DataConfig(min_t=0.3))
    jt, params, opt_state, pt = make_pair(cfg)
    start = {k: v.detach().clone() for k, v in pt.model.state_dict().items()}
    batch = raw_batch(2, N_RES - 1, N_RES, 2, seed=72)
    key = jax.random.PRNGKey(73)
    mesh = jmesh.make_mesh((2, 4), ("data", "seq"))
    jsp = type(jt)(cfg, mesh=mesh)
    o = jax.tree_util.tree_map(jnp.asarray, opt_state)
    p, o, aux = jsp.compiled_train_step(o)(
        params, o, key, jmesh.shard_batch(
            mesh, jax.tree_util.tree_map(jnp.asarray, batch)))
    payload = tmp_path_factory.mktemp("jax_sp") / "payload.pt"
    torch.save(dict(
        state_dict=start,
        batches={k: torch.as_tensor(v)[None] for k, v in batch.items()},
        noises=[jax_batch_noise(key, 2, 2, N_RES, cfg)]), payload)
    want = state_dict_from_jax(to_numpy_tree(p), pt.cfg.model)
    return dict(cfg=cfg, pt=pt, start=start, aux=aux, want=want,
                payload=str(payload))


def _sp_step(jax_sp_step, out, nproc, shape, axes, batch_size):
    s = jax_sp_step
    return dp_step(nproc, out, overrides_of(s["pt"].cfg) + [
        "model.remat=true", f"experiment.batch_size={batch_size}",
        f"experiment.mesh_shape={shape}", f"experiment.mesh_axes={axes}"],
        "--steps", "1", "--payload", s["payload"])


def _assert_matches_jax(s, r0):
    np.testing.assert_allclose(r0["aux"][0]["total_loss"],
                               float(s["aux"]["total_loss"]), rtol=1e-4)
    np.testing.assert_allclose(r0["aux"][0]["grad_norm"],
                               float(s["aux"]["grad_norm"]), rtol=1e-3)
    assert_params_close(r0["params"], s["want"], s["start"],
                        s["cfg"].experiment.learning_rate, 1)


@pytest.fixture(scope="module")
def two_rank_sp(jax_sp_step, tmp_path_factory):
    return _sp_step(jax_sp_step, tmp_path_factory.mktemp("sp2"), 2, "(1,2)",
                    "(data,seq)", 2)


def test_two_rank_seq_step_matches_jax(jax_sp_step, two_rank_sp):
    r0, r1 = two_rank_sp
    assert r0["mesh"] == {"data": 1, "seq": 2}
    _assert_matches_jax(jax_sp_step, r0)
    assert_results_equal(r0, r1)  # the 'seq' ranks agree to the bit
    assert all(c > 0 for c in r0["sp_calls"])
    assert r0["sp_seconds"] == [None]  # not timed unless asked


def test_four_rank_data_seq_step_matches_jax(jax_sp_step, tmp_path):
    ranks = _sp_step(jax_sp_step, tmp_path, 4, "(2,2)", "(data,seq)", 1)
    assert ranks[0]["mesh"] == {"data": 2, "seq": 2}
    _assert_matches_jax(jax_sp_step, ranks[0])
    for r in ranks[1:]:
        assert_results_equal(ranks[0], r)


def test_seq_combines_with_model(jax_sp_step, two_rank_sp, tmp_path):
    """A ('data', 'seq', 'model') = (1, 2, 2) mesh: the 'model' ranks
    compute the same rows, so every rank equals the ('data', 'seq') run
    bit for bit."""
    ranks = _sp_step(jax_sp_step, tmp_path, 4, "(1,2,2)",
                     "(data,seq,model)", 2)
    assert ranks[0]["mesh"] == {"data": 1, "seq": 2, "model": 2}
    for r in ranks:
        assert_results_equal(r, two_rank_sp[0])
