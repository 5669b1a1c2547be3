"""The training slice of the PyTorch port against the JAX package, on the
CPU: forward diffusion with JAX's draws injected, the loss, the optimizer,
one train step's loss and gradients, a 5-step trajectory, gradient
accumulation, the unrolled loss, the dataset and samplers, and train_cli
with checkpoint, resume and serving.

Weights: a JAX init of a TINY model with every all-zero parameter re-drawn
(tests/test_torch_model.live_params), mapped by weights.state_dict_from_jax.
The noise of every step is drawn by JAX from its keys, split exactly as the
JAX trainer splits them, and handed to the port.

Tolerances, float32 on both sides:
  * diffusion and perturbation: 5e-5 at unit scale (tests/test_torch_diffusion);
  * loss values: 1e-4 relative, gradients 1e-3 of each gradient's largest
    magnitude: two IPA blocks of softmax, normalisation and convolutions
    compound the summation-order differences (the forward agrees to 2e-4
    of its scale, tests/test_torch_model), and the backward doubles the
    depth of the chain;
  * the optimizer: 1e-6 relative on float32 state (same operations, bias
    corrections computed in float32 on both sides); on bfloat16 state a
    moment may round to the neighbouring bf16 value (2^-8 relative) when
    the float32 arithmetic differs in its last bit, so 1e-2 of the
    learning rate per step;
  * 5 train steps: 1e-3 relative on the losses and gradient norms. On the
    parameters, AMSGrad normalises every element's step (the first is
    lr * sign(g)), so an element whose gradient sits at the rounding level
    of the two implementations steps +-lr at random in each (the k half of
    linear_kv's bias and linear_b's bias, whose gradients cancel in the
    softmax; an angle-embedder channel whose input is sin of a ~1e-6
    angle): every element within 2 lr per step of JAX's, and the update of
    the whole model within 2e-2 of the norm of JAX's update (measured
    7.1e-3)."""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynamicpdb_tpu import config as jcfg
from dynamicpdb_tpu.data import dataset as jdata
from dynamicpdb_tpu.data.featurize import diffuse_training_window as j_diffuse
from dynamicpdb_tpu.data.featurize import featurize_window as j_featurize
from dynamicpdb_tpu.data.featurize import perturb_conditioning_rigids as j_perturb
from dynamicpdb_tpu.data.synthetic import make_trajectory_npz as j_make_npz
from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.diffusion.se3_diffuser import SE3Diffuser as JSE3
from dynamicpdb_tpu.diffusion.so3_diffuser import SO3Config as JSO3Config
from dynamicpdb_tpu.ops.rigid import Rigid as JRigid
from dynamicpdb_tpu.train import optim as joptim
from dynamicpdb_tpu.train.experiment import Trainer as JTrainer
from dynamicpdb_tpu.train.losses import dfold_loss as j_dfold_loss
from dynamicpdb_tpu_torch import config as pcfg
from dynamicpdb_tpu_torch import serve_cli, train_cli
from dynamicpdb_tpu_torch.data import dataset as pdata
from dynamicpdb_tpu_torch.data.featurize import diffuse_training_window
from dynamicpdb_tpu_torch.data.featurize import featurize_window
from dynamicpdb_tpu_torch.data.featurize import perturb_conditioning_rigids
from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.ops.rigid import Rigid
from dynamicpdb_tpu_torch.train import checkpoint as pckpt
from dynamicpdb_tpu_torch.train import optim as poptim
from dynamicpdb_tpu_torch.train.experiment import Trainer
from dynamicpdb_tpu_torch.train.losses import dfold_loss
from dynamicpdb_tpu_torch.weights import state_dict_from_jax
from tests.test_model import TINY_MODEL
from tests.test_torch_model import live_params, to_numpy_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "igso3")
# the tracked small IGSO3 table: identical tables on both sides
J_SE3 = jcfg.SE3Config(so3=JSO3Config(num_omega=100, num_sigma=50,
                                      series_L=100, cache_dir=CACHE))
MIN_T = 0.01


def to_port(cls, jax_obj):
    """The port's config dataclass holding the same values."""
    return pcfg._from_dict(cls, dataclasses.asdict(jax_obj))


def jax_config(**experiment):
    return jcfg.Config(
        data=jcfg.DataConfig(min_t=MIN_T), diffuser=J_SE3, model=TINY_MODEL,
        experiment=jcfg.ExperimentConfig(**experiment))


def tensors(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the JAX trainer's draws, split as Trainer._one_step_loss splits its key
# ---------------------------------------------------------------------------
def jax_step_noise(key, F, N, cfg):
    k_diff, k_sc, k_drop = jax.random.split(key, 3)
    k_t, k_fm = jax.random.split(k_diff)
    k_rot, k_trans = jax.random.split(k_fm)
    k_axis, k_angle = jax.random.split(k_rot)
    noise = {
        "t": jax.random.uniform(k_t, (), minval=cfg.data.min_t, maxval=1.0),
        "rot_axis": jax.random.normal(k_axis, (F, N, 3)),
        "rot_u": jax.random.uniform(k_angle, (F, N)),
        "trans_z": jax.random.normal(k_trans, (F, N, 3)),
    }
    if cfg.model.cfg_drop_rate > 0:
        noise["drop"] = (jax.random.uniform(k_drop)
                         < cfg.model.cfg_drop_rate).astype(jnp.float32)
    if cfg.model.embed.embed_self_conditioning:
        noise["sc"] = jax.random.uniform(k_sc)
    ec = cfg.experiment
    out = {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}
    if ec.cond_noise_trans > 0 or ec.cond_noise_rot_deg > 0:
        k_u, k_r, k_tr = jax.random.split(jax.random.fold_in(key, 0x5E3), 3)
        out["cond"] = {
            "u": torch.as_tensor(np.array(jax.random.uniform(k_u, ()))),
            "rot": torch.as_tensor(np.array(jax.random.normal(k_r, (F, N, 3)))),
            "trans": torch.as_tensor(np.array(
                jax.random.normal(k_tr, (F, N, 3)))),
        }
    return out


def jax_batch_noise(key, B, F_raw, N, cfg):
    unroll = cfg.experiment.unroll_steps
    out = []
    for k in jax.random.split(key, B):
        if unroll > 1:
            F = F_raw - (unroll - 1)
            out.append([jax_step_noise(ks, F, N, cfg)
                        for ks in jax.random.split(k, unroll)])
        else:
            out.append(jax_step_noise(k, F_raw, N, cfg))
    return out


def raw_batch(B, n_real, pad_to, frame_time, seed):
    ws = [jdata.pad_window(make_window(n_res=n_real, frame_time=frame_time,
                                       seed=seed + b, rot_wiggle=0.1), pad_to)
          for b in range(B)]
    return {k: np.stack([w[k] for w in ws]) for k in ws[0]}


# ---------------------------------------------------------------------------
# forward diffusion
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def diffusers():
    return JSE3(J_SE3), SE3Diffuser(to_port(pcfg.SE3Config, J_SE3),
                                    device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_se3_forward_marginal_with_jax_draws(diffusers, masked):
    jd, td = diffusers
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r7 = np.concatenate([q, 5 * rng.normal(size=(2, 9, 3))], -1)
    r7 = r7.astype(np.float32)
    mask = (rng.uniform(size=(2, 9)) > 0.3).astype(np.float32) if masked else None
    key, t = jax.random.PRNGKey(3), 0.37
    want = jd.forward_marginal(key, JRigid.from_tensor_7(jnp.asarray(r7)), t,
                               diffuse_mask=None if mask is None
                               else jnp.asarray(mask))
    k_rot, k_trans = jax.random.split(key)
    k_axis, k_angle = jax.random.split(k_rot)
    got = td.forward_marginal(
        Rigid.from_tensor_7(torch.as_tensor(r7)), t,
        diffuse_mask=None if mask is None else torch.as_tensor(mask),
        rot_axis=torch.as_tensor(np.array(jax.random.normal(k_axis, (2, 9, 3)))),
        rot_u=torch.as_tensor(np.array(jax.random.uniform(k_angle, (2, 9)))),
        trans_z=torch.as_tensor(np.array(jax.random.normal(k_trans, (2, 9, 3)))))
    for k in ("rigids_t", "rot_score", "trans_score", "rot_score_scaling",
              "trans_score_scaling"):
        w = np.asarray(want[k])
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, atol=5e-5 * scale,
                                   err_msg=k)


def test_diffuse_training_window_and_perturbation_with_jax_draws(diffusers):
    jd, td = diffusers
    cfg = jax_config(cond_noise_trans=0.5, cond_noise_rot_deg=10.0)
    w = make_window(n_res=11, frame_time=3, seed=4, rot_wiggle=0.1)
    jfeats = j_featurize(jax.tree_util.tree_map(jnp.asarray, w))
    key = jax.random.PRNGKey(5)
    noise = jax_step_noise(key, 3, 11, cfg)
    k_diff = jax.random.split(key, 3)[0]

    jr0 = j_perturb(jax.random.fold_in(key, 0x5E3), jfeats["rigids_0"], 0.5,
                    10.0 * jnp.pi / 180.0)
    want = j_diffuse(k_diff, dict(jfeats, rigids_0=jr0), jd, MIN_T)

    tfeats = featurize_window(tensors(w))
    tr0 = perturb_conditioning_rigids(tfeats["rigids_0"], 0.5,
                                      10.0 * math.pi / 180.0,
                                      noise=noise["cond"])
    got = diffuse_training_window(dict(tfeats, rigids_0=tr0), td, MIN_T,
                                  noise=noise)
    for k in ("rigids_0", "rigids_t", "rot_score", "trans_score", "t",
              "rot_score_scaling", "trans_score_scaling"):
        want_k = np.asarray(want[k])
        scale = max(1.0, float(np.abs(want_k).max()))
        np.testing.assert_allclose(got[k].numpy(), want_k, atol=5e-5 * scale,
                                   err_msg=k)
    # the target frame stays clean
    np.testing.assert_array_equal(tr0[-1].numpy(), tfeats["rigids_0"][-1].numpy())


def test_draws_from_a_generator_are_seeded(diffusers):
    _, td = diffusers
    feats = featurize_window(tensors(make_window(n_res=6, frame_time=2, seed=1)))
    a, b = (diffuse_training_window(feats, td, MIN_T,
                                    generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    torch.testing.assert_close(a["rigids_t"], b["rigids_t"], rtol=0, atol=0)
    assert MIN_T <= float(a["t"][0]) <= 1.0


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["normal", "outlier", "t_threshold"])
def test_dfold_loss_matches_jax(diffusers, case):
    jd, _ = diffusers
    conf = jcfg.ExperimentConfig(
        rot_loss_t_threshold=0.5 if case == "t_threshold" else 0.0)
    w = jdata.pad_window(make_window(n_res=9, frame_time=2, seed=6), 12)
    feats = j_diffuse(jax.random.PRNGKey(7),
                      j_featurize(jax.tree_util.tree_map(jnp.asarray, w)),
                      jd, MIN_T)
    if case == "t_threshold":
        feats["t"] = jnp.full_like(feats["t"], 0.3)
    rng = np.random.default_rng(8)
    trans_noise = 3.0 if case == "outlier" else 0.3  # >= 1 A^2: guard fires
    out = {
        "rigids": np.asarray(feats["rigids_0"]) + np.concatenate(
            [0.05 * rng.normal(size=(2, 12, 4)),
             trans_noise * rng.normal(size=(2, 12, 3))], -1),
        "angles": rng.normal(size=(2, 12, 7, 2)),
        "rot_score": rng.normal(size=(2, 12, 3)),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    want, want_aux = j_dfold_loss(
        jax.tree_util.tree_map(jnp.asarray, out), feats, conf)
    got, got_aux = dfold_loss(tensors(out), tensors(feats),
                              to_port(pcfg.ExperimentConfig, conf))
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if case == "outlier":
        assert float(got_aux["trans_loss"]) == 0.0
        assert float(got_aux["rot_loss"]) == 0.0
        assert float(got_aux["torsion_loss"]) > 0.0
    if case == "t_threshold":
        assert float(got_aux["rot_loss"]) == 0.0


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
OPT_CASES = {
    "optax-f32": dict(),
    "optax-bf16": dict(opt_state_dtype="bfloat16"),
    "torch-f32": dict(amsgrad_formulation="torch"),
    "torch-bf16": dict(amsgrad_formulation="torch",
                       opt_state_dtype="bfloat16"),
    "clip-ema-cosine": dict(grad_clip_norm=1.5, ema_decay=0.9,
                            warmup_steps=3, lr_schedule="cosine",
                            lr_decay_steps=8),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_jax_over_10_steps(case):
    ec = jcfg.ExperimentConfig(learning_rate=1e-2, **OPT_CASES[case])
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # gradients whose scale jumps and drifts, so the AMSGrad max moves
    grads = [{k: (rng.normal(size=s) * (1.0 + 3.0 * (i % 4 == 2))
                  ).astype(np.float32) for k, s in shapes.items()}
             for i in range(10)]

    opt = joptim.make_optimizer(ec)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
               for k, v in p0.items()}
    topt = poptim.make_optimizer(list(tparams.values()),
                                 to_port(pcfg.ExperimentConfig, ec))
    bf16 = ec.opt_state_dtype == "bfloat16"
    for i, g in enumerate(grads):
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
        for k, p in tparams.items():
            atol = 1e-2 * ec.learning_rate * (i + 1) if bf16 else 1e-7
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=atol, err_msg=f"step {i} {k}")
    if ec.ema_decay is not None:
        ema = joptim.ema_params(state)
        for k, p in tparams.items():
            np.testing.assert_allclose(topt.state[p]["ema"].numpy(),
                                       np.asarray(ema[k]), rtol=1e-6,
                                       atol=1e-7)
    if bf16:
        assert all(topt.state[p]["mu"].dtype == torch.bfloat16
                   for p in tparams.values())


def test_lr_schedules_match_optax():
    for kw in (dict(warmup_steps=5), dict(lr_schedule="cosine",
                                          lr_decay_steps=20),
               dict(lr_schedule="cosine", warmup_steps=4, lr_decay_steps=20)):
        ec = jcfg.ExperimentConfig(learning_rate=3e-4, **kw)
        want = joptim.make_lr_schedule(ec)
        got = poptim.make_lr_schedule(to_port(pcfg.ExperimentConfig, ec))
        for count in range(0, 30):
            # optax evaluates in float32: 1 + cos(x) near x = pi keeps few
            # significant bits, so compare to 1e-6 of the peak rate
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=0, atol=1e-6 * 3e-4, err_msg=kw)
    assert poptim.make_lr_schedule(pcfg.ExperimentConfig()) == 1e-4
    with pytest.raises(ValueError, match="lr_decay_steps"):
        poptim.make_lr_schedule(pcfg.ExperimentConfig(
            lr_schedule="cosine", warmup_steps=10, lr_decay_steps=10))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def make_pair(jax_cfg, params_seed=7):
    """A JAX trainer with live params and the port's trainer holding the
    same params; returns (jax trainer, params, opt_state, port trainer)."""
    jt = JTrainer(jax_cfg)
    w = make_window(n_res=10, frame_time=jax_cfg.data.frame_time, seed=0)
    params, _ = jt.init_params(jax.random.PRNGKey(0), w)
    params = live_params(params, params_seed)
    opt_state = jt.optimizer.init(params)
    pt = Trainer(to_port(pcfg.Config, jax_cfg), device="cpu")
    mcfg = pt.cfg.model
    pt.model.load_state_dict(state_dict_from_jax(to_numpy_tree(params), mcfg),
                             strict=True)
    return jt, params, opt_state, pt


def assert_grads_close(pt, jax_grads, rel=1e-3):
    """Each gradient to ``rel`` of its largest magnitude, floored at 1e-6 of
    the model's largest gradient: a gradient whose true value is 0 (the
    linear_b bias adds one constant to every logit of a row, which the
    softmax cancels) is rounding noise on both sides."""
    want = state_dict_from_jax(to_numpy_tree(jax_grads), pt.cfg.model)
    floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
    for name, p in pt.model.named_parameters():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(w).max()), floor / rel)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0,
                                   err_msg=name)


def test_one_train_step_loss_and_every_gradient_match_jax():
    cfg = jax_config()
    jt, params, _, pt = make_pair(cfg)
    batch = raw_batch(2, 8, 10, 2, seed=11)
    key = jax.random.PRNGKey(12)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        params, key, jax.tree_util.tree_map(jnp.asarray, batch))
    noises = jax_batch_noise(key, 2, 2, 10, cfg)
    got_loss, got_aux = pt.loss_and_grads(batch, noises)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-4)
    for k in aux:
        np.testing.assert_allclose(float(got_aux[k]), float(aux[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert_grads_close(pt, grads)
    # the IPA projections train: nonzero gradients through the Function
    for n in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points",
              "linear_b", "down_z"):
        g = pt.model.get_parameter(f"score_model.trunk.ipa_0.{n}.weight").grad
        assert float(g.abs().max()) > 0, n


def test_loss_with_cfg_drop_self_conditioning_and_cond_noise_matches_jax():
    """cfg_drop_rate = 1 (every window drops its conditioning: drop_ref),
    self-conditioning (its extra forward on a coin flip) and the
    conditioning-rigid noise, all from JAX's keys."""
    cfg = jax_config(cond_noise_trans=0.3, cond_noise_rot_deg=5.0)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        TINY_MODEL, cfg_drop_rate=1.0, embed=dataclasses.replace(
            TINY_MODEL.embed, embed_self_conditioning=True)))
    jt, params, _, pt = make_pair(cfg)
    batch = raw_batch(3, 8, 10, 2, seed=60)
    key = jax.random.PRNGKey(61)
    loss, aux = jax.jit(jt.loss_fn)(params, key,
                                    jax.tree_util.tree_map(jnp.asarray, batch))
    noises = jax_batch_noise(key, 3, 2, 10, cfg)
    assert all(float(n["drop"]) == 1.0 for n in noises)
    with torch.no_grad():
        got = [pt.window_loss({k: torch.as_tensor(batch[k][b])
                               for k in batch}, n)
               for b, n in enumerate(noises)]
    np.testing.assert_allclose(float(torch.stack([g[0] for g in got]).mean()),
                               float(loss), rtol=1e-4)
    for k in aux:
        np.testing.assert_allclose(
            float(torch.stack([g[1][k] for g in got]).mean()), float(aux[k]),
            rtol=1e-4, atol=1e-6, err_msg=k)


def test_five_train_steps_match_jax():
    cfg = jax_config(learning_rate=1e-3)
    jt, params, opt_state, pt = make_pair(cfg)
    start = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    step = jax.jit(jt.train_step)
    losses_j, losses_t = [], []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(21), 5)):
        batch = raw_batch(2, 8, 10, 2, seed=30 + 2 * i)
        params, opt_state, aux = step(
            params, opt_state, key, jax.tree_util.tree_map(jnp.asarray, batch))
        taux = pt.train_step(batch, jax_batch_noise(key, 2, 2, 10, cfg))
        losses_j.append(float(aux["total_loss"]))
        losses_t.append(taux["total_loss"])
        np.testing.assert_allclose(taux["grad_norm"], float(aux["grad_norm"]),
                                   rtol=1e-3, err_msg=f"step {i}")
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    want = state_dict_from_jax(to_numpy_tree(params), pt.cfg.model)
    lr = cfg.experiment.learning_rate
    diff2 = norm2 = 0.0
    for name, p in pt.model.named_parameters():
        got = p.detach()
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * lr * 5, err_msg=name)
        want_update = want[name] - start[name]
        diff2 += float((got - want[name]).pow(2).sum())
        norm2 += float(want_update.pow(2).sum())
    assert math.sqrt(diff2) <= 2e-2 * math.sqrt(norm2)


def test_grad_accum_gives_the_full_batch_update():
    cfg = to_port(pcfg.Config, jax_config())
    batch = raw_batch(4, 8, 10, 2, seed=40)
    noises = jax_batch_noise(jax.random.PRNGKey(41), 4, 2, 10, jax_config())
    out = []
    for accum in (1, 2):
        t = Trainer(dataclasses.replace(cfg, experiment=dataclasses.replace(
            cfg.experiment, grad_accum=accum)), device="cpu")
        aux = t.train_step(batch, noises)
        out.append((aux, {n: p.detach().clone()
                          for n, p in t.model.named_parameters()}))
    np.testing.assert_allclose(out[1][0]["total_loss"], out[0][0]["total_loss"],
                               rtol=1e-6)
    for n in out[0][1]:
        torch.testing.assert_close(out[1][1][n], out[0][1][n], rtol=0,
                                   atol=1e-7)
    t = Trainer(dataclasses.replace(cfg, experiment=dataclasses.replace(
        cfg.experiment, grad_accum=3)), device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        t.train_step(batch, noises)


def test_unrolled_loss_matches_jax():
    """t is drawn from [0.3, 1]: at small t (sigma ~ 0.1) and rotation
    errors near 1 rad, the float32 IGSO3 series score cancels far below
    float32 resolution, so the fed-back step's rotation terms are rounding
    noise in both packages (JAX's own loss moves by 0.3% when the fed-back
    rigid moves by 1e-7). The one-step tests cover min_t = 0.01."""
    cfg = dataclasses.replace(
        jax_config(unroll_steps=2),
        data=jcfg.DataConfig(min_t=0.3, frame_time=3))
    jt, params, _, pt = make_pair(cfg)
    batch = raw_batch(2, 8, 10, 3, seed=50)
    key = jax.random.PRNGKey(51)
    loss, aux = jax.jit(jt.loss_fn)(params, key,
                                    jax.tree_util.tree_map(jnp.asarray, batch))
    with torch.no_grad():
        got = [pt.window_loss({k: torch.as_tensor(batch[k][b])
                               for k in batch}, n)[0]
               for b, n in enumerate(jax_batch_noise(key, 2, 3, 10, cfg))]
    np.testing.assert_allclose(float(torch.stack(got).mean()), float(loss),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifest")
    rows = []
    for i, (name, n) in enumerate((("1abc", 8), ("2def", 10), ("3ghi", 8),
                                   ("4jkl", 12), ("5mno", 40))):
        path = str(d / f"{name}.npz")
        make_trajectory_npz(path, n_res=n, n_frames=6, seed=i)
        rows.append(f"{name},{path},{n}")
    csv = d / "train.csv"
    csv.write_text("name,atlas_npz,seq_len\n" + "\n".join(rows) + "\n")
    clusters = d / "clusters.txt"
    clusters.write_text("1abc_A 3ghi_B\n2def_A\n")
    return str(csv), str(clusters)


def test_synthetic_bundle_is_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    make_trajectory_npz(a, n_res=7, n_frames=4, seed=3)
    j_make_npz(b, n_res=7, n_frames=4, seed=3)
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("mode", ["time_batch", "length_batch",
                                  "cluster_time_batch", "cluster_length_batch"])
def test_dataset_and_samplers_match_jax(manifest, mode):
    csv, clusters = manifest
    jc = jcfg.DataConfig(csv_path=csv, frame_time=2, sample_mode=mode,
                         cluster_path=clusters,
                         filtering=jcfg.FilteringConfig(max_len=16))
    pc = to_port(pcfg.DataConfig, jc)
    jds = jdata.TrajectoryDataset(jc, pad_to=16)
    pds = pdata.TrajectoryDataset(pc, pad_to=16)
    assert len(pds) == len(jds) == 4  # the 40-residue row is filtered out
    js = jdata.make_sampler(jds, jc, batch_size=2, seed=3)
    ps = pdata.make_sampler(pds, pc, batch_size=2, seed=3)
    for epoch in (0, 1):
        np.testing.assert_array_equal(ps.epoch_indices(epoch),
                                      js.epoch_indices(epoch))
        jb = list(jdata.batch_iterator(jds, js, epoch))
        pb = list(pdata.batch_iterator(pds, ps, epoch))
        assert len(pb) == len(jb)
        for a, b in zip(pb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_val_split_windows_and_bad_modes(manifest):
    csv, _ = manifest
    jc = jcfg.DataConfig(csv_path=csv, frame_time=3, fix_sample_start=2,
                         filtering=jcfg.FilteringConfig(max_len=16))
    jds = jdata.TrajectoryDataset(jc, split="val")
    pds = pdata.TrajectoryDataset(to_port(pcfg.DataConfig, jc), split="val")
    for i in range(len(pds)):
        a = pds.get_window(i, np.random.default_rng(0))
        b = jds.get_window(i, np.random.default_rng(0))
        assert a.pop("name") == b.pop("name")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="sample_mode"):
        pdata.EpochSampler(n_items=3, batch_size=2, sample_mode="nope")
    with pytest.raises(ValueError, match="cluster_path"):
        pdata.make_sampler(pds, pcfg.DataConfig(sample_mode="cluster_time_batch"),
                           batch_size=2)


# ---------------------------------------------------------------------------
# train_cli: train, checkpoint, resume, serve
# ---------------------------------------------------------------------------
TINY_ARGS = [
    "--config", os.path.join(ROOT, "configs", "tiny.yaml"), "--pad-to", "12",
    "--device", "cpu", "model.node_repr_dim=256", "model.edge_repr_dim=128",
    "model.remat=true", "experiment.batch_size=2", "experiment.log_freq=1",
    "data.filtering.max_len=12",
    f"diffuser.so3.cache_dir={CACHE}",
]


def test_train_cli_checkpoint_resume_and_serve(manifest, tmp_path):
    csv, _ = manifest
    args = TINY_ARGS + [f"data.csv_path={csv}",
                        f"experiment.ckpt_dir={tmp_path / 'ckpt'}",
                        f"experiment.eval_dir={tmp_path / 'eval'}"]
    exp = train_cli.main(["--max-steps", "2"] + args)
    assert exp.step == 2
    path = str(tmp_path / "ckpt" / "step_2.ckpt")
    assert os.path.exists(path)
    assert all(np.isfinite(m["total_loss"]) and np.isfinite(m["grad_norm"])
               for m in exp.step_metrics)
    with open(tmp_path / "eval" / "logs" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2  # log_freq=1

    resumed = train_cli.main(["--max-steps", "3", "--resume"] + args)
    assert resumed.step == 3 and len(resumed.step_metrics) == 1
    assert os.path.exists(tmp_path / "ckpt" / "step_3.ckpt")
    # the resumed optimizer carries the saved state: same count, moments
    st = resumed.trainer.optimizer
    assert st.param_groups[0]["count"] == 3

    sargs = serve_cli.parse_args(
        ["--ckpt", str(tmp_path / "ckpt" / "step_3.ckpt"), "--device", "cpu",
         "--pad-to", "12", "--config", os.path.join(ROOT, "configs",
                                                    "tiny.yaml"),
         "model.node_repr_dim=256", "model.edge_repr_dim=128",
         f"diffuser.so3.cache_dir={CACHE}"])
    service = serve_cli.service_from_args(sargs)
    assert service.step == 3
    w = make_window(n_res=9, frame_time=2, seed=2)
    out = service.extend({k: w[k] for k in serve_cli.RAW_KEYS}, n_steps=2,
                         fast_x0=True)
    assert out["atom_traj"].shape == (2, 9, 37, 3)
    assert np.isfinite(out["atom_traj"]).all()


def test_train_cli_eval_every_logs_and_keeps_best(manifest, tmp_path):
    """--eval-every 1: one epoch with an eval pass over the val split logs
    every eval/* metric and keeps a best checkpoint."""
    csv, _ = manifest
    exp = train_cli.main(
        ["--eval-every", "1"] + TINY_ARGS
        + [f"data.csv_path={csv}", "experiment.num_epoch=1",
           f"experiment.ckpt_dir={tmp_path / 'ckpt'}",
           f"experiment.eval_dir={tmp_path / 'eval'}"])
    assert exp.epoch == 1 and exp.step > 0
    assert sorted(exp.best) == sorted(train_cli.EVAL_METRICS)
    with open(tmp_path / "eval" / "logs" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "eval/ave_rot" in r]
    assert len(evals) == 1 and evals[0]["step"] == exp.step
    for k in train_cli.EVAL_METRICS:
        assert math.isfinite(evals[0][f"eval/{k}"])
        assert evals[0][f"eval/{k}"] == exp.best[k]
    best = pckpt.load(str(tmp_path / "ckpt" / "best.ckpt"))
    assert best["step"] == exp.step
