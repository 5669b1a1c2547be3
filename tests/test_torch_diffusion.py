"""Diffusion of the PyTorch port (diffusion/igso3, so3, r3, se3) against
the JAX package. The IGSO(3) tables come from the same cache file, so they
are bit-identical. For the stochastic steps the test draws the noise the
JAX function draws (the same key split the same way) and hands it to the
port through its noise arguments.

Tolerances: float32 on both sides; the score series sums 100 terms, so
scores agree to 1e-4 relative; rotation vectors and translations to
5e-5 absolute at unit scale."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.diffusion import igso3 as jigso3
from dynamicpdb_tpu.diffusion.r3_diffuser import R3Config as JR3Config
from dynamicpdb_tpu.diffusion.se3_diffuser import SE3Config as JSE3Config
from dynamicpdb_tpu.diffusion.se3_diffuser import SE3Diffuser as JSE3
from dynamicpdb_tpu.diffusion.so3_diffuser import SO3Config as JSO3Config
from dynamicpdb_tpu.ops.rigid import Rigid as JRigid
from dynamicpdb_tpu_torch.diffusion import igso3 as tigso3
from dynamicpdb_tpu_torch.diffusion.r3_diffuser import R3Config
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Config, SE3Diffuser
from dynamicpdb_tpu_torch.diffusion.so3_diffuser import SO3Config
from dynamicpdb_tpu_torch.ops.rigid import Rigid as TRigid

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "igso3")
# the tracked small table (num_sigma=50, num_omega=100, L=100)
SMALL = dict(num_sigma=50, num_omega=100, series_L=100)
TABLE_KEYS = ("discrete_sigma", "discrete_omega", "pdf", "cdf", "score_norms",
              "score_scaling")


@pytest.mark.parametrize("kw", [
    dict(num_sigma=1000, num_omega=1000, L=1000),  # the release table
    dict(num_sigma=50, num_omega=100, L=100),
], ids=["release", "small"])
def test_igso3_tables_identical_from_one_cache_file(kw):
    path = tigso3.cache_path(CACHE, kw["num_sigma"], kw["num_omega"], 0.1,
                             1.5, "logarithmic", kw["L"])
    assert os.path.exists(path), path  # a hit, not a rebuild
    t = tigso3.build_tables(cache_dir=CACHE, device="cpu", **kw)
    j = jigso3.build_tables(cache_dir=CACHE, **kw)
    assert t.cache_hit and t.cache_file == path
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)


def test_igso3_build_on_cache_miss_matches_jax():
    kw = dict(num_sigma=8, num_omega=16, L=20)
    t = tigso3.build_tables(cache_dir=None, device="cpu", **kw)
    j = jigso3.build_tables(cache_dir=None, **kw)
    assert not t.cache_hit
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)


@pytest.fixture(scope="module")
def diffusers():
    so3 = dict(cache_dir=CACHE, **SMALL)
    j = JSE3(JSE3Config(so3=JSO3Config(**so3), r3=JR3Config()))
    t = SE3Diffuser(SE3Config(so3=SO3Config(**so3), r3=R3Config()), device="cpu")
    return j, t


def _rigids(seed, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tr = (5 * rng.normal(size=shape + (3,))).astype(np.float32)
    return np.concatenate([q, tr], -1)


T_VALUES = [1.0, 0.5, 0.12, 0.01]


@pytest.mark.parametrize("t", T_VALUES)
def test_so3_schedule_and_score(diffusers, t):
    j, tt = diffusers
    js, ts = j.so3d, tt.so3d
    np.testing.assert_allclose(ts.sigma(t).numpy(), np.asarray(js.sigma(t)),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.diffusion_coef(t).numpy(),
                               np.asarray(js.diffusion_coef(t)), rtol=1e-6)
    assert int(ts.t_to_idx(t)) == int(js.t_to_idx(t))
    np.testing.assert_allclose(ts.score_scaling(t).numpy(),
                               np.asarray(js.score_scaling(t)), rtol=1e-6)
    # rotation angles of the order of sigma(t), where the density lives; far
    # in its tail the float32 series cancels to rounding noise on both sides
    rng = np.random.default_rng(1)
    vec = (rng.normal(size=(2, 12, 3)) * float(js.sigma(t))).astype(np.float32)
    tf = np.asarray([t, t], np.float32)  # per-frame t
    np.testing.assert_allclose(
        ts.score(torch.as_tensor(vec), torch.as_tensor(tf)).numpy(),
        np.asarray(js.score(jnp.asarray(vec), jnp.asarray(tf))),
        rtol=1e-4, atol=1e-5)


def test_sample_ref_with_jax_noise(diffusers):
    j, t = diffusers
    key = jax.random.PRNGKey(3)
    shape = (2, 12)
    ref = j.sample_ref(key, shape)
    k_rot, k_trans = jax.random.split(key)
    k_axis, k_angle = jax.random.split(k_rot)
    noise = dict(
        rot_axis=torch.as_tensor(np.asarray(jax.random.normal(k_axis, shape + (3,)))),
        rot_u=torch.as_tensor(np.asarray(jax.random.uniform(k_angle, shape))),
        trans_z=torch.as_tensor(np.asarray(jax.random.normal(k_trans, shape + (3,)))),
    )
    got = t.sample_ref(shape, **noise).numpy()
    # quaternions equal up to sign
    sign = np.sign(np.sum(got[..., :4] * np.asarray(ref)[..., :4], -1,
                          keepdims=True))
    np.testing.assert_allclose(got[..., :4] * sign, np.asarray(ref)[..., :4],
                               atol=5e-5)
    np.testing.assert_allclose(got[..., 4:], np.asarray(ref)[..., 4:], atol=1e-6)


@pytest.mark.parametrize("t", T_VALUES[:3])
@pytest.mark.parametrize("masked", [False, True])
def test_se3_reverse_with_jax_noise(diffusers, t, masked):
    j, tt = diffusers
    r7 = _rigids(5)
    rng = np.random.default_rng(6)
    rot_score = rng.normal(size=(2, 12, 3)).astype(np.float32)
    trans_score = rng.normal(size=(2, 12, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 12)) > 0.25).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(11)
    out = j.reverse(key, JRigid.from_tensor_7(jnp.asarray(r7)),
                    jnp.asarray(rot_score), jnp.asarray(trans_score), t, 0.1,
                    diffuse_mask=None if mask is None else jnp.asarray(mask),
                    noise_scale=0.7)
    k_rot, k_trans = jax.random.split(key)
    got = tt.reverse(
        TRigid.from_tensor_7(torch.as_tensor(r7)), torch.as_tensor(rot_score),
        torch.as_tensor(trans_score), t, 0.1,
        diffuse_mask=None if mask is None else torch.as_tensor(mask),
        noise_scale=0.7,
        rot_z=torch.as_tensor(np.asarray(jax.random.normal(k_rot, (2, 12, 3)))),
        trans_z=torch.as_tensor(np.asarray(jax.random.normal(k_trans, (2, 12, 3)))),
    )
    jq, gq = np.asarray(out.quat), got.quat.numpy()
    sign = np.sign(np.sum(jq * gq, -1, keepdims=True))
    np.testing.assert_allclose(gq * sign, jq, atol=5e-5)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(out.trans),
                               atol=2e-5)


def test_r3_reverse_uncentred_and_so3_reverse_masked(diffusers):
    j, t = diffusers
    rng = np.random.default_rng(8)
    x = (3 * rng.normal(size=(2, 12, 3))).astype(np.float32)
    s = rng.normal(size=(2, 12, 3)).astype(np.float32)
    m = (rng.uniform(size=(2, 12)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(2)
    z = np.asarray(jax.random.normal(key, (2, 12, 3)))
    jx = j.r3d.reverse(key, jnp.asarray(x), jnp.asarray(s), 0.4, 0.1,
                       mask=jnp.asarray(m), center=False)
    tx = t.r3d.reverse(torch.as_tensor(x), torch.as_tensor(s), 0.4, 0.1,
                       mask=torch.as_tensor(m), center=False,
                       z=torch.as_tensor(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=2e-5)
    rot = (0.5 * rng.normal(size=(2, 12, 3))).astype(np.float32)
    jr = j.so3d.reverse(key, jnp.asarray(rot), jnp.asarray(s), 0.4, 0.1,
                        mask=jnp.asarray(m))
    tr = t.so3d.reverse(torch.as_tensor(rot), torch.as_tensor(s), 0.4, 0.1,
                        mask=torch.as_tensor(m), z=torch.as_tensor(z))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=5e-5)


def test_calc_scores(diffusers):
    j, t = diffusers
    a7, b7 = _rigids(9), _rigids(10)
    tf = np.asarray([0.3, 0.8], np.float32)
    ja, jb = JRigid.from_tensor_7(jnp.asarray(a7)), JRigid.from_tensor_7(jnp.asarray(b7))
    ta, tb = TRigid.from_tensor_7(torch.as_tensor(a7)), TRigid.from_tensor_7(torch.as_tensor(b7))
    np.testing.assert_allclose(
        t.calc_rot_score(ta.quat, tb.quat, torch.as_tensor(tf)).numpy(),
        np.asarray(j.calc_rot_score(ja.quat, jb.quat, jnp.asarray(tf))),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        t.calc_trans_score(ta.trans, tb.trans,
                           torch.as_tensor(tf)[:, None, None]).numpy(),
        np.asarray(j.calc_trans_score(ja.trans, jb.trans,
                                      jnp.asarray(tf)[:, None, None])),
        rtol=1e-5, atol=1e-5)


def test_cached_score_branch(diffusers):
    so3 = dict(cache_dir=CACHE, use_cached_score=True, **SMALL)
    j = JSE3(JSE3Config(so3=JSO3Config(**so3)))
    t = SE3Diffuser(SE3Config(so3=SO3Config(**so3)), device="cpu")
    vec = (np.random.default_rng(4).normal(size=(2, 12, 3)) * 0.7).astype(np.float32)
    tf = np.asarray([0.2, 0.9], np.float32)
    np.testing.assert_allclose(
        t.so3d.score(torch.as_tensor(vec), torch.as_tensor(tf)).numpy(),
        np.asarray(j.so3d.score(jnp.asarray(vec), jnp.asarray(tf))),
        rtol=1e-5, atol=1e-6)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SE3Diffuser(SE3Config(so3=SO3Config(cache_dir=CACHE, **SMALL)))
