"""The rest of the port's sampling against the JAX package, on the CPU:
``sampling/reverse.batched_rollout`` and ``sampling/picard``.

Weights: a JAX init of the TINY model (tests/test_model.py) with every
all-zero parameter re-drawn (tests/test_torch_model.live_params), carried
to the port by ``weights.state_dict_from_jax``; windows featurized and
initialised by JAX and handed to the port as they are.

Tolerances: between the two packages, coordinates (predicted frames, the
reverse chain, Picard's sweep deltas) 2e-4 of their scale, the forward's
bar (tests/test_torch_model.py). Within the port, ``batched_rollout``
against per-window ``rollout`` and Picard's fixed point against
``reverse_sample`` run the same operations on the same inputs, so they
are held to 1e-6 of the scale. The early-stopped Picard run is held to the
sequential sampler within 5e-3, the JAX package's own bar
(tests/test_picard.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.data.dataset import pad_window
from dynamicpdb_tpu.data.featurize import eval_init_window, featurize_window
from dynamicpdb_tpu.data.synthetic import make_window
from dynamicpdb_tpu.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu.sampling import picard as jpicard
from dynamicpdb_tpu.sampling import reverse as jrev
from dynamicpdb_tpu_torch import config as port_config
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser as TSE3
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork as TNet
from dynamicpdb_tpu_torch.sampling import picard as ppicard
from dynamicpdb_tpu_torch.sampling import reverse as prev
from dynamicpdb_tpu_torch.weights import state_dict_from_jax
from tests.test_model import TINY_MODEL, TINY_SE3
from tests.test_torch_model import live_params, port_cfg, to_numpy_tree

torch.set_num_threads(1)

COORD_REL = 2e-4
SAME_REL = 1e-6


def _close(got, want, rel=COORD_REL, err_msg=""):
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


def _rigids_close(got, want, rel=COORD_REL, err_msg=""):
    """Tensor-7 frames: the quaternion up to its sign, then translation."""
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    sign = np.sign(np.sum(got[..., :4] * want[..., :4], -1, keepdims=True))
    _close(got[..., :4] * sign, want[..., :4], rel, err_msg)
    _close(got[..., 4:], want[..., 4:], rel, err_msg)


def _window_feats(diffuser, key, n_res, seed, pad_to=10):
    w = pad_window(make_window(n_res=n_res, frame_time=2, seed=seed,
                               rot_wiggle=0.1), pad_to)
    feats = featurize_window(jax.tree_util.tree_map(jnp.asarray, w))
    return eval_init_window(key, feats, diffuser)


@pytest.fixture(scope="module")
def setup():
    diffuser = SE3Diffuser(TINY_SE3)
    model = DFoldScoreNetwork(TINY_MODEL)
    feats = [_window_feats(diffuser, jax.random.PRNGKey(i), n, i)
             for i, n in enumerate((10, 8, 9))]
    params = live_params(jax.jit(model.init)(jax.random.PRNGKey(0),
                                             feats[0]), 11)
    mcfg = port_cfg(port_config.ModelConfig, TINY_MODEL)
    net = TNet(mcfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(params), mcfg),
                        strict=True)
    tdiff = TSE3(port_cfg(port_config.SE3Config, TINY_SE3), device="cpu")
    return dict(diffuser=diffuser, model=model, params=params, feats=feats,
                net=net, tdiff=tdiff)


def _torch(feats):
    return {k: torch.as_tensor(np.array(v)) for k, v in feats.items()}


def _stacked(feats):
    return {k: torch.stack([torch.as_tensor(np.array(f[k])) for f in feats])
            for k in feats[0]}


# ---------------------------------------------------------------------------
# batched_rollout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fast_x0", [False, True], ids=["full", "fast_x0"])
def test_batched_rollout_equals_per_window_rollout(setup, fast_x0):
    """Window b of the batch is rollout on window b with the generator
    window_generators(seed, B)[b]: the same trajectory."""
    net, tdiff = setup["net"], setup["tdiff"]
    batch = _stacked(setup["feats"])
    kw = dict(n_steps=2, num_t=3, noise_scale=0.1, fast_x0=fast_x0)
    atoms, rigids = prev.batched_rollout(net, tdiff, batch, seed=5, **kw)
    B, N = len(setup["feats"]), batch["res_mask"].shape[-1]
    assert atoms.shape == (B, 2, N, 37, 3) and rigids.shape == (B, 2, N, 7)
    gens = prev.window_generators(5, B, "cpu")
    for b in range(B):
        a, r = prev.rollout(net, tdiff, {k: v[b] for k, v in batch.items()},
                            generator=gens[b], **kw)
        _close(atoms[b], a, SAME_REL, f"window {b}")
        _close(rigids[b], r, SAME_REL, f"window {b}")
    # the windows' conditioning differs, so their trajectories do
    assert float((rigids[0] - rigids[1]).abs().max()) > 1e-2


def test_window_generators_are_seeded_per_window():
    a = [torch.rand(3, generator=g) for g in prev.window_generators(1, 3,
                                                                    "cpu")]
    b = [torch.rand(3, generator=g) for g in prev.window_generators(1, 3,
                                                                    "cpu")]
    c = [torch.rand(3, generator=g) for g in prev.window_generators(2, 3,
                                                                    "cpu")]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


def test_batched_rollout_matches_jax(setup):
    """The returned frames do not depend on the sampler's noise (the
    network predicts x0 from the clean reference frames), so the port's
    batch equals JAX's under any keys and generators."""
    feats = setup["feats"]
    fb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *feats)
    model, diffuser = setup["model"], setup["diffuser"]
    want = jax.jit(lambda k, p, f: jrev.batched_rollout(
        k, model, p, diffuser, f, n_steps=2, num_t=3, noise_scale=0.1))(
            jax.random.PRNGKey(9), setup["params"], fb)
    got = prev.batched_rollout(setup["net"], setup["tdiff"], _stacked(feats),
                               n_steps=2, num_t=3, noise_scale=0.1)
    _close(got[0], want[0], err_msg="atom37_traj")
    _rigids_close(got[1], want[1], err_msg="rigid_traj")


# ---------------------------------------------------------------------------
# Picard
# ---------------------------------------------------------------------------
def _spy(diffuser, chain):
    """Record every reverse step's output frames (tensor-7) in ``chain``;
    returns a function that removes the spy."""
    orig = diffuser.reverse

    def reverse(*a, **k):
        out = orig(*a, **k)
        chain.append(out.to_tensor_7())
        return out

    diffuser.reverse = reverse
    return lambda: delattr(diffuser, "reverse")


def test_picard_converges_to_reverse_sample_in_t_minus_1_sweeps(setup):
    """tol 0, max_sweeps T-1: the generator's draws taken up front in
    reverse_sample's order give its chain and its prediction."""
    net, tdiff = setup["net"], setup["tdiff"]
    feats = _torch(setup["feats"][0])
    num_t = 6
    seq_chain, par_chain = [], []
    undo = _spy(tdiff, seq_chain)
    try:
        seq = prev.reverse_sample(net, tdiff, feats, num_t=num_t,
                                  noise_scale=0.1,
                                  generator=torch.Generator().manual_seed(4))
    finally:
        undo()
    undo = _spy(tdiff, par_chain)
    try:
        par = ppicard.picard_reverse_sample(
            net, tdiff, feats, num_t=num_t, noise_scale=0.1, tol=0.0,
            max_sweeps=num_t - 1, generator=torch.Generator().manual_seed(4))
    finally:
        undo()
    assert par["n_sweeps"] == num_t - 1
    assert len(par_chain) == (num_t - 1) ** 2
    # the last sweep's steps are the sequential chain
    for k, (p, s) in enumerate(zip(par_chain[-(num_t - 1):], seq_chain)):
        _close(p, s, SAME_REL, f"step {k}")
    for key in ("rigids", "atom37", "atom14", "angles"):
        _close(par[key], seq[key], SAME_REL, key)


def test_picard_tolerance_stopping_is_wavefront_limited(setup):
    """The reverse Euler-Maruyama map is not a strong contraction: at a
    tight tolerance the sweeps run to T-1, and the result matches the
    sequential sampler."""
    net, tdiff = setup["net"], setup["tdiff"]
    feats = _torch(setup["feats"][1])
    num_t = 8
    noise = ppicard.draw_reverse_noise(tdiff, feats["rigids_t"].shape[:-1],
                                       num_t, torch.Generator().manual_seed(6))
    seq = prev.reverse_sample(net, tdiff, feats, num_t=num_t, noise_scale=0.1,
                              noise=noise)
    par = ppicard.picard_reverse_sample(net, tdiff, feats, num_t=num_t,
                                        noise_scale=0.1, tol=1e-4,
                                        noise=noise)
    assert par["n_sweeps"] == num_t - 1
    _close(par["rigids"], seq["rigids"], 5e-3)
    _close(par["atom37"], seq["atom37"], 5e-3)


def test_picard_stops_at_the_tolerance(setup):
    """A tolerance above the sweeps' changes stops after the first sweep,
    and max_sweeps caps the count."""
    net, tdiff = setup["net"], setup["tdiff"]
    feats = _torch(setup["feats"][0])
    g = torch.Generator().manual_seed(0)
    one = ppicard.picard_reverse_sample(net, tdiff, feats, num_t=4, tol=1e9,
                                        generator=g)
    assert one["n_sweeps"] == 1 and float(one["sweep_delta"]) > 0
    two = ppicard.picard_reverse_sample(net, tdiff, feats, num_t=6, tol=0.0,
                                        max_sweeps=2, generator=g)
    assert two["n_sweeps"] == 2
    with pytest.raises(ValueError, match="noise has 2 steps"):
        ppicard.picard_reverse_sample(net, tdiff, feats, num_t=4,
                                      noise=[(None, None)] * 2)


def _jax_spy(diffuser, chain):
    """Record every JAX reverse step's output frames (tensor-7 as numpy) in
    ``chain`` through an ordered debug callback: inside Picard's vmapped
    sweep it runs once per step, in step order, sweep after sweep."""
    orig = diffuser.reverse

    def reverse(*a, **k):
        out = orig(*a, **k)
        jax.debug.callback(lambda x: chain.append(np.array(x)),
                           out.to_tensor_7(), ordered=True)
        return out

    diffuser.reverse = reverse
    return lambda: delattr(diffuser, "reverse")


@pytest.mark.parametrize("max_sweeps", [2, None], ids=["2-sweeps", "t-1"])
def test_picard_matches_jax_with_jax_noise(setup, max_sweeps):
    """The port fed the normals JAX's Picard draws (its key chain split per
    step, then into rotation and translation) sweeps the same chain: every
    step of every sweep, the same number of sweeps, the same last sweep
    delta, the same prediction."""
    model, diffuser, params = setup["model"], setup["diffuser"], setup["params"]
    jf = setup["feats"][2]
    num_t, key = 5, jax.random.PRNGKey(7)
    j_chain, p_chain = [], []
    undo = _jax_spy(diffuser, j_chain)
    try:
        want = jax.jit(lambda k, p, f: jpicard.picard_reverse_sample(
            k, model, p, diffuser, f, num_t=num_t, noise_scale=1.0, tol=0.0,
            max_sweeps=max_sweeps))(key, params, jf)
        jax.effects_barrier()
    finally:
        undo()
    F, N = jf["res_mask"].shape
    noise = []
    for _ in range(num_t - 1):
        key, sub = jax.random.split(key)
        k_rot, k_trans = jax.random.split(sub)
        noise.append(tuple(torch.as_tensor(np.array(
            jax.random.normal(k, (F, N, 3)))) for k in (k_rot, k_trans)))
    undo = _spy(setup["tdiff"], p_chain)
    try:
        got = ppicard.picard_reverse_sample(
            setup["net"], setup["tdiff"], _torch(jf), num_t=num_t,
            noise_scale=1.0, tol=0.0, max_sweeps=max_sweeps, noise=noise)
    finally:
        undo()
    n_sweeps = max_sweeps or num_t - 1
    assert got["n_sweeps"] == int(want["n_sweeps"]) == n_sweeps
    assert len(p_chain) == len(j_chain) == n_sweeps * (num_t - 1)
    for i, (g, w) in enumerate(zip(p_chain, j_chain)):
        m, k = divmod(i, num_t - 1)
        _rigids_close(g, w, err_msg=f"sweep {m + 1}, step {k}")
    # the sweeps moved the chain: the last sweep differs from the first
    assert np.abs(j_chain[-1][..., 4:] - j_chain[num_t - 2][..., 4:]).max() \
        > 1e-3
    scale = max(1.0, float(np.abs(np.asarray(jf["rigids_t"])).max()))
    assert abs(float(got["sweep_delta"]) - float(want["sweep_delta"])) \
        <= COORD_REL * scale
    _rigids_close(got["rigids"], want["rigids"], err_msg="rigids")
    for k in ("atom37", "atom14", "angles"):
        _close(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 3c and 3d, rehearsed on the CPU at a small width
# ---------------------------------------------------------------------------
def test_chip_smoke_sampling_phases_rehearsal_on_cpu():
    import chip_smoke

    batched = chip_smoke.batched_rollout_phase(
        "cpu", chip_smoke.SMALL_OVERRIDES, lengths=(16, 12), pad_to=16,
        n_steps=2, num_t=3)
    assert batched["launches"] == batched["launches_fast_x0"] == 0
    picard = chip_smoke.picard_phase("cpu", chip_smoke.SMALL_OVERRIDES,
                                     n_res=12, pad_to=16, num_t=4)
    assert picard["n_sweeps"] == 3 and picard["launches"] == 0
