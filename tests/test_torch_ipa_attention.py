"""IPA attention forward of the PyTorch port (ops/ipa_attention.py).

On the CPU the wrapper runs its plain version, which is held here against
the JAX package: against the Pallas kernel in interpret mode at a
block-divisible N (all four outputs, the row log-sum-exp included), and
against ``models/ipa.py:dense_ipa_attention`` at a ragged N with masked
rows. Both sides are float32 over contractions of at most 64 terms, so
they agree to 3e-6 on unit-scale outputs; the lse of a masked row sits near
-1e5, where a float32 ulp is 8e-3, so it is compared to 1e-7 relative.
The CUDA kernel itself is held against the plain version in
test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.models.ipa import dense_ipa_attention
from dynamicpdb_tpu.ops.pallas.ipa_attention import fused_ipa_attention
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from tests.test_torch_kernels import NAMES, _check_lse, _torch, make_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("masked", [0, 3])
def test_plain_matches_pallas_kernel_in_interpret_mode(masked):
    d, c_qk = make_inputs(0, masked=masked)
    want = fused_ipa_attention(
        *(jnp.asarray(d[n]) for n in NAMES), c_qk=c_qk, blk_q=8, blk_k=8,
        interpret=True, return_lse=True)
    before = ipa_mod.launches
    got = ipa_mod.ipa_attention(*_torch(d), c_qk)
    assert ipa_mod.launches == before  # CPU tensors: the plain version ran
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-6)
    _check_lse(got[3].numpy(), np.asarray(want[3]), d["mask"])


@pytest.mark.parametrize("n,masked", [(13, 4), (21, 0)])
def test_plain_matches_dense_at_ragged_n(n, masked):
    d, c_qk = make_inputs(1, N=n, masked=masked)
    want = dense_ipa_attention(*(jnp.asarray(d[x]) for x in NAMES), c_qk)
    got = ipa_mod.ipa_attention_plain(*_torch(d), c_qk)
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-6)


def test_mixed_devices_raise():
    d, c_qk = make_inputs(2)
    args = _torch(d)
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        ipa_mod.ipa_attention(*args, c_qk)


WRAPPERS = ("ipa_attention_fwd", "ipa_attention_bwd_dq",
            "ipa_attention_bwd_dkv", "ipa_attention_bwd_pair")
ROUTES = ("tc", "wide_tc", "wide")


def _smem(asked):
    """A stand-in for the wide library's shared-memory query: 200,000 bytes
    below C = 1024, 300,000 from there; ``asked`` records the wrappers."""
    def smem(name, C, P3q, P3v, Dz):
        asked.append(name)
        return 200_000 if C < 1024 else 300_000
    return smem


def _limit():
    return 232_448


@pytest.mark.parametrize("fn", WRAPPERS)
def test_kernel_route(fn):
    """Which kernel a wrapper launches on the card, decided on the CPU: the
    tensor-core kernel within TILE_LIMITS; past any one of them, within
    WIDE_TC_LIMITS, the wide tensor-core kernel, every wrapper alike (the
    wide library is asked in neither case); past those, the CUDA-core
    kernel while its tiles fit a block's shared memory; and a ValueError
    naming the widths and the limit past that. ``smem`` and ``limit``
    stand in for the wide library's shared-memory queries."""
    asked = []
    smem = _smem(asked)
    for widths in ((256, 24, 36, 32), (8, 12, 18, 4)):  # release, tiny
        assert ipa_mod.kernel_route(fn, *widths, smem=smem,
                                    smem_limit=_limit) == "tc"
    assert asked == []
    # model.ipa.c_z=256 (Dz 64), c_hidden=384, no_qk_points=12 (Pq*3 36),
    # no_v_points=18 (Pv*3 54), and all of them at once
    for widths in ((256, 24, 36, 64), (384, 24, 36, 32), (256, 36, 36, 32),
                   (256, 24, 54, 32), (384, 36, 54, 64)):
        assert ipa_mod.kernel_route(fn, *widths, smem=smem,
                                    smem_limit=_limit) == "wide_tc"
    assert asked == []
    with pytest.raises(ValueError, match=r"C=1024, Pq\*3=24, Pv\*3=36, "
                       r"Dz=32 is past .* needs 300000 bytes .* above the "
                       r"232448"):
        ipa_mod.kernel_route(fn, 1024, 24, 36, 32, smem=smem,
                             smem_limit=_limit)


@pytest.mark.parametrize("widths", [(388, 24, 36, 32), (256, 42, 36, 32),
                                    (256, 24, 60, 32), (256, 24, 36, 68)],
                         ids=["C388", "Pq14", "Pv20", "Dz68"])
@pytest.mark.parametrize("fn", WRAPPERS)
def test_kernel_route_past_the_wide_tensor_core_limits(fn, widths):
    """One width past ipa_attention.WIDE_TC_LIMITS sends every wrapper to
    its CUDA-core kernel, which the wide library's shared memory admits."""
    asked = []
    assert ipa_mod.kernel_route(fn, *widths, smem=_smem(asked),
                                smem_limit=_limit) == "wide"
    assert asked == [fn]


def test_every_route_has_a_counter_and_a_library():
    """Each (wrapper, route) that kernel_route can return, every wrapper on
    every route, names its own launch counter and a library that lists its
    launcher."""
    for fn in WRAPPERS:
        for route in ROUTES:
            assert isinstance(getattr(ipa_mod, ipa_mod.COUNTERS[(fn, route)]),
                              int)
            lib, launcher = ipa_mod.launcher(fn, route)
            assert launcher in ipa_mod.LIBRARIES[lib][0], (fn, route)
    assert set(ipa_mod.COUNTERS) == {(fn, r) for fn in WRAPPERS
                                     for r in ROUTES}
    assert len(set(ipa_mod.COUNTERS.values())) == len(ipa_mod.COUNTERS)
