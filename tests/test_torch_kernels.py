"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch and
the CUDA toolkit (the README names the command). Without a card the tests
marked ``cuda`` skip. Inputs are made with numpy from a seed."""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

torch.set_num_threads(1)

NAMES = ("q", "k", "v", "q_pts", "k_pts", "v_pts", "bias", "pair_z", "mask",
         "head_weights")


def make_inputs(seed, F=2, N=16, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=3):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.normal(size=s).astype(np.float32)

    mask = np.ones((F, N), np.float32)
    if masked:
        mask[:, N - masked:] = 0.0
    d = dict(
        q=f32(F, N, H, C), k=f32(F, N, H, C), v=f32(F, N, H, C),
        q_pts=f32(F, N, H, Pq, 3), k_pts=f32(F, N, H, Pq, 3),
        v_pts=f32(F, N, H, Pv, 3), bias=f32(N, N, H), pair_z=f32(N, N, Dz),
        mask=mask,
        head_weights=rng.uniform(0.3, 1.0, H).astype(np.float32),
    )
    return d, math.sqrt(1.0 / (3 * C))


def _torch(d, device="cpu"):
    return [torch.as_tensor(d[n], device=device) for n in NAMES]


def _check_lse(got, want, mask, atol=1e-5, rtol=1e-7):
    """lse: ``atol`` on real rows; ``rtol`` on masked rows, whose lse sits
    near -1e5 (a float32 ulp there is 8e-3)."""
    real = mask.astype(bool)[:, None, :]  # [F, 1, N] against [F, H, N]
    real = np.broadcast_to(real, want.shape)
    np.testing.assert_allclose(got[real], want[real], atol=atol)
    np.testing.assert_allclose(got[~real], want[~real], rtol=rtol)


# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(N=256, H=8, C=256, Pq=8, Pv=12, Dz=32, masked=56),  # release
    dict(N=203, H=8, C=256, Pq=8, Pv=12, Dz=32, masked=11),  # ragged
    dict(N=37, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=0),  # tiny
])
def test_kernel_matches_plain(cuda, shape):
    d, c_qk = make_inputs(3, F=2, **shape)
    args = _torch(d, cuda)
    before = ipa_mod.launches
    got = ipa_mod.ipa_attention(*args, c_qk)
    torch.cuda.synchronize()
    assert ipa_mod.launches == before + 1
    want = ipa_mod.ipa_attention_plain(*args, c_qk)
    # tolerances and their reasons: chip_smoke.ipa_errors
    errs = chip_smoke.ipa_errors(got, want, args)
    for name in ("o", "o_pt", "o_pair"):
        e = errs[name]
        assert e["real"] <= e["tol_real"] and e["pad"] <= e["tol_pad"], (name, e)
    assert errs["lse"]["ok"], errs["lse"]


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    d, c_qk = make_inputs(4, C=6)  # C not a multiple of 4
    with pytest.raises(ValueError, match="multiple of 4"):
        ipa_mod.ipa_attention(*_torch(d, cuda), c_qk)
    d, c_qk = make_inputs(4)
    args = _torch(d, cuda)
    with pytest.raises(TypeError, match="float32"):
        ipa_mod.ipa_attention(args[0].double(), *args[1:], c_qk)
    with pytest.raises(ValueError, match="contiguous"):
        ipa_mod.ipa_attention(args[0].transpose(0, 1).contiguous()
                              .transpose(0, 1), *args[1:], c_qk)
