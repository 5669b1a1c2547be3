"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch and
the CUDA toolkit (the README names the command). Without a card the tests
marked ``cuda`` skip. Inputs are made with numpy from a seed."""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod

torch.set_num_threads(1)

NAMES = ("q", "k", "v", "q_pts", "k_pts", "v_pts", "bias", "pair_z", "mask",
         "head_weights")


def make_inputs(seed, F=2, N=16, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=3,
                lead_masked=0):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.normal(size=s).astype(np.float32)

    mask = np.ones((F, N), np.float32)
    if masked:
        mask[:, N - masked:] = 0.0
    mask[:, :lead_masked] = 0.0
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


# The IPA kernels' shapes, forward and backward alike: the release widths
# at N = 256 (the last 56 residues pad), a ragged 203, N = 5 and 16 (inside
# one 32-row block and one 16-key step) and a long ragged 611; the tiny
# width (C = 8) with and without pad rows; and the first 40 residues pad, so
# that every row's first key steps are all pad and its online softmax
# starts from a running max near -1e5.
RELEASE_WIDTHS = dict(H=8, C=256, Pq=8, Pv=12, Dz=32)
IPA_SHAPES = {
    "release": dict(N=256, masked=56, **RELEASE_WIDTHS),
    "ragged": dict(N=203, masked=11, **RELEASE_WIDTHS),
    "N5": dict(N=5, masked=1, **RELEASE_WIDTHS),
    "N16": dict(N=16, masked=3, **RELEASE_WIDTHS),
    "long-ragged": dict(N=611, masked=13, **RELEASE_WIDTHS),
    "tiny": dict(N=37, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=0),
    "tiny-masked": dict(N=37, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=5),
    "first-key-tile-pad": dict(N=203, masked=5, lead_masked=40,
                               **RELEASE_WIDTHS),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(IPA_SHAPES.values()),
                         ids=list(IPA_SHAPES))
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
    # past the tensor-core kernels' widths (ops.ipa_attention.TILE_LIMITS)
    for over, name in ((dict(C=260), "C=260"), (dict(Pq=11), r"Pq\*3=33"),
                       (dict(Pv=17), r"Pv\*3=51"), (dict(Dz=33), "Dz=33")):
        d, c_qk = make_inputs(4, **over)
        with pytest.raises(ValueError, match=f"{name} is above"):
            ipa_mod.ipa_attention(*_torch(d, cuda), c_qk)
    d, c_qk = make_inputs(4)
    args = _torch(d, cuda)
    with pytest.raises(TypeError, match="float32"):
        ipa_mod.ipa_attention(args[0].double(), *args[1:], c_qk)
    with pytest.raises(ValueError, match="contiguous"):
        ipa_mod.ipa_attention(args[0].transpose(0, 1).contiguous()
                              .transpose(0, 1), *args[1:], c_qk)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_pad", [True, False],
                         ids=["pad-cotangents-zero", "pad-cotangents-random"])
@pytest.mark.parametrize("shape", list(IPA_SHAPES.values()),
                         ids=list(IPA_SHAPES))
def test_backward_kernels_match_plain(cuda, shape, zero_pad):
    """Each backward kernel against its plain version on the same inputs
    (tolerances and their reasons: chip_smoke.BWD_RTOL, BWD_PAD_RTOL)."""
    args, c_qk = chip_smoke.ipa_inputs(torch, cuda, seed=5, **shape)
    inputs, _ = chip_smoke.ipa_bwd_inputs(torch, args, c_qk,
                                          zero_pad=zero_pad, seed=6)
    counts = (ipa_mod.bwd_dq_launches, ipa_mod.bwd_dkv_launches,
              ipa_mod.bwd_pair_launches)
    got = chip_smoke.ipa_bwd_grads(torch, inputs, c_qk, plain=False)
    torch.cuda.synchronize()
    assert (ipa_mod.bwd_dq_launches, ipa_mod.bwd_dkv_launches,
            ipa_mod.bwd_pair_launches) == tuple(c + 1 for c in counts)
    want = chip_smoke.ipa_bwd_grads(torch, inputs, c_qk, plain=True)
    pad_scale = (None if zero_pad
                 else chip_smoke.ipa_bwd_pad_scale(torch, inputs, c_qk))
    errs = chip_smoke.ipa_bwd_errors(got, want, pad_scale)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad


@pytest.mark.cuda
def test_function_backward_runs_the_kernels(cuda):
    """The autograd function on the card: one launch of each backward
    kernel per backward, gradients of every differentiable input, none for
    the mask, and agreement with autograd of the plain version (cotangents
    zero on pad rows: chip_smoke.BWD_RTOL)."""
    args, c_qk = chip_smoke.ipa_inputs(torch, cuda, N=37, H=2, C=8, Pq=4,
                                       Pv=6, Dz=4, masked=5, seed=7)
    args = [a.clone().requires_grad_(n != "mask") for a, n in zip(args, NAMES)]
    g = torch.Generator(device=cuda).manual_seed(8)
    mask = args[8]

    def loss(outs):
        total = 0.0
        for o in outs[:3]:
            w = torch.randn(o.shape, generator=g.manual_seed(8 + o.dim()),
                            device=cuda)
            total = total + (o * w * mask.reshape(
                mask.shape + (1,) * (o.dim() - 2))).sum()
        return total

    before = ipa_mod.bwd_pair_launches
    got = torch.autograd.grad(loss(ipa_mod.ipa_attention(*args, c_qk)),
                              [a for a in args if a.requires_grad])
    torch.cuda.synchronize()
    assert ipa_mod.bwd_pair_launches == before + 1
    want = torch.autograd.grad(loss(ipa_mod.ipa_attention_plain(*args, c_qk)),
                               [a for a in args if a.requires_grad])
    for name, a, b in zip([n for n in NAMES if n != "mask"], got, want):
        tol = chip_smoke.BWD_RTOL * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_cannot_take(cuda):
    args, c_qk = chip_smoke.ipa_inputs(torch, cuda, N=16, H=2, C=8, Pq=4,
                                       Pv=6, Dz=4, masked=3, seed=9)
    inputs, _ = chip_smoke.ipa_bwd_inputs(torch, args, c_qk, zero_pad=True,
                                          seed=10)
    bad = list(inputs)
    bad[12] = bad[12].double()
    with pytest.raises(TypeError, match="float32"):
        ipa_mod.ipa_attention_bwd_dq(*bad, c_qk=c_qk)
    bad = list(inputs)
    bad[6] = bad[6].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ipa_mod.ipa_attention_bwd_pair(*bad, c_qk=c_qk)
    # dq runs on the tensor cores: C at most 256 (dk/dv and pair take it)
    args, c_qk = chip_smoke.ipa_inputs(torch, cuda, N=16, H=2, C=260, Pq=4,
                                       Pv=6, Dz=4, masked=3, seed=9)
    outs = (torch.zeros_like(args[0]), torch.zeros_like(args[5]),
            torch.zeros((2, 16, 2, 4), device=cuda),
            torch.zeros((2, 2, 16), device=cuda))
    inputs = ipa_mod.backward_inputs(tuple(args) + outs,
                                     *(torch.zeros_like(o) for o in outs[:3]))
    with pytest.raises(ValueError, match="C=260 is above"):
        ipa_mod.ipa_attention_bwd_dq(*inputs, c_qk=c_qk)


# ---------------------------------------------------------------------------
# the GeoFormer attention kernels (ops/geom_attention.py)
# ---------------------------------------------------------------------------
GEOM_COUNTERS = {"geom_attention": "geom_launches",
                 "node_attention": "node_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16",
                                   "bfloat16-x-float32-weights"])
@pytest.mark.parametrize(
    "L,pad,B,prefix",
    [(256, 0, None, 0), (203, 11, None, 0), (37, 5, None, 0),
     (300, 0, None, 0), (5, 0, None, 0), (16, 0, None, 0),
     (611, 13, 32, 64), (203, 0, None, 64)],
    ids=["release", "ragged", "tiny", "two-query-chunks", "L5", "L16",
         "long-ragged", "first-key-steps-masked"])
@pytest.mark.parametrize("kind", list(GEOM_COUNTERS))
def test_geom_kernels_match_plain(cuda, kind, L, pad, B, prefix, dtype):
    """Each kernel against its plain version at its release widths, one
    launch each (tolerances and their reasons: chip_smoke.GEOM_ATOL,
    GEOM_BF16_RTOL). L = 5 and 16 sit below one 16-row mma tile and one
    32-key step; L = 611 spans three query chunks and five key chunks, with
    ragged last ones (its geom_attention batch cut to 32 rows to keep the
    plain version's logits small); ``prefix`` masks the first 64 keys of
    node_attention's row 1, its first two 32-key steps. bfloat16 x runs one
    projection pass with bfloat16 weights and three with float32 weights."""
    wdtype = torch.float32 if dtype.endswith("float32-weights") else None
    dtype = getattr(torch, dtype.split("-")[0])
    inp = chip_smoke.geom_inputs(
        torch, cuda, kind, L, dtype, seed=11, pad=pad,
        B=B if kind == "geom_attention" else None, masked_prefix=prefix,
        wdtype=wdtype)
    before = getattr(geom_mod, GEOM_COUNTERS[kind])
    got = chip_smoke.geom_call(geom_mod, kind, inp, plain=False)
    torch.cuda.synchronize()
    assert getattr(geom_mod, GEOM_COUNTERS[kind]) == before + 1
    want = chip_smoke.geom_call(geom_mod, kind, inp, plain=True)
    assert got.dtype == dtype and got.shape == want.shape
    err, over = chip_smoke.geom_error(got, want)
    assert over <= 0, err


@pytest.mark.cuda
def test_geom_kernels_reject_what_they_cannot_take(cuda):
    inp = chip_smoke.geom_inputs(torch, cuda, "geom_attention", 16,
                                 torch.float32, seed=12)
    args = [inp[k] for k in ("x", "qg_w", "qg_b", "kv_w", "kv_b", "bias")]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        geom_mod.fused_gated_geom_attention_t(args[0].double(), *args[1:],
                                              c=32, scale=1.0)
    with pytest.raises(ValueError, match="built for c=32"):
        geom_mod.fused_gated_geom_attention_t(
            args[0], *(a[..., :32] for a in args[1:5]), args[5], c=16,
            scale=1.0)
    with pytest.raises(ValueError, match="bias has shape"):
        geom_mod.fused_gated_geom_attention_t(*args[:5], args[5][:, :, :8],
                                              c=32, scale=1.0)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        geom_mod.fused_gated_geom_attention_t(
            args[0][..., :124], args[1][:124], args[2], args[3][:124],
            *args[4:], c=32, scale=1.0)
