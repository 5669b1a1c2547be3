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
# starts from a running max near -1e5. "wide" and "wide-dz" are past the
# tensor-core kernels' widths (ipa_attention.TILE_LIMITS), so they run the
# wide tensor-core kernels, all four: C = 384, Pq = 12, Pv = 18,
# Dz = 64 at N = 203, and the release widths with Dz = 64
# (model.ipa.c_z = 256).
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
    "wide": dict(N=203, masked=11, H=4, C=384, Pq=12, Pv=18, Dz=64),
    "wide-dz": dict(N=256, masked=56, **dict(RELEASE_WIDTHS, Dz=64)),
    # chip_smoke's phase 4b model: c_z 256, c_hidden 384, no_qk_points 12
    "wide-model": dict(N=256, masked=56,
                       **dict(RELEASE_WIDTHS, C=384, Pq=12, Dz=64)),
    # past ipa_attention.WIDE_TC_LIMITS: all four on the CUDA cores
    "past-wide-tc": dict(N=37, H=2, C=392, Pq=14, Pv=20, Dz=72, masked=5),
}


def counter(fn, shape):
    """The launch counter that wrapper ``fn`` moves at ``shape``'s widths:
    its kernel's on the route ``kernel_route`` picks for it."""
    widths = dict(RELEASE_WIDTHS, **shape)
    route = ipa_mod.kernel_route(fn, widths["C"], 3 * widths["Pq"],
                                 3 * widths["Pv"], widths["Dz"])
    return ipa_mod.COUNTERS[(fn, route)]


BWD_FNS = ("ipa_attention_bwd_dq", "ipa_attention_bwd_dkv",
           "ipa_attention_bwd_pair")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(IPA_SHAPES.values()),
                         ids=list(IPA_SHAPES))
def test_kernel_matches_plain(cuda, shape):
    d, c_qk = make_inputs(3, F=2, **shape)
    args = _torch(d, cuda)
    count = counter("ipa_attention_fwd", shape)
    before = getattr(ipa_mod, count)
    got = ipa_mod.ipa_attention(*args, c_qk)
    torch.cuda.synchronize()
    assert getattr(ipa_mod, count) == before + 1
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
    # past one entry of ops.ipa_attention.TILE_LIMITS the wide tensor-core
    # kernel runs, past one of WIDE_TC_LIMITS the CUDA-core one
    for over, count in ((dict(C=260), "wide_tc_launches"),
                        (dict(Pq=11), "wide_tc_launches"),
                        (dict(Pv=17), "wide_tc_launches"),
                        (dict(Dz=33), "wide_tc_launches"),
                        (dict(C=388), "wide_launches"),
                        (dict(Dz=65), "wide_launches")):
        d, c_qk = make_inputs(4, **over)
        before = getattr(ipa_mod, count)
        ipa_mod.ipa_attention(*_torch(d, cuda), c_qk)
        assert getattr(ipa_mod, count) == before + 1, over
    # past the wide kernel's shared memory (its tiles at C = 2048) it raises
    d, c_qk = make_inputs(4, C=2048)
    with pytest.raises(ValueError, match=f"above the {ipa_mod.wide_smem_limit()}"):
        ipa_mod.ipa_attention(*_torch(d, cuda), c_qk)
    d, c_qk = make_inputs(4)
    args = _torch(d, cuda)
    with pytest.raises(TypeError, match="float32"):
        ipa_mod.ipa_attention(args[0].double(), *args[1:], c_qk)
    with pytest.raises(ValueError, match="contiguous"):
        ipa_mod.ipa_attention(args[0].transpose(0, 1).contiguous()
                              .transpose(0, 1), *args[1:], c_qk)


@pytest.mark.cuda
def test_wide_route_shared_memory_from_the_library(cuda):
    """kernel_route reads the wide kernels' shared memory from their
    library: the release widths stay on the tensor cores; at the wide case
    all four wrappers take the wide tensor-core kernels (each one's own
    query fits a block at the widest it takes); C = 388 sends all four to
    the CUDA-core kernels, which fit the wide case; C = 2048 fits none."""
    for fn in ("ipa_attention_fwd",) + BWD_FNS:
        assert ipa_mod.kernel_route(fn, 256, 24, 36, 32) == "tc"
        assert ipa_mod.kernel_route(fn, 384, 36, 54, 64) == "wide_tc"
        assert 0 < ipa_mod.wide_smem(
            fn, 384, 39, 54, 64, kernels=ipa_mod.WIDE_TC_KERNELS) <= 232_448
        assert ipa_mod.kernel_route(fn, 388, 36, 54, 64) == "wide"
        assert 0 < ipa_mod.wide_smem(fn, 384, 36, 54, 64) <= ipa_mod.wide_smem_limit()
        with pytest.raises(ValueError, match="shared memory"):
            ipa_mod.kernel_route(fn, 2048, 24, 36, 32)


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
    names = [counter(fn, shape) for fn in BWD_FNS]
    counts = [getattr(ipa_mod, n) for n in names]
    got = chip_smoke.ipa_bwd_grads(torch, inputs, c_qk, plain=False)
    torch.cuda.synchronize()
    assert [getattr(ipa_mod, n) for n in names] == [c + 1 for c in counts]
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
    # past one entry of ops.ipa_attention.TILE_LIMITS each runs its wide
    # tensor-core kernel, past one of WIDE_TC_LIMITS its CUDA-core kernel
    # (``counter`` names the route's); past the wide kernels' shared memory
    # (C = 2048) each raises
    small = dict(N=16, H=2, C=8, Pq=4, Pv=6, Dz=4, masked=3)
    for over in (dict(C=260), dict(Pq=11), dict(Pv=17), dict(Dz=33),
                 dict(C=388), dict(Dz=65), dict(C=2048)):
        shape = {**small, **over}
        args, c_qk = chip_smoke.ipa_inputs(torch, cuda, seed=9, **shape)
        outs = (torch.zeros_like(args[0]), torch.zeros_like(args[5]),
                torch.zeros((2, 16, 2, shape["Dz"]), device=cuda),
                torch.zeros((2, 2, 16), device=cuda))
        inputs = ipa_mod.backward_inputs(
            tuple(args) + outs, *(torch.zeros_like(o) for o in outs[:3]))
        for name in BWD_FNS:
            fn = getattr(ipa_mod, name)
            if over == dict(C=2048):
                with pytest.raises(ValueError, match="shared memory"):
                    fn(*inputs, c_qk=c_qk)
                continue
            count = counter(name, shape)
            before = getattr(ipa_mod, count)
            fn(*inputs, c_qk=c_qk)
            assert getattr(ipa_mod, count) == before + 1, (name, over)


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
@pytest.mark.parametrize("case", chip_smoke.AF2_ATTENTION_CASES,
                         ids=[c[0] for c in chip_smoke.AF2_ATTENTION_CASES])
def test_geom_kernels_at_alphafold_shapes_match_plain(cuda, case):
    """Each wrapper against its plain version at the shapes AlphaFold2
    model_5's path calls it at (MSA row and column attention on
    node_attention, triangle attention on the one-axis geom_attention, on
    z and z^T), set up as the model sets them up; float32, tolerance
    chip_smoke.GEOM_ATOL; one launch each."""
    kind = case[1]
    inp = chip_smoke.af2_attention_inputs(torch, cuda, case, seed=17)
    before = getattr(geom_mod, GEOM_COUNTERS[kind])
    got = chip_smoke.geom_call(geom_mod, kind, inp, plain=False)
    torch.cuda.synchronize()
    assert getattr(geom_mod, GEOM_COUNTERS[kind]) == before + 1
    want = chip_smoke.geom_call(geom_mod, kind, inp, plain=True)
    assert got.shape == want.shape
    err, over = chip_smoke.geom_error(got, want)
    assert over <= 0, err


def _rect_id(case) -> str:
    """The case's label, hyphenated, with its kernel where two kernels
    share the label."""
    label, kind = case[:2]
    shared = [c[0] for c in chip_smoke.GEOM_RECT_CASES].count(label) > 1
    return (f"{label}-{kind}" if shared else label).replace(" ", "-")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.GEOM_RECT_CASES,
                         ids=[_rect_id(c) for c in chip_smoke.GEOM_RECT_CASES])
def test_geom_kernels_rectangular_calls_match_plain(cuda, case, dtype):
    """Sequence parallelism's calls (chip_smoke.GEOM_RECT_CASES):
    node_attention on a block of query rows against every key (a pad row
    past L in the ragged block), geom_attention on a rank's batch rows,
    and both kernels' square calls at 96 residues; one launch each against
    the plain version, at the square calls' tolerances. A call of at most
    128 query rows runs the 128-row instance (its counter moves), and its
    output equals the 256-row instance's on the same inputs bit for bit."""
    label, kind, L, rows, B = case
    dtype = getattr(torch, dtype)
    inp = chip_smoke.geom_inputs(torch, cuda, kind, L, dtype, seed=13, B=B,
                                 rows=rows,
                                 masked_suffix=chip_smoke.GEOM_RECT_MASKED)
    counter = GEOM_COUNTERS[kind]
    before = getattr(geom_mod, counter), getattr(geom_mod, counter + "_128")
    got = chip_smoke.geom_call(geom_mod, kind, inp, plain=False)
    torch.cuda.synchronize()
    tile = geom_mod.tile_rows(rows[1] if rows else L)
    assert (getattr(geom_mod, counter),
            getattr(geom_mod, counter + "_128")) == (
        before[0] + 1, before[1] + (tile == 128))
    want = chip_smoke.geom_call(geom_mod, kind, inp, plain=True)
    assert got.dtype == dtype and got.shape == want.shape
    err, over = chip_smoke.geom_error(got, want)
    assert over <= 0, err
    if tile == 128:
        other = chip_smoke.geom_kernel_launch(torch, geom_mod, kind, inp,
                                              256)()
        assert torch.equal(other.view(got.shape), got)


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
    # the kernel has the instances of TILE_ROWS and refuses any other tile
    for rows in (0, 64, 192, 512):
        with pytest.raises(RuntimeError, match=f"rows={rows}"):
            chip_smoke.geom_kernel_launch(torch, geom_mod, "geom_attention",
                                          inp, rows)()


# ---------------------------------------------------------------------------
# GeometricAttention's triangle-multiplicative route (ops/geom_triangle.py)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.TRI_CASES,
                         ids=[c[0].replace(" ", "-")
                              for c in chip_smoke.TRI_CASES])
def test_triangle_route_matches_plain(cuda, case, dtype):
    """The route's three kernels against the plain branch (tolerances and
    their reasons: chip_smoke.TRI_ATOL, TRI_BF16_RTOL) at the release width:
    L 256, a ragged 203 with its padded tail under pad_safe, the short 96,
    a 'seq' rank's rows 128-255 of 256 under pad_safe and rank 1's rows
    102-203 of a ragged 203 (its last a pad row). One launch of each kernel
    a call; a rank's real rows equal the square call's bit for bit."""
    from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod

    label, L, rows, masked, pad_safe = case
    dtype = getattr(torch, dtype)
    inp = chip_smoke.triangle_inputs(torch, cuda, L, dtype, seed=61 + L,
                                     rows=rows, masked=masked)
    before = chip_smoke.triangle_counts(tri_mod)
    got = chip_smoke.triangle_call(tri_mod, inp, pad_safe, plain=False)
    torch.cuda.synchronize()
    assert chip_smoke.triangle_counts(tri_mod) == {
        k: v + 1 for k, v in before.items()}
    want = chip_smoke.triangle_call(tri_mod, inp, pad_safe, plain=True)
    assert got.dtype == dtype and got.shape == want.shape
    err, over = chip_smoke.triangle_error(got, want)
    assert over <= 0, err
    if rows:
        q0, n = rows[0], min(rows[1], L - rows[0])
        square = dict(inp, edge=inp["whole"], q0=0, attended=torch.cat(
            [inp["whole"][:q0], inp["attended"][:n], inp["whole"][q0 + n:]]))
        full = chip_smoke.triangle_call(tri_mod, square, pad_safe,
                                        plain=False)
        assert torch.equal(full[q0:q0 + n], got[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.TRI_VIEW_CASES,
                         ids=[f"L{L}-view{v}"
                              for L, v in chip_smoke.TRI_VIEW_CASES])
def test_triangle_view_route_matches_plain(cuda, case):
    """The single-view route (AlphaFold2's outgoing and incoming triangle
    multiplications) against its plain version at the release width, L
    256 and a ragged 203, float32 (tolerance chip_smoke.TRI_ATOL); one
    call counted, the two-view counters untouched."""
    from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod

    L, view = case
    inp = chip_smoke.triangle_view_inputs(torch, cuda, L, seed=91 + L)
    before = (tri_mod.tri_view_launches, chip_smoke.triangle_counts(tri_mod))
    got = chip_smoke.triangle_view_call(tri_mod, inp, view, plain=False)
    torch.cuda.synchronize()
    assert tri_mod.tri_view_launches == before[0] + 1
    assert chip_smoke.triangle_counts(tri_mod) == before[1]
    want = chip_smoke.triangle_view_call(tri_mod, inp, view, plain=True)
    err, over = chip_smoke.triangle_error(got, want)
    assert over <= 0, err
