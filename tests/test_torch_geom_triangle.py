"""GeometricAttention's triangle-multiplicative branch (``ops/geom_triangle``)
on the CPU: its plain version against the JAX package's geometric attention,
a 'seq' rank's rows against the square call's, the wrapper's refusals and
its counters.

The JAX side runs ``geometric_attention`` with the attention's output
projection zeroed, so that its result is the triangle branch alone; the
port's plain branch takes the normalised edge and zeros for the attended
branch. float32 on both sides, tolerances as ``test_torch_omegafold``
(1e-5 for one module)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu.models.omegafold import geoformer as jax_geo
from dynamicpdb_tpu_torch.models.omegafold.core import layer_norm_f32
from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod
from tests.test_torch_omegafold import close, rnd, weights  # noqa: F401

torch.set_num_threads(1)

D = 16  # the tiny configuration's edge width


def _params(weights):  # noqa: F811
    """(the port's GeometricAttention, JAX's params of it with the
    attention's output projection zeroed)."""
    _, params, _, port = weights
    jp = jax.tree_util.tree_map(lambda a: a[1], params.geoformer.blocks)
    g = jp.geom[0]
    g = g._replace(attn=g.attn._replace(
        o_weights=jnp.zeros_like(g.attn.o_weights),
        o_bias=jnp.zeros_like(g.attn.o_bias)))
    return port.omega_fold_cycle.geoformer.blocks[1].geometric_attention[0], g


def _branch(gp, edge, mask, *, q0=0, rows=None, pad_safe=False):
    """The plain branch on rows [q0, q0 + rows) of the normalised edge
    (zeros past L), attended zero."""
    whole = layer_norm_f32(torch.tensor(edge))
    L = whole.shape[0]
    rows = rows or L
    part = whole[q0:q0 + rows]
    part = torch.cat([part, torch.zeros(rows - part.shape[0], L, D)])
    return tri_mod.geom_triangle_plain(
        part, whole, torch.zeros(rows, L, D), torch.tensor(mask), gp.act_w,
        gp.act_b, gp.out_proj_w, gp.out_proj_b, q0=q0, pad_safe=pad_safe)


@pytest.mark.parametrize("pad_safe", [False, True])
@pytest.mark.parametrize("L,masked", [(9, 3), (13, 0), (13, 5)],
                         ids=["L9-padded", "L13", "L13-padded"])
def test_plain_branch_matches_jax(weights, L, masked, pad_safe):  # noqa: F811
    _, _, jcfg, _ = weights
    gp, jp = _params(weights)
    mask = np.ones(L, np.float32)
    mask[L - masked:] = 0
    edge = rnd(L + masked, L, L, D)
    got = _branch(gp, edge, mask, pad_safe=pad_safe)
    want = jax.jit(functools.partial(
        jax_geo.geometric_attention, c=jcfg.geom_c, n_head=jcfg.geom_head,
        pad_safe=pad_safe))(jp, edge, mask)
    close(got, want, 1e-5)


@pytest.mark.parametrize("pad_safe", [False, True])
@pytest.mark.parametrize("L,S", [(13, 2), (13, 4), (12, 3)])
def test_a_ranks_rows_are_the_square_calls(weights, L, S, pad_safe):  # noqa: F811
    """Each 'seq' rank's real rows of the branch equal the square call's
    rows (the last rank's rows past L are pad rows)."""
    gp, _ = _params(weights)
    mask = np.ones(L, np.float32)
    mask[-2:] = 0
    edge = rnd(L, L, L, D)
    square = _branch(gp, edge, mask, pad_safe=pad_safe)
    rows = -(-L // S)
    for rank in range(S):
        q0 = rank * rows
        got = _branch(gp, edge, mask, q0=q0, rows=rows, pad_safe=pad_safe)
        assert got.shape == (rows, L, D)
        n = max(0, min(rows, L - q0))
        close(got[:n], square[q0:q0 + n], 1e-6)


def _kernel_args(L=16, Lr=None, d=tri_mod.KERNEL_D, dtype=torch.float32):
    Lr = Lr or L
    z = functools.partial(torch.zeros, dtype=dtype)
    return dict(edge=z(Lr, L, d), whole=z(L, L, d), attended=z(Lr, L, d),
                mask=torch.ones(L), act_w=torch.zeros(d, 2, 5 * d),
                act_b=torch.zeros(2, 5 * d), out_proj_w=torch.zeros(2, d, d),
                out_proj_b=torch.zeros(2, d))


def _misaligned(t):
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    off = next(i for i in range(4) if (flat.data_ptr() + 4 * i) % 16 == 4)
    return flat[off:off + t.numel()].view(t.shape)


@pytest.mark.parametrize("change,error,match", [
    (dict(dtype=torch.float64), TypeError, "float32 or bfloat16"),
    ("whole-bf16", TypeError, "whole is torch.bfloat16"),
    (dict(d=64), ValueError, "built for d=128"),
    (dict(L=16, Lr=17), ValueError, "Lr=17 rows of a window of L=16"),
    ("q0", ValueError, "q0=-1"),
    ("attended-shape", ValueError, "attended has shape"),
    ("act_w-shape", ValueError, "act_w has shape"),
    ("mask-shape", ValueError, "mask has shape"),
    ("misaligned", ValueError, "edge is not 16-byte aligned"),
], ids=["dtype", "mixed-dtypes", "width", "rows-past-L", "negative-q0",
        "attended", "act_w", "mask", "alignment"])
def test_the_wrapper_refuses_what_the_kernels_cannot_take(change, error,
                                                          match):
    """``kernel_inputs`` (the card's checks, run here on CPU tensors)
    raises before any launch."""
    args = _kernel_args(**change) if isinstance(change, dict) else \
        _kernel_args()
    q0 = 0
    if change == "whole-bf16":
        args["whole"] = args["whole"].bfloat16()
    elif change == "q0":
        q0 = -1
    elif change == "attended-shape":
        args["attended"] = args["attended"][:, :-1]
    elif change == "act_w-shape":
        args["act_w"] = args["act_w"][..., :-1]
    elif change == "mask-shape":
        args["mask"] = args["mask"][:-1]
    elif change == "misaligned":
        args["edge"] = _misaligned(args["edge"])
    with pytest.raises(error, match=match):
        tri_mod.kernel_inputs(*args.values(), q0=q0)


def test_the_wrapper_takes_what_the_kernels_take():
    args = _kernel_args(L=203, Lr=102, dtype=torch.bfloat16)
    ops = tri_mod.kernel_inputs(*args.values(), q0=102)
    assert ops["edge"].dtype == torch.bfloat16
    assert all(ops[k].dtype == torch.float32
               for k in ("mask", "act_w", "act_b", "out_w", "out_b"))
    assert tri_mod.padded_length(203) == 256
    assert tri_mod.padded_length(256) == 256
    assert tri_mod.padded_length(96) == 128


def test_the_cpu_path_runs_the_plain_version_and_counts_nothing(weights):  # noqa: F811
    gp, _ = _params(weights)
    L = 9
    edge = layer_norm_f32(torch.tensor(rnd(1, L, L, D)))
    mask = torch.ones(L)
    before = chip_smoke.triangle_counts(tri_mod)
    got = tri_mod.geom_triangle(edge, edge, torch.zeros(L, L, D), mask,
                                gp.act_w, gp.act_b, gp.out_proj_w,
                                gp.out_proj_b)
    assert chip_smoke.triangle_counts(tri_mod) == before
    want = tri_mod.geom_triangle_plain(edge, edge, torch.zeros(L, L, D),
                                       mask, gp.act_w, gp.act_b,
                                       gp.out_proj_w, gp.out_proj_b)
    assert torch.equal(got, want)


def test_triangle_cost_counts_the_release_call():
    """``chip_smoke.triangle_cost`` at the release shapes: 17.2, 8.6 and
    8.6 GFLOP of products."""
    cost = chip_smoke.triangle_cost(256)
    assert {k: round(v[0] / 1e9, 2) for k, v in cost.items()} == {
        "tri_proj": 17.18, "tri_mm": 8.59, "tri_out": 8.59}
    # act_row and act_col, 2 x 128 x 256 x 256 float32 each, and the
    # edge: the projection's bytes
    assert cost["tri_proj"][1] > 2 * 2 * 128 * 256 * 256 * 4
