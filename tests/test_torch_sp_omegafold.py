"""OmegaFold under sequence parallelism in the PyTorch port
(``models/omegafold/`` under ``parallel/sp.py``) against the JAX package
and against one process, on the CPU, at the tiny OmegaFold widths
(``test_torch_omegafold.tiny_cfg``).

  * ``omega_plm`` and one ``geoformer_block`` on 2 and 4 gloo ranks of a
    'seq' axis (``tools/sp_run.py``'s "omegafold_modules"), at L = 16 and
    at a ragged L (17 on 2 ranks, 18 on 4: pad rows past L), pseudo-MSA
    row 2 masked from residue 12 on as in JAX's own tests, the ragged case
    with its last two residues padded and ``pad_safe``, against the JAX
    functions on the same numpy-seeded inputs and weights: atol 2e-5, the
    bar of JAX's own split tests (tests/test_omegafold_core.py:212-213,
    tests/test_omegafold_geoformer.py:235-236);
  * the column view (``sp.column_view``), forward and backward, against
    the whole tensor's transpose: bit-equal (it moves numbers);
  * ``omegafold_embed`` (2 cycles, ``pad_safe``, ``return_structure``) on
    2 ranks against the port's one process, every cycle's node, edge and
    confidence, the selected cycle, pos14 and pLDDT, through
    ``chip_smoke.sp_omegafold_phase``'s CPU rehearsal (phases 10a and
    10b): within 1e-5 of each output's scale (float32 sums of a rank's
    rows in another order through two recycles of a two-block model), and
    a planted fault (the column view taken from the rank's own rows) read
    past the phase's bound;
  * the rectangular plain ``node_attention`` (a block of query rows
    against every key, pad rows past L) against the rows of the JAX
    ``fused_gated_node_attention`` (its Pallas kernel in interpret mode):
    1e-5, test_torch_geom_attention's bar.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu.models.omegafold import geoformer as jax_geo
from dynamicpdb_tpu.models.omegafold import model as jax_model
from dynamicpdb_tpu.models.omegafold import plm as jax_plm
from dynamicpdb_tpu.ops.pallas.geom_attention import (
    fused_gated_node_attention as jax_node,
)
from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict
from tests.test_torch_omegafold import rnd, tiny_cfg
from tests.test_torch_parallel import launch

torch.set_num_threads(1)

JAX_ATOL = 2e-5
EMBED_RTOL = 1e-5
M = 4  # pseudo-MSA rows
# (S, ragged L): 17 leaves one pad row on 2 ranks, 18 two on 4
RAGGED = {2: 17, 4: 18}


def _mask(L: int, ragged: bool) -> np.ndarray:
    mask = np.ones((M, L), np.float32)
    mask[2, 12:] = 0.0
    if ragged:
        mask[:, L - 2:] = 0.0  # the pipeline's padding, under pad_safe
    return mask


def _cases(L: int, ragged: bool) -> dict:
    rng = np.random.default_rng(L)
    tokens = rng.integers(0, 22, (M, L))  # 21: the dropout token
    return dict(tokens=tokens, mask=_mask(L, ragged),
                node=rnd(L, M, L, 24), edge=rnd(L + 1, L, L, 16),
                pad_safe=ragged)


@pytest.fixture(scope="module")
def weights():
    """(state dict, JAX params, JAX config), one set."""
    sd = random_omegafold_state_dict(tiny_cfg(), 0)
    params, jcfg = jax_model.params_from_state_dict(sd)
    return sd, params, jcfg


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def split(request, weights, tmp_path_factory):
    """One launch of S ranks: the PLM and the first GeoFormer block at
    L = 16 and RAGGED[S], and the column view of a [L, L, 3] tensor."""
    S = request.param
    tmp = tmp_path_factory.mktemp(f"sp_omegafold_{S}")
    cases = {L: _cases(L, L != 16) for L in (16, RAGGED[S])}
    modules = []
    for c in cases.values():
        modules.append({"plm": (torch.tensor(c["tokens"]),
                                torch.tensor(c["mask"]))})
        modules.append({"block": (torch.tensor(c["node"]),
                                  torch.tensor(c["edge"]),
                                  torch.tensor(c["mask"]), c["pad_safe"])})
    g = torch.Generator().manual_seed(S)
    n = RAGGED[S]
    square = {"square": torch.randn((n, n, 3), generator=g),
              "g_square": torch.randn((n, n, 3), generator=g)}
    payload = tmp / "payload.pt"
    torch.save({"omegafold_modules": {
        "weights": {k: torch.from_numpy(v) for k, v in weights[0].items()},
        "cases": modules}, "collectives": square}, payload)
    launch(S, "dynamicpdb_tpu_torch.tools.sp_run",
           ["--device", "cpu", "--payload", str(payload), "--out",
            str(tmp / "out")])
    ranks = [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=False)
             for r in range(S)]
    return dict(S=S, cases=cases, ranks=ranks, square=square)


@functools.cache
def _jax_block(jcfg, pad_safe: bool):
    return jax.jit(functools.partial(
        jax_geo.geoformer_block, attn_c=jcfg.attn_c, geom_c=jcfg.geom_c,
        geom_head=jcfg.geom_head, pad_safe=pad_safe))


@pytest.mark.parametrize("ragged", [False, True], ids=["L16", "ragged"])
@pytest.mark.parametrize("module", ["plm", "block"])
def test_omegafold_modules_under_seq_match_jax(split, weights, module,
                                               ragged):
    _, params, jcfg = weights
    L = RAGGED[split["S"]] if ragged else 16
    c = split["cases"][L]
    if module == "plm":
        want = jax_plm.omega_plm(params.plm, jcfg.plm, c["tokens"],
                                 c["mask"])
    else:
        jp = jax.tree_util.tree_map(lambda a: a[0], params.geoformer.blocks)
        want = _jax_block(jcfg, c["pad_safe"])(jp, c["node"], c["edge"],
                                               c["mask"])
    index = 2 * sorted(split["cases"]).index(L) + (module == "block")
    for r, res in enumerate(split["ranks"]):
        assert res["mesh"] == {"seq": split["S"]}
        for got, w in zip(res["omegafold_modules"][index], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=JAX_ATOL, rtol=0,
                                       err_msg=f"{module} L={L} rank {r}")
        assert res["sp_calls"]["omegafold_modules"] > 0


def test_column_view_forward_and_backward(split):
    """Each rank's rows of the whole tensor's transpose, and as gradient
    the rows of the cotangent's transpose (the adjoint of a transpose)."""
    x, g = split["square"]["square"], split["square"]["g_square"]
    n = x.shape[0]
    rows = -(-n // split["S"])
    pad = torch.zeros((rows * split["S"] - n, n, 3))
    want_y = torch.cat([x.transpose(0, 1), pad])
    want_g = torch.cat([g.transpose(0, 1), pad])
    for r, res in enumerate(split["ranks"]):
        y, gx = res["collectives"]["column_view"]
        block = slice(r * rows, (r + 1) * rows)
        assert torch.equal(y, want_y[block]), r
        assert torch.equal(gx, want_g[block]), r


def test_column_view_inactive_is_the_transpose():
    x = torch.randn(5, 5, 2)
    with sp.activated(None):
        assert torch.equal(sp.column_view(x, 5), x.transpose(0, 1))
        assert sp.rank0(x) is x


def test_omegafold_embed_under_seq_matches_one_process(tmp_path):
    """Phase 10's CPU rehearsal: two sequences of 13 and 20 residues padded
    to multiples of 3 (15 and 21: each leaves a pad row on 2 ranks), 2
    cycles, and a 24-residue cycle for 10b."""
    out = chip_smoke.sp_omegafold_phase(
        torch, str(tmp_path), "cpu", weights=None, cfg=tiny_cfg(),
        lengths=(13, 20), num_cycles=2, num_pseudo_msa=3, pad_multiple=3,
        long_n=24, device="cpu")
    assert len(out["readings"]) == 2
    assert max(out["readings"] + [out["long"]]) <= EMBED_RTOL
    assert out["fault"] > chip_smoke.SP_OF_FAULT_FACTOR * chip_smoke.SP_OF_RTOL
    for one, ranks in zip(out["one"][0]["omegafold"],
                          zip(*(r["omegafold"] for r in out["seq"]))):
        L = one["edge"].shape[0]
        assert [r["rows"] for r in ranks] == [(0, (L + 1) // 2, L + 1),
                                              ((L + 1) // 2, (L + 1) // 2,
                                               L + 1)]
        assert all(r["cycle"] == one["cycle"] for r in ranks)
        assert len(one["cycles"]) == 2 and one["pos14"].shape == (L, 14, 3)


# ---------------------------------------------------------------------------
# the rectangular node attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q0,Lq", [(0, 6), (6, 6), (8, 7)],
                         ids=["first-rows", "last-rows", "pad-rows"])
def test_rectangular_node_plain_matches_jax_rows(q0, Lq):
    """Rows [q0, q0 + Lq) of L = 12 against all 12 keys, a partial key
    mask per pseudo-MSA row; 'pad-rows' runs past L (rows 12-14), where
    the queries read zeros: finite, and equal to a call on zero rows."""
    L, H, C, d = 12, 2, 4, 8
    rng = np.random.default_rng(q0 + Lq)

    def f32(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    x = f32(3, L, d)
    w = [f32(d, 1, H, 2 * C, scale=d ** -0.5), f32(1, H, 1, 2 * C, scale=0.1),
         f32(d, 1, H, 2 * C, scale=d ** -0.5), f32(1, H, 1, 2 * C, scale=0.1)]
    bias = f32(H, max(L, q0 + Lq), L)
    kmask = (rng.random((3, L)) > 0.3).astype(np.float32)
    kmask[:, 0] = 1.0
    want = np.asarray(jax_node(jnp.asarray(x), *(jnp.asarray(a) for a in w),
                               jnp.asarray(bias[:, :L]), jnp.asarray(kmask),
                               c=C, scale=C ** -0.5, interpret=True))
    before = geom_mod.node_launches
    got = geom_mod.fused_gated_node_attention(
        torch.tensor(x), *(torch.tensor(a) for a in w),
        torch.tensor(bias[:, q0:q0 + Lq]), torch.tensor(kmask), c=C,
        scale=C ** -0.5, q0=q0)
    assert geom_mod.node_launches == before  # the plain version ran
    assert tuple(got.shape) == (3, H, Lq, C)
    real = min(Lq, L - q0)
    np.testing.assert_allclose(got[:, :, :real].numpy(),
                               want[:, :, q0:q0 + real], atol=1e-5, rtol=0)
    assert torch.isfinite(got).all()
    # the square call is the block at q0 = 0 of all L rows
    square = geom_mod.fused_gated_node_attention(
        torch.tensor(x), *(torch.tensor(a) for a in w),
        torch.tensor(bias[:, :L]), torch.tensor(kmask), c=C, scale=C ** -0.5)
    assert torch.equal(square, geom_mod.fused_gated_node_attention(
        torch.tensor(x), *(torch.tensor(a) for a in w),
        torch.tensor(bias[:, :L]), torch.tensor(kmask), c=C, scale=C ** -0.5,
        q0=0))

