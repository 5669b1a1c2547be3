"""The OmegaFold modules of the PyTorch port (models/omegafold/) against
the JAX package's, one function at a time, on one set of weights.

The weights are ``weights.random_omegafold_state_dict`` (numpy, seeded) at
a tiny configuration; the same dict feeds the JAX package's
``params_from_state_dict`` and the port's strict loader. Inputs are made
with numpy from a seed. Both sides run float32; tolerances are stated per
test (sums of a few hundred unit-scale terms in another order: 1e-5 for a
single module, 1e-4 for the stacks). Also: the pseudo-MSA pipeline is
bitwise the JAX one, the state dict survives JAX params and back bit for
bit, and the release configuration counts 795M parameters."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.models.omegafold import atoms as jax_atoms
from dynamicpdb_tpu.models.omegafold import core as jax_core
from dynamicpdb_tpu.models.omegafold import embedders as jax_emb
from dynamicpdb_tpu.models.omegafold import geoformer as jax_geo
from dynamicpdb_tpu.models.omegafold import model as jax_model
from dynamicpdb_tpu.models.omegafold import pipeline as jax_pipe
from dynamicpdb_tpu.models.omegafold import plm as jax_plm
from dynamicpdb_tpu.models.omegafold import structure as jax_struct
from dynamicpdb_tpu_torch.models.omegafold import atoms, core, geoformer, pipeline
from dynamicpdb_tpu_torch.models.omegafold.model import (
    OmegaFoldConfig,
    StructConfig,
    get_all_confidence,
    infer_config_from_state_dict,
    omegafold_from_state_dict,
)
from dynamicpdb_tpu_torch.models.omegafold.plm import PLMConfig
from dynamicpdb_tpu_torch.weights import (
    omegafold_shapes,
    omegafold_state_dict_from_jax,
    random_omegafold_state_dict,
)

torch.set_num_threads(1)

FASTA = [">short\n", "MKTAYIAKQRQISFVK\n", ">long\n", "GSHMLEDPVAGQWLKKAEEGCY\n"]


def tiny_cfg() -> OmegaFoldConfig:
    """Every dimension of the release model, narrow (the JAX package's own
    tests' _small_cfg), with c = 8 for both attentions."""
    return OmegaFoldConfig(
        plm=PLMConfig(node=32, num_layers=3, proj_dim=48, attn_dim=16),
        node_dim=24, edge_dim=16, geo_num_blocks=2, attn_c=8, attn_n_head=2,
        transition_multiplier=2, opm_dim=10, geom_c=8, geom_head=2,
        struct=StructConfig(node_dim=20, edge_dim=16, num_cycle=2,
                            num_transition=2, num_head=2, num_point_qk=4,
                            num_point_v=4, num_scalar_qk=6, num_scalar_v=6,
                            num_channel=20, num_residual_block=2,
                            hidden_dim=18, num_bins=10))


@pytest.fixture(scope="module")
def weights():
    """(state dict, JAX params, JAX config, port model), one set."""
    sd = random_omegafold_state_dict(tiny_cfg(), 0)
    params, jcfg = jax_model.params_from_state_dict(sd)
    return sd, params, jcfg, omegafold_from_state_dict(sd, device="cpu")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x)


def close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def rnd(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cycle(seed=0, num_pseudo_msa=3, pad_multiple=0):
    cycles = next(jax_pipe.fasta2inputs(FASTA[:2], num_pseudo_msa=num_pseudo_msa,
                                        num_cycle=1, pad_multiple=pad_multiple))[1]
    return cycles[0]


# ---------------------------------------------------------------------------
def test_fasta2inputs_is_bitwise_the_jax_pipeline():
    for pad in (0, 8):
        mine = list(pipeline.fasta2inputs(FASTA, num_pseudo_msa=5,
                                          num_cycle=3, pad_multiple=pad))
        ref = list(jax_pipe.fasta2inputs(FASTA, num_pseudo_msa=5,
                                         num_cycle=3, pad_multiple=pad))
        assert [n for n, _ in mine] == [n for n, _ in ref] == ["short", "long"]
        for (_, a), (_, b) in zip(mine, ref):
            for ca, cb in zip(a, b):
                assert ca.keys() == cb.keys()
                for k in ca:
                    x, y = np.asarray(ca[k]), np.asarray(cb[k])
                    assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("lines,match", [
    (["MKT\n"], "before any"), ([">a\n", ">b\n", "MK\n"], "no sequence"),
])
def test_parse_fasta_refuses_what_jax_refuses(lines, match):
    with pytest.raises(ValueError, match=match):
        pipeline.parse_fasta(lines)
    with pytest.raises(ValueError, match=match):
        jax_pipe.parse_fasta(lines)


@pytest.mark.parametrize("unbiased", [False, True])
def test_layer_norm_f32(unbiased):
    x, w, b = rnd(0, 3, 5, 12) * 3 + 1, rnd(1, 12), rnd(2, 12)
    got = core.layer_norm_f32(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b), unbiased=unbiased)
    want = jax_core.layer_norm_f32(x, w, b, unbiased=unbiased)
    close(got, want, 2e-6)


def test_core_primitives():
    q, k, v = rnd(0, 2, 6, 8), rnd(1, 2, 6, 8), rnd(2, 2, 6, 5)
    bias = rnd(3, 2, 1, 6)
    got, edge = core.attention(torch.tensor(q), torch.tensor(k), 0.3,
                               torch.tensor(v), torch.tensor(bias),
                               return_edge=True, edge_reduction_dim=-3)
    want, wedge = jax_core.attention(q, k, 0.3, v, bias, return_edge=True,
                                     edge_reduction_dim=-3)
    close(got, want, 1e-6)
    close(edge, wedge, 1e-6)
    x = rnd(4, 3, 7, 2, 16)
    close(core.rope(torch.tensor(x), 1), jax_core.rope(x, 1), 2e-6)
    w, b = rnd(5, 2, 16), rnd(6, 2, 16)
    for g, r in zip(core.multi_headed_scaling(torch.tensor(x[..., 0, :]),
                                              torch.tensor(w), torch.tensor(b)),
                    jax_core.multi_headed_scaling(x[..., 0, :], w, b)):
        close(g, r, 0)
    table = rnd(7, 9, 3)
    close(core.relpos_embedding(torch.tensor(table), 11),
          jax_core.relpos_embedding(table, 11), 0)
    n = np.asarray([1.0, 16.0, 300.0], np.float32)
    close(core.gau_qk_scaling(torch.tensor(n), 16),
          jax_core.gau_qk_scaling(n, 16), 1e-7)


def test_gated_attention_unit(weights):
    _, params, jcfg, port = weights
    lp = jax.tree_util.tree_map(lambda a: a[1], params.plm.layers)
    node, bias = rnd(0, 4, 10, 32), rnd(1, 4, 1, 10)
    scaling = np.full((4, 1, 1), 0.4, np.float32)
    got, edge = port.omega_plm.layers[1].gau(
        torch.tensor(node), torch.tensor(scaling), torch.tensor(bias))
    want, wedge = jax_core.gated_attention_unit(
        lp, node, scaling, bias, proj_dim=jcfg.plm.proj_dim,
        attn_dim=jcfg.plm.attn_dim)
    close(got, want, 1e-5)
    close(edge, wedge, 1e-5)


def test_plm_with_a_masked_pseudo_msa(weights):
    _, params, jcfg, port = weights
    cyc = _cycle(num_pseudo_msa=4)
    assert (cyc["p_msa"] == 21).any()  # token dropout is exercised
    got = port.omega_plm(torch.tensor(cyc["p_msa"]),
                         torch.tensor(cyc["p_msa_mask"]))
    want = jax_plm.omega_plm(params.plm, jcfg.plm, cyc["p_msa"],
                             cyc["p_msa_mask"])
    close(got[0], want[0], 1e-5)
    close(got[1], want[1], 1e-5)


def test_embedders(weights):
    _, params, _, port = weights
    fasta = np.asarray([3, 0, 7, 20, 11, 5, 7, 2], np.int64)
    L = len(fasta)
    out = rnd(0, L, L, 16)
    close(port.input_embedder(torch.tensor(fasta), torch.tensor(out)),
          jax_emb.edge_embedder(params.input_embedder, fasta, out), 1e-6)
    prev_node, prev_edge = rnd(1, L, 24), rnd(2, L, L, 16)
    prev_x = rnd(3, L, 14, 3) * 6  # spreads the distogram over its bins
    node, edge = rnd(4, 3, L, 24), rnd(5, L, L, 16)
    got = port.recycle_embedder(*(torch.tensor(a) for a in (
        fasta, prev_node, prev_edge, prev_x, node, edge)))
    want = jax_emb.recycle_embedder(params.recycle, *(jnp.asarray(a) for a in (
        fasta, prev_node, prev_edge, prev_x, node, edge)))
    close(got[0], want[0], 2e-6)
    close(got[1], want[1], 2e-6)


def test_attention_w_edge_bias_with_a_partial_row_mask(weights):
    """The full [M, L] mask: each pseudo-MSA row masks its own keys (the
    JAX package's round-1 bug passed row 0's mask to every row)."""
    _, params, jcfg, port = weights
    M, L = 4, 9
    mask = np.ones((M, L), np.float32)
    mask[1, 6:] = 0
    mask[2, :3] = 0
    mask[3, ::2] = 0
    node, edge = rnd(0, M, L, 24), rnd(1, L, L, 16)
    jp = jax.tree_util.tree_map(lambda a: a[0], params.geoformer.blocks)
    got = geoformer.attention_w_edge_bias(
        port.omega_fold_cycle.geoformer.blocks[0].attention_w_edge_bias,
        torch.tensor(node), torch.tensor(edge), torch.tensor(mask))
    want = jax.jit(functools.partial(jax_geo.attention_w_edge_bias,
                                     c=jcfg.attn_c))(jp.attn_edge_bias, node,
                                                     edge, mask)
    close(got, want, 1e-5)


@pytest.mark.parametrize("pad_safe", [False, True])
def test_geometric_attention(weights, pad_safe):
    _, params, jcfg, port = weights
    L = 9
    mask = np.ones(L, np.float32)
    mask[6:] = 0  # padding, which pad_safe keeps out
    edge = rnd(0, L, L, 16)
    jp = jax.tree_util.tree_map(lambda a: a[1], params.geoformer.blocks)
    got = geoformer.geometric_attention(
        port.omega_fold_cycle.geoformer.blocks[1].geometric_attention[1],
        torch.tensor(edge), torch.tensor(mask), pad_safe=pad_safe)
    want = jax.jit(functools.partial(
        jax_geo.geometric_attention, c=jcfg.geom_c, n_head=jcfg.geom_head,
        pad_safe=pad_safe))(jp.geom[1], edge, mask)
    close(got, want, 1e-5)


@pytest.mark.parametrize("pad_safe", [False, True])
def test_geoformer_block(weights, pad_safe):
    _, params, jcfg, port = weights
    cyc = _cycle(num_pseudo_msa=3, pad_multiple=8 if pad_safe else 0)
    L = cyc["p_msa"].shape[-1]
    node, edge = rnd(0, 4, L, 24), rnd(1, L, L, 16)
    jp = jax.tree_util.tree_map(lambda a: a[0], params.geoformer.blocks)
    got = geoformer.geoformer_block(
        port.omega_fold_cycle.geoformer.blocks[0], torch.tensor(node),
        torch.tensor(edge), torch.tensor(cyc["p_msa_mask"]),
        pad_safe=pad_safe)
    want = jax.jit(functools.partial(
        jax_geo.geoformer_block, attn_c=jcfg.attn_c, geom_c=jcfg.geom_c,
        geom_head=jcfg.geom_head, pad_safe=pad_safe))(
            jp, node, edge, cyc["p_msa_mask"])
    close(got[0], want[0], 1e-4)
    close(got[1], want[1], 1e-4)


def test_structure_atoms_and_confidence(weights):
    _, params, jcfg, port = weights
    fasta = np.asarray([3, 0, 7, 20, 11, 5, 7, 2, 19, 4], np.int64)
    L = len(fasta)
    mask = np.ones(L, np.float32)
    mask[-2:] = 0
    node, edge = rnd(0, L, 20), rnd(1, L, L, 16)
    cyc = port.omega_fold_cycle
    node_s, (rots, trans), tors = cyc.structure_module(
        torch.tensor(node), torch.tensor(edge), torch.tensor(mask))
    w_node, (w_rots, w_trans), w_tors = jax.jit(functools.partial(
        jax_struct.structure_module, ipa_dims=jcfg.struct_ipa_dims))(
            params.structure, node, edge, mask)
    close(node_s, w_node, 1e-4)
    close(rots, w_rots, 1e-5)
    close(trans, w_trans, 1e-4)
    close(tors, w_tors, 1e-5)

    f = torch.tensor(fasta)
    for angles in (w_tors, np.asarray(w_tors)[:, 2:]):  # 7 and 5 torsions
        pos, m14 = atoms.frames_and_torsions_to_atom14(
            torch.tensor(np.asarray(w_rots)), torch.tensor(np.asarray(w_trans)),
            torch.tensor(mask).bool(), torch.tensor(np.asarray(angles)), f)
        w_pos, w_m14 = jax.jit(jax_atoms.frames_and_torsions_to_atom14)(
            w_rots, w_trans, mask.astype(bool), angles, fasta)
        close(pos, w_pos, 1e-4)
        assert np.array_equal(m14.numpy(), np.asarray(w_m14))

    plddt = cyc.confidence_head(torch.tensor(np.asarray(w_node)))
    w_plddt = jax_struct.confidence_head(params.confidence, w_node)
    close(plddt, w_plddt, 1e-6)
    ca = rnd(2, L, 3) * 8
    close(get_all_confidence(plddt, torch.tensor(ca), torch.tensor(mask)),
          jax_model.get_all_confidence(w_plddt, ca, mask), 1e-6)


def test_state_dict_survives_jax_params_bit_for_bit(weights):
    sd, params, _, _ = weights
    back = omegafold_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tiny_cfg())
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k


def test_config_from_the_state_dict(weights):
    sd = weights[0]
    assert infer_config_from_state_dict(sd) == tiny_cfg()
    with_prefix = {"module." + k: v for k, v in sd.items()}
    model = omegafold_from_state_dict(with_prefix, device="cpu")
    assert model.cfg == tiny_cfg()
    missing = dict(sd)
    del missing["omega_fold_cycle.geoformer.blocks.1.out_product.out_bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        omegafold_from_state_dict(missing, device="cpu")


def test_release_configuration_counts_795m_parameters():
    """Upstream OmegaFold's make_config(): 795M parameters (the count the
    JAX package's docs record); its shapes infer back to itself."""
    shapes = omegafold_shapes(OmegaFoldConfig())
    assert sum(math.prod(s) for s in shapes.values()) == 795_074_210
    fake = {k: np.empty(s, np.float32) if math.prod(s) < 10 ** 6 else
            type("Shaped", (), {"shape": s})() for k, s in shapes.items()}
    assert infer_config_from_state_dict(fake) == OmegaFoldConfig()
    # the JAX importer reads the same keys at the same shapes
    jcfg = jax_model.infer_config_from_state_dict(fake)
    assert (jcfg.node_dim, jcfg.edge_dim, jcfg.plm.num_layers,
            jcfg.plm.proj_dim, jcfg.geom_head, jcfg.struct_num_head) == (
        256, 128, 66, 2560, 4, 12)
