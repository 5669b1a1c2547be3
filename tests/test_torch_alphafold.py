"""AlphaFold2 ``model_5`` in the port (``models/alphafold``) against its plain
reference (``models/alphafold/reference.py``) on the CPU, at a tiny size with
seeded random weights: every module of a block, the structure module and
the pLDDT head on the same inputs; the features one a3m gives, bit for bit;
a two-recycle extraction through the extraction entry; the single-view
triangle route against the reference's triangle multiplications.

Tolerances: float32 on both sides, but the port folds every LayerNorm's
affine into the weights that read it and runs the kernels' plain versions,
which sum in other orders: the gaps measured were 2e-7 to 3e-6 of each
output's norm (the structure module's eight shared iterations the most),
so 1e-5 of the norm for a module and 2e-5 after two recycles of the whole
network. The features are integer draws and sums of integers: equal."""
import ast
import math
import os

import numpy as np
import pytest
import torch

from dynamicpdb_tpu_torch.models.alphafold import features as F
from dynamicpdb_tpu_torch.models.alphafold import model as P
from dynamicpdb_tpu_torch.models.alphafold import reference as R
from dynamicpdb_tpu_torch.models.omegafold.model import StructConfig
from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
from dynamicpdb_tpu_torch.ops import geom_triangle as tri_mod
from dynamicpdb_tpu_torch.preprocess import extract_embeddings as ee

torch.set_num_threads(1)

MODULE_TOL = 1e-5
EXTRACT_TOL = 2e-5
DATA = dict(num_recycle=1, max_msa_clusters=5, max_extra_msa=4)
L = 11


def port_cfg() -> P.AlphaFoldConfig:
    return P.AlphaFoldConfig(
        msa_dim=20, pair_dim=16, extra_msa_dim=12, evoformer_blocks=2,
        extra_msa_blocks=1, msa_heads=2, msa_head_dim=6, extra_msa_head_dim=4,
        pair_heads=2, pair_head_dim=5, opm_dim=4,
        struct=StructConfig(node_dim=24, edge_dim=16, num_cycle=8,
                            num_transition=3, num_head=3, num_point_qk=2,
                            num_point_v=3, num_scalar_qk=5, num_scalar_v=5,
                            num_channel=128, num_residual_block=2,
                            hidden_dim=12, num_bins=10), **DATA)


def ref_cfg() -> R.Config:
    return R.Config(
        msa_dim=20, pair_dim=16, single_dim=24, extra_msa_dim=12,
        evoformer_blocks=2, extra_msa_blocks=1, msa_heads=2, msa_head_dim=6,
        extra_msa_head_dim=4, pair_heads=2, pair_head_dim=5, opm_dim=4,
        ipa_heads=3, ipa_scalar=5, ipa_points_qk=2, ipa_points_v=3,
        plddt_hidden=12, plddt_bins=10, num_recycle=1, max_msa_clusters=5,
        max_extra_msa=4)


def a3m(seed: int = 1, rows: int = 12, length: int = L) -> list[str]:
    rng = np.random.default_rng(seed)
    q = "".join(rng.choice(list(R.RESTYPES), length))
    lines = [">query some words", q]
    for i in range(rows):
        row = "".join(c if rng.random() < .6 else
                      rng.choice(list(R.RESTYPES + "-")) for c in q)
        row = "".join(ch + ("ab" if rng.random() < .1 else "") for ch in row)
        lines += [f">r{i}", row]
    return lines


@pytest.fixture(scope="module")
def models():
    sd = P.random_alphafold_state_dict(port_cfg(), 0)
    return (P.alphafold_from_state_dict(sd, device="cpu", **DATA),
            R.alphafold_model(sd, ref_cfg()))


def gap(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def test_the_state_dict_layout_is_the_references():
    with torch.device("meta"):
        ref = {k: tuple(v.shape)
               for k, v in R.AlphaFold(R.Config()).state_dict().items()}
    shapes = P.alphafold_shapes()
    assert shapes == ref
    n = sum(math.prod(s) for s in shapes.values())
    assert 90e6 < n < 95e6, n  # model_5 without the heads left out: ~93M


def test_the_config_comes_back_from_the_shapes():
    cfg = port_cfg()
    sd = P.random_alphafold_state_dict(cfg, 1)
    assert P.infer_config_from_state_dict(sd, **DATA) == cfg


def test_random_weights_follow_the_omegafold_distributions():
    sd = P.random_alphafold_state_dict(port_cfg(), 2)
    ln = sd["evoformer.blocks.0.msa_transition.layer_norm.weight"]
    assert abs(ln.mean() - 1.0) < 0.1 and 0.03 < ln.std() < 0.3
    w = sd["evoformer.blocks.0.msa_transition.linear_1.weight"]
    assert abs(w.std() * math.sqrt(w.shape[1]) - 1.0) < 0.2
    b = sd["evoformer.blocks.0.msa_transition.linear_1.bias"]
    assert 0.03 < b.std() < 0.3
    assert np.array_equal(sd["evoformer.linear_single.weight"],
                          P.random_alphafold_state_dict(port_cfg(), 2)[
                              "evoformer.linear_single.weight"])


def test_a_state_dict_of_another_model_is_refused():
    sd = P.random_alphafold_state_dict(port_cfg(), 0)
    sd["extra.key"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="not an AlphaFold2 state dict"):
        P.alphafold_from_state_dict(sd, device="cpu")


# ---------------------------------------------------------------------------
# the modules, one at a time on the same inputs
# ---------------------------------------------------------------------------
def _block_cases():
    def run(port, ref, which):
        g = torch.Generator().manual_seed(3)
        m = torch.randn(5, L, 20, generator=g)
        e = torch.randn(4, L, 12, generator=g)
        z = torch.randn(L, L, 16, generator=g)
        single = torch.randn(L, 24, generator=g)
        mask = torch.ones(L)
        bp, br = port.evoformer[1], ref.evoformer.blocks[1]
        xp, xr = port.extra_msa_stack[0], ref.extra_msa_stack.blocks[0]
        row, xrow = br.msa_row_attention, xr.msa_row_attention
        cases = {
            "msa_row_attention": lambda: (
                P.msa_row_attention(bp.msa_row, m, z, 6, plain=False),
                row(m, row.pair_bias(z))),
            "msa_column_attention": lambda: (
                P.msa_column_attention(bp.msa_col, m, 6),
                br.msa_column_attention(m.transpose(0, 1)).transpose(0, 1)),
            "msa_transition": lambda: (
                P.transition(bp.msa_transition, m), br.msa_transition(m)),
            "outer_product_mean": lambda: (
                P.outer_product_mean(bp.opm, m, cols=4),
                br.outer_product_mean(m)),
            "triangle_multiplication_outgoing": lambda: (
                P.triangle_multiplication(bp.tri_mul[0], z, 0, mask) - z,
                br.triangle_multiplication_outgoing(z)),
            "triangle_multiplication_incoming": lambda: (
                P.triangle_multiplication(bp.tri_mul[1], z, 1, mask) - z,
                br.triangle_multiplication_incoming(z)),
            "triangle_attention_starting": lambda: (
                P.triangle_attention(bp.tri_att[0], z, 5),
                br.triangle_attention_starting(z)),
            "triangle_attention_ending": lambda: (
                P.triangle_attention(bp.tri_att[1], z.transpose(0, 1),
                                     5).transpose(0, 1),
                br.triangle_attention_ending(z)),
            "pair_transition": lambda: (
                P.transition(bp.pair_transition, z), br.pair_transition(z)),
            "extra_msa_row_attention": lambda: (
                P.msa_row_attention(xp.msa_row, e, z, 4, plain=True, rows=3),
                xrow(e, xrow.pair_bias(z))),
            "extra_msa_column_global_attention": lambda: (
                P.msa_column_global_attention(xp.msa_col, e, 4),
                xr.msa_column_global_attention(e)),
            "evoformer_block": lambda: (
                torch.cat([t.flatten() for t in P.evoformer_block(bp, m, z,
                                                                  mask)]),
                torch.cat([t.flatten() for t in br(m, z)])),
            "extra_msa_block": lambda: (
                torch.cat([t.flatten() for t in P.evoformer_block(xp, e, z,
                                                                  mask)]),
                torch.cat([t.flatten() for t in xr(e, z)])),
            "structure_module": lambda: (
                torch.cat([t.flatten() for t in port.structure_module(
                    single, z, mask)]),
                torch.cat([t.flatten() for t in ref.structure_module(
                    single, z)])),
            "plddt_head": lambda: (port.plddt_head(single),
                                   ref.plddt_head(single)),
        }
        return cases[which]()
    return run


MODULES = ("msa_row_attention", "msa_column_attention", "msa_transition",
           "outer_product_mean", "triangle_multiplication_outgoing",
           "triangle_multiplication_incoming", "triangle_attention_starting",
           "triangle_attention_ending", "pair_transition",
           "extra_msa_row_attention", "extra_msa_column_global_attention",
           "evoformer_block", "extra_msa_block", "structure_module",
           "plddt_head")


@pytest.mark.parametrize("which", MODULES)
@torch.no_grad()
def test_each_module_matches_the_reference(models, which):
    got, want = _block_cases()(*models, which)
    assert got.shape == want.shape
    assert gap(got, want) < MODULE_TOL, gap(got, want)


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------
def test_the_a3m_parser_counts_insertions_and_drops_repeats():
    lines = [">q desc", "ACDEF", ">a", "AC-EF", ">b", "AcCDddEF", ">c",
             "AC-EF", ">d", "XBZ-Ugg"]
    msa = F.parse_a3m(lines)
    assert msa.name == "q"
    # b aligns to the query itself and c repeats a: both dropped
    assert msa.tokens.tolist() == [[0, 4, 3, 6, 13], [0, 4, 21, 6, 13],
                                   [20, 3, 6, 21, 4]]
    assert msa.deletions.tolist() == [[0] * 5] * 3
    msa = F.parse_a3m([">q", "ACDEF", ">a", "AcCDddEHgg"])
    assert msa.deletions.tolist() == [[0] * 5, [0, 1, 0, 2, 0]]
    name, tokens, deletions = R.parse_a3m([">q", "ACDEF", ">a", "AcCDddEHgg"])
    assert tokens.tolist() == msa.tokens.tolist()
    assert deletions.tolist() == msa.deletions.tolist()
    with pytest.raises(ValueError, match="aligned columns"):
        F.parse_a3m([">q", "ACDEF", ">a", "ACD"])


@pytest.mark.parametrize("rows", [12, 3], ids=["extra-rows", "no-extra-rows"])
def test_the_features_are_the_references(rows):
    lines = a3m(rows=rows)
    msa = F.parse_a3m(lines)
    name, tokens, deletions = R.parse_a3m(lines)
    assert name == msa.name == "query"
    assert np.array_equal(tokens, msa.tokens)
    assert np.array_equal(deletions, msa.deletions)
    inputs = F.sequence_features(msa, "cpu", num_recycles=3, max_clusters=5,
                                 max_extra=4, replace_fraction=0.15)
    cfg = ref_cfg()
    for r, got in enumerate(inputs["recycles"]):
        msa_feat, extra_feat = R.recycle_features(name, tokens, deletions, r,
                                                  cfg, "cpu")
        assert torch.equal(got["msa_feat"], msa_feat)
        assert torch.equal(got["extra_msa_feat"], extra_feat)
    assert inputs["recycles"][0]["msa_feat"].shape == (min(5, rows + 1), L,
                                                       49)
    assert inputs["recycles"][0]["extra_msa_feat"].shape[-1] == 25
    # each recycle draws afresh
    assert not torch.equal(inputs["recycles"][0]["msa_feat"],
                           inputs["recycles"][1]["msa_feat"])


def test_the_masked_msa_replaces_as_alphafold2_does():
    """At depth 400 and length 300: 15% of the centres' positions
    replaced, of them ~70% by the mask token; every extra row assigned."""
    lines = a3m(seed=4, rows=399, length=300)
    msa = F.parse_a3m(lines)
    tokens = torch.as_tensor(msa.tokens).long()
    draws = F.recycle_draws("x", 0, *tokens.shape, max_clusters=128,
                            max_extra=64, replace_fraction=0.15)
    centres = F.masked_centres(tokens, draws)
    assert 0.13 < draws["replaced"].mean() < 0.17
    masked = (centres == F.MASK).float().mean().item()
    assert 0.095 < masked < 0.115  # 0.15 x 0.7
    assert draws["centres"][0] == 0 and len(draws["extra"]) == len(
        msa.tokens) - 128


# ---------------------------------------------------------------------------
# the whole extraction
# ---------------------------------------------------------------------------
def test_a_two_recycle_extraction_matches_the_reference(models):
    port, ref = models
    lines = a3m()
    before = (geom_mod.node_launches, geom_mod.geom_launches,
              tri_mod.tri_view_launches)
    (name, arrays, stats), = ee.extract_alphafold_embeddings(
        [("prot", lines)], port)
    assert (geom_mod.node_launches, geom_mod.geom_launches,
            tri_mod.tri_view_launches) == before  # the CPU launches nothing
    want = R.extract(ref, lines, name="prot")
    assert name == "prot" and stats["n_res"] == L
    for k in ("node_repr", "edge_repr", "single_repr"):
        assert arrays[k].shape == want[k].shape
        assert gap(arrays[k], want[k]) < EXTRACT_TOL, (k, gap(arrays[k],
                                                              want[k]))
    assert abs(float(arrays["confidence"]) - want["confidence"]) < 1e-5
    assert np.abs(stats["plddt"] - want["plddt"]).max() < 1e-5


def test_the_cli_writes_the_npz(tmp_path):
    cfg = port_cfg()
    sd = P.random_alphafold_state_dict(cfg, 5)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "w.pt")
    (tmp_path / "msas").mkdir()
    for name, seed in (("b", 2), ("a", 3)):
        (tmp_path / "msas" / f"{name}.a3m").write_text(
            "\n".join(a3m(seed)) + "\n")
    records = ee.main(["--model", "alphafold2", "--a3m",
                       str(tmp_path / "msas"), "--out-dir",
                       str(tmp_path / "out"), "--weights",
                       str(tmp_path / "w.pt"), "--device", "cpu"])
    assert [r["name"] for r in records] == ["a", "b"]
    with np.load(records[0]["path"]) as z:
        assert {k: z[k].shape for k in z.files} == {
            "node_repr": (L, 20), "edge_repr": (L, L, 16),
            "single_repr": (L, 24), "confidence": ()}
        rc = ref_cfg()  # model_5's data settings, as the CLI runs
        rc.num_recycle, rc.max_msa_clusters, rc.max_extra_msa = 3, 512, 1024
        want = R.extract(R.alphafold_model(sd, rc), a3m(3), name="a")
        assert gap(z["edge_repr"], want["edge_repr"]) < EXTRACT_TOL


# ---------------------------------------------------------------------------
# the single-view triangle route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("view", [0, 1], ids=["outgoing", "incoming"])
@torch.no_grad()
def test_the_single_view_route_is_a_triangle_multiplication(view):
    """``geom_triangle_view`` (the CPU path: its plain einsums) against the
    reference's triangle multiplication, whose weights it takes folded."""
    d, n = 16, 9
    torch.manual_seed(view)
    tm = R.TriangleMultiplication(d, outgoing=view == 0)
    for p in tm.parameters():
        p.add_(0.1 * torch.randn_like(p))
    sd = {f"t.{k}": v for k, v in tm.state_dict().items()}
    params = P._tri_mul_params(sd, "t.")
    z = torch.randn(n, n, d)
    x = torch.nn.functional.layer_norm(z, (d,))
    got = tri_mod.geom_triangle_view(
        x, z, torch.ones(n), params.act_w, params.act_b, params.out_w,
        params.out_b, view=view)
    assert gap(got - z, tm(z)) < MODULE_TOL
    plain = tri_mod.geom_triangle_view_plain(
        x, z, torch.ones(n), params.act_w, params.act_b, params.out_w,
        params.out_b, view=view)
    assert torch.equal(got, plain)


def test_the_single_view_wrapper_checks_its_layout():
    d, n = 128, 16
    args = [torch.zeros(n, n, d)] * 3 + [torch.ones(n)] + [
        torch.zeros(d, 5 * d), torch.zeros(5 * d), torch.zeros(d, d),
        torch.zeros(d)]
    tri_mod.kernel_inputs(*args, q0=0, views=1)
    with pytest.raises(ValueError, match="act_w has shape"):
        tri_mod.kernel_inputs(*args[:4], torch.zeros(d, 2, 5 * d),
                              *args[5:], q0=0, views=1)
    with pytest.raises(ValueError, match="view=2"):
        tri_mod.geom_triangle_view(*args[:1], *args[2:], view=2)


# ---------------------------------------------------------------------------
# the reference stands alone
# ---------------------------------------------------------------------------
def test_the_reference_imports_only_torch_and_numpy():
    path = R.__file__
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"__future__", "math", "zlib", "numpy", "torch"}, roots
    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "h100bench", "reference", "models", "alphafold",
        "model.py")
    with open(bench) as f, open(path) as g:
        # the benchmark's frozen copy: the same code under its own
        # docstring
        assert f.read().split('"""', 2)[2] == g.read().split('"""', 2)[2]
