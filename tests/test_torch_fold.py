"""The fold path of the PyTorch port against the JAX package, on the CPU:
``omegafold_embed``'s ``return_structure`` and ``predict_with_confidence``,
``fold_cli`` (FASTA -> PDB with pLDDT B-factors and a JSON sidecar), its
refusal of gap tokens, and ``embeddings.extract_with_omegafold`` against a
stub OmegaFold package.

Weights: one seeded random state dict at the tiny OmegaFold widths
(tests/test_torch_omegafold.tiny_cfg) fed to both packages' loaders.

Tolerances, float32 on both sides through the PLM, two GeoFormer blocks,
the structure module and up to four recycles: pos14 and pLDDT 1e-4 (the
extraction slice's bar for the reprs), confidences 1e-5. PDB files hold
coordinates to 3 decimals and B-factors to 2, so the files' coordinates
agree to 2e-3 and their B-factors (pLDDT x 100) to 0.02."""
import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu import fold_cli as j_fold_cli
from dynamicpdb_tpu.models.omegafold import model as jax_model
from dynamicpdb_tpu.models.omegafold import pipeline as jax_pipe
from dynamicpdb_tpu_torch import fold_cli
from dynamicpdb_tpu_torch.analysis.pdb_io import read_pdb
from dynamicpdb_tpu_torch.models.omegafold import pipeline
from dynamicpdb_tpu_torch.models.omegafold.model import omegafold_embed
from dynamicpdb_tpu_torch.preprocess.embeddings import extract_with_omegafold
from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict
from tests.test_torch_omegafold import FASTA, tiny_cfg, weights  # noqa: F401

torch.set_num_threads(1)

NUM_CYCLES = 4
POS_ATOL = 1e-4
CONF_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_cycles(weights):  # noqa: F811
    """Every JAX cycle's confidence, pLDDT and pos14 on the first FASTA
    sequence, and JAX omegafold_embed(return_structure=True) in both
    selection modes, on one compile."""
    _, params, jcfg, _ = weights
    _, cycles = next(jax_pipe.fasta2inputs(FASTA, num_pseudo_msa=4,
                                           num_cycle=NUM_CYCLES))
    L = cycles[0]["p_msa"].shape[-1]
    prev = (jnp.zeros((L, jcfg.node_dim)),
            jnp.zeros((L, L, jcfg.edge_dim)), jnp.zeros((L, 14, 3)))
    fn = jax_model._jitted_cycle(jcfg, False, False)
    per_cycle = []
    for cyc in cycles:
        _, _, conf, plddt, prev = fn(params, jnp.asarray(cyc["p_msa"]),
                                     jnp.asarray(cyc["p_msa_mask"]), *prev)
        per_cycle.append((float(conf), np.asarray(plddt),
                          np.asarray(prev[2])))
    embeds = {mode: jax_model.omegafold_embed(
        params, jcfg, cycles, jit=True, return_structure=True,
        predict_with_confidence=mode) for mode in (True, False)}
    return cycles, per_cycle, embeds


def _selected(confs, predict_with_confidence):
    """The JAX loop's rule: `not predict_with_confidence or conf >
    max_conf or final is None`."""
    best, chosen = 0.0, None
    for i, c in enumerate(confs):
        if not predict_with_confidence or c > best or chosen is None:
            best, chosen = max(best, c), i
    return chosen


@pytest.mark.parametrize("predict_with_confidence", [True, False],
                         ids=["most-confident", "last-cycle"])
def test_embed_return_structure_matches_jax(weights, jax_cycles,  # noqa: F811
                                            predict_with_confidence):
    port = weights[3]
    cycles, per_cycle, embeds = jax_cycles
    edge, node, conf, struct = embeds[predict_with_confidence]
    confs = [c for c, _, _ in per_cycle]
    chosen = _selected(confs, predict_with_confidence)
    # the JAX loop returns that cycle's fold
    np.testing.assert_array_equal(np.asarray(struct["pos14"]),
                                  per_cycle[chosen][2])

    got = omegafold_embed(port, cycles, return_structure=True,
                          predict_with_confidence=predict_with_confidence)
    assert got.cycle == chosen
    assert got.pos14.dtype == got.plddt.dtype == torch.float32
    assert got.pos14.shape == (cycles[0]["p_msa"].shape[-1], 14, 3)
    np.testing.assert_allclose(got.confidences, confs, atol=CONF_ATOL, rtol=0)
    assert abs(got.confidence - conf) < CONF_ATOL
    np.testing.assert_allclose(got.pos14.numpy(), np.asarray(struct["pos14"]),
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(got.plddt.numpy(), np.asarray(struct["plddt"]),
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(got.node.numpy(), np.asarray(node),
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(got.edge.numpy(), np.asarray(edge),
                               atol=POS_ATOL, rtol=0)


def test_the_two_selection_modes_keep_different_cycles(jax_cycles):
    """The fixture's cycles make the two modes differ, so the test above
    checks both selections, not one twice."""
    confs = [c for c, _, _ in jax_cycles[1]]
    assert _selected(confs, True) != _selected(confs, False)


def test_embed_without_structure_is_unchanged(weights, jax_cycles):  # noqa: F811
    port = weights[3]
    cycles = jax_cycles[0]
    a = omegafold_embed(port, cycles)
    b = omegafold_embed(port, cycles, return_structure=True)
    assert a.pos14 is None and a.plddt is None
    assert a.cycle == b.cycle and a.confidence == b.confidence
    assert torch.equal(a.node, b.node) and torch.equal(a.edge, b.edge)


def _b_factors(path):
    """Per-atom B-factors of a PDB file's ATOM records, in file order."""
    with open(path) as f:
        return np.asarray([float(line[60:66]) for line in f
                           if line.startswith("ATOM")])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("fold")
    sd = random_omegafold_state_dict(tiny_cfg(), 3)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, d / "w.pt")
    (d / "seqs.fasta").write_text("".join(FASTA))
    return d


@pytest.mark.parametrize("pad_multiple", [0, 8], ids=["exact", "padded"])
def test_fold_cli_matches_jax(checkpoint, pad_multiple):
    d = checkpoint
    common = ["--fasta", str(d / "seqs.fasta"), "--weights", str(d / "w.pt"),
              "--num-cycles", "2", "--num-pseudo-msa", "2", "--pad-multiple",
              str(pad_multiple)]
    want_dir, got_dir = d / f"jax{pad_multiple}", d / f"port{pad_multiple}"
    j_fold_cli.main(common + ["--out-dir", str(want_dir), "--no-scan"])
    records = fold_cli.main(common + ["--out-dir", str(got_dir), "--device",
                                      "cpu"])
    assert [r["name"] for r in records] == ["short", "long"]
    for r, seq in zip(records, (FASTA[1], FASTA[3])):
        n = len(seq.strip())
        assert r["n_res"] == n
        assert r["padded"] == (-(-n // pad_multiple) * pad_multiple
                               if pad_multiple else n)
        got, want = (read_pdb(str(x / f"{r['name']}.pdb"))
                     for x in (got_dir, want_dir))
        for g, w, name in zip(got, want, ("atom37", "mask", "aatype",
                                          "residue_index")):
            if name == "atom37":
                np.testing.assert_allclose(g, w, atol=2e-3, rtol=0)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
        assert got[0].shape == (n, 37, 3)
        np.testing.assert_allclose(
            _b_factors(got_dir / f"{r['name']}.pdb"),
            _b_factors(want_dir / f"{r['name']}.pdb"), atol=0.02, rtol=0)
        with open(want_dir / f"{r['name']}.json") as f:
            side_want = json.load(f)
        with open(got_dir / f"{r['name']}.json") as f:
            side_got = json.load(f)
        assert sorted(side_got) == sorted(side_want) == [
            "confidence_overall", "mean_plddt"]
        for k in side_want:
            assert abs(side_got[k] - side_want[k]) < CONF_ATOL, k
        assert side_got["confidence_overall"] == r["confidence_overall"]


def test_fold_writes_pdb_that_reads_back(weights, tmp_path):  # noqa: F811
    """fold()'s atoms are the selected cycle's pos14 in atom37 order; the
    PDB of them reads back with the same residues and CA coordinates."""
    from dynamicpdb_tpu_torch.analysis.pdb_io import write_pdb

    port = weights[3]
    name, result = next(fold_cli.fold(FASTA, port, num_cycles=2,
                                      num_pseudo_msa=2))
    emb = omegafold_embed(port, next(pipeline.fasta2inputs(
        FASTA, num_pseudo_msa=2, num_cycle=2))[1], return_structure=True)
    np.testing.assert_array_equal(result["pos14"], emb.pos14.numpy())
    np.testing.assert_array_equal(result["atom37"][:, 1],
                                  emb.pos14[:, 1].numpy())
    plddt = result["plddt"]
    assert plddt.shape == (16,) and (plddt >= 0).all() and (plddt <= 1).all()
    pdb = tmp_path / f"{name}.pdb"
    write_pdb(str(pdb), result["atom37"], result["aatype"],
              atom37_mask=result["atom37_mask"])
    atom37, _, aatype, _ = read_pdb(str(pdb))
    assert (aatype == result["aatype"]).all()
    np.testing.assert_allclose(atom37[:, 1], result["atom37"][:, 1],
                               atol=1e-2)


def test_fold_rejects_gap_tokens(weights):  # noqa: F811
    """'-' tokenizes to 21, outside the atom tables and the PDB writer:
    refused before the fold, with the JAX package's message."""
    port = weights[3]
    gap_fasta = [">g\n", "MKTA-YIAK\n"]
    with pytest.raises(ValueError, match="gap"):
        next(fold_cli.fold(gap_fasta, port, num_cycles=1, num_pseudo_msa=1))


def test_fold_cli_default_device_raises_without_a_card(checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fold_cli.main(["--fasta", str(checkpoint / "seqs.fasta"), "--weights",
                       str(checkpoint / "w.pt"), "--out-dir", str(tmp_path)])


STUB = '''
import numpy as np
import torch


class OmegaFoldModel:
    """A stand-in for an OmegaFold checkout's extractor: reprs made from
    the sequence length, and the arguments it was built with recorded."""

    def __init__(self, weights, device):
        self.args = (weights, device)

    def inference(self, lines, num_cycles):
        n = len(lines[1])
        g = torch.Generator().manual_seed(n + num_cycles)
        node = torch.randn(n, 256, generator=g)
        edge = torch.randn(n, n, 128, generator=g)
        np.save(ARGS, np.array([*self.args, str(num_cycles), lines[0]]))
        return [edge], [node]
'''


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "bad-widths"])
def test_extract_with_omegafold_runs_the_external_extractor(tmp_path, valid):
    """The subprocess contract: the checkout's package on sys.path, the
    weights, device and cycles passed through, the first sequence's reprs
    saved and validated (a wrong width is refused)."""
    pkg = tmp_path / "checkout" / "omegafold"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    stub = STUB.replace("ARGS", repr(str(tmp_path / "args.npy")))
    if not valid:
        stub = stub.replace("n, 256", "n, 255")
    (pkg / "__main__.py").write_text(stub)
    fasta = tmp_path / "x.fasta"
    fasta.write_text(">prot\nMKTAYIAK\n")
    out = str(tmp_path / "prot.npz")
    kw = dict(omegafold_repo=str(tmp_path / "checkout"),
              weights_path="release.pt", num_cycles=4)
    if not valid:
        with pytest.raises(ValueError, match="node_repr must be"):
            extract_with_omegafold(str(fasta), out, **kw)
        return
    assert extract_with_omegafold(str(fasta), out, **kw) == out
    with np.load(out) as z:
        g = torch.Generator().manual_seed(8 + 4)
        np.testing.assert_array_equal(z["node_repr"],
                                      torch.randn(8, 256, generator=g).numpy())
        assert z["edge_repr"].shape == (8, 8, 128)
    args = np.load(tmp_path / "args.npy")
    assert list(args) == ["release.pt", "cuda", "4", ">prot"]


def test_extract_with_omegafold_reports_a_failed_extractor(tmp_path):
    with pytest.raises(subprocess.CalledProcessError):
        extract_with_omegafold(os.devnull, str(tmp_path / "x.npz"),
                               omegafold_repo=str(tmp_path),
                               weights_path="w.pt", device="cpu")


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 7, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_fold_phase_rehearsal_on_cpu(checkpoint, tmp_path):
    import chip_smoke

    out = chip_smoke.fold_phase("cpu", tiny_cfg(), str(checkpoint / "w.pt"),
                                lengths=(19, 13), num_cycles=2,
                                num_pseudo_msa=2, pad_multiple=8,
                                tmp=str(tmp_path))
    assert out["launches"] == {
        "geom_attention": 0, "node_attention": 0, "geom_triangle": 0,
        **{k: 0 for k in chip_smoke.TRI_KERNELS}}
    assert sorted(r["n_res"] for r in out["records"]) == [13, 19]


def test_chip_smoke_fold_card_vs_cpu_rehearsal_on_cpu():
    """The release widths at the reduced depth, on the CPU twice."""
    import chip_smoke

    chip_smoke.fold_card_vs_cpu(devices=("cpu", "cpu"))
