"""The extraction slice of the PyTorch port as a whole: the recycling loop
against the JAX package's, padding, bfloat16, and the CLI end to end.

One JAX run (three jitted cycles, reused by every test here) gives each
cycle's reprs and confidence; the port's ``omegafold_embed`` must select
the same cycle by the same rule (strictly greater than the best so far,
from 0.0; the first cycle kept when none beats it) and return its reprs
within 1e-4 (float32 through the PLM, two GeoFormer blocks, the structure
module and three recycles; the acceptance bar of the JAX port of
OmegaFold). Padded extraction must equal exact extraction within 1e-5;
bfloat16 must stay within 0.1 of the float32 scale (the JAX package's own
bar). The CLI runs on the CPU from a ``torch.save``d checkpoint, with
'module.' prefixes and inside a {'model': ...} wrapper, to npz files that
pass ``validate``; chip_smoke.py's extraction phase is rehearsed on it."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu.models.omegafold import model as jax_model
from dynamicpdb_tpu.models.omegafold import pipeline as jax_pipe
from dynamicpdb_tpu_torch.models.omegafold import pipeline
from dynamicpdb_tpu_torch.models.omegafold.model import (
    omegafold_embed,
    omegafold_from_state_dict,
)
from dynamicpdb_tpu_torch.ops import geom_attention as geom_mod
from dynamicpdb_tpu_torch.preprocess import extract_embeddings as cli
from dynamicpdb_tpu_torch.preprocess.embeddings import validate
from dynamicpdb_tpu_torch.weights import random_omegafold_state_dict
from tests.test_torch_omegafold import FASTA, tiny_cfg, weights  # noqa: F401

torch.set_num_threads(1)

NUM_CYCLES = 3


def cli_cfg():
    """tiny_cfg at the DFOLD contract's widths (node 256, edge 128), which
    ``validate`` checks."""
    cfg = tiny_cfg()
    return dataclasses.replace(
        cfg, node_dim=256, edge_dim=128,
        struct=dataclasses.replace(cfg.struct, edge_dim=128))


def _select(confs):
    """The JAX loop's rule (model.omegafold_embed): `conf > max_conf or
    final is None`."""
    best, chosen = 0.0, None
    for i, c in enumerate(confs):
        if c > best or chosen is None:
            best, chosen = max(best, c), i
    return chosen


@pytest.fixture(scope="module")
def jax_run(weights):  # noqa: F811
    """The JAX cycles, jitted once: every cycle's (node, edge, confidence),
    and omegafold_embed's (edge, node, confidence) on the same compile."""
    _, params, jcfg, _ = weights
    _, cycles = next(jax_pipe.fasta2inputs(FASTA, num_pseudo_msa=3,
                                           num_cycle=NUM_CYCLES))
    L = cycles[0]["p_msa"].shape[-1]
    prev = (jnp.zeros((L, jcfg.node_dim)),
            jnp.zeros((L, L, jcfg.edge_dim)), jnp.zeros((L, 14, 3)))
    fn = jax_model._jitted_cycle(jcfg, False, False)
    per_cycle = []
    for cyc in cycles:
        node, edge, conf, _, prev = fn(params, jnp.asarray(cyc["p_msa"]),
                                       jnp.asarray(cyc["p_msa_mask"]), *prev)
        per_cycle.append((np.asarray(node), np.asarray(edge), float(conf)))
    embed = jax_model.omegafold_embed(params, jcfg, cycles, jit=True)
    return cycles, per_cycle, embed


def test_embed_matches_jax_and_selects_the_same_cycle(weights, jax_run):  # noqa: F811
    port = weights[3]
    cycles, per_cycle, (edge, node, conf) = jax_run
    confs = [c for _, _, c in per_cycle]
    chosen = _select(confs)
    # the JAX loop's output is that cycle's
    np.testing.assert_array_equal(np.asarray(node), per_cycle[chosen][0])
    assert conf == max(0.0, *confs)

    before = (geom_mod.geom_launches, geom_mod.node_launches)
    got = omegafold_embed(port, cycles)
    assert (geom_mod.geom_launches, geom_mod.node_launches) == before
    np.testing.assert_allclose(got.confidences, confs, atol=1e-5, rtol=0)
    assert got.cycle == chosen
    assert got.node.dtype == got.edge.dtype == torch.float32
    np.testing.assert_allclose(got.node.numpy(), np.asarray(node), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.edge.numpy(), np.asarray(edge), atol=1e-4,
                               rtol=0)
    assert abs(got.confidence - conf) < 1e-5


def test_padded_extraction_equals_exact(weights):  # noqa: F811
    port = weights[3]
    _, exact = next(pipeline.fasta2inputs(FASTA, num_pseudo_msa=3,
                                          num_cycle=2))
    _, padded = next(pipeline.fasta2inputs(FASTA, num_pseudo_msa=3,
                                           num_cycle=2, pad_multiple=12))
    n = padded[0]["num_res"]
    assert padded[0]["p_msa"].shape[-1] == 24 > n
    a = omegafold_embed(port, exact)
    b = omegafold_embed(port, padded, pad_safe=True)
    np.testing.assert_allclose(b.node[:n].numpy(), a.node.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(b.edge[:n, :n].numpy(), a.edge.numpy(),
                               atol=1e-5, rtol=0)
    assert b.cycle == a.cycle and abs(b.confidence - a.confidence) < 1e-5


def test_bfloat16_close_to_float32(weights):  # noqa: F811
    sd, _, _, port = weights
    bf16 = omegafold_from_state_dict(sd, device="cpu", dtype=torch.bfloat16)
    assert bf16.plm_node_embedder.weight.dtype == torch.bfloat16
    _, cycles = next(pipeline.fasta2inputs(FASTA, num_pseudo_msa=2,
                                           num_cycle=2))
    a, b = omegafold_embed(port, cycles), omegafold_embed(bf16, cycles)
    assert b.node.dtype == b.edge.dtype == torch.float32
    for x, y in ((a.node, b.node), (a.edge, b.edge)):
        assert float((x - y).abs().mean()) < 0.1 * float(x.abs().mean())


@pytest.mark.parametrize("wrap", ["module-prefix", "model-wrapper"])
def test_cli_end_to_end_on_the_cpu(tmp_path, wrap):
    sd = random_omegafold_state_dict(cli_cfg(), 5)
    tensors = {k: torch.tensor(v) for k, v in sd.items()}
    if wrap == "module-prefix":
        ckpt = {"module." + k: v for k, v in tensors.items()}
    else:
        ckpt = {"model": tensors, "epoch": 3}
    torch.save(ckpt, tmp_path / "w.pt")
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text("".join(FASTA))
    out = tmp_path / "out"
    records = cli.main(["--fasta", str(fasta), "--out-dir", str(out),
                        "--weights", str(tmp_path / "w.pt"), "--num-cycles",
                        "2", "--num-pseudo-msa", "2", "--pad-multiple", "8",
                        "--flash", "on", "--no-scan", "--device", "cpu"])
    assert [r["name"] for r in records] == ["short", "long"]
    for r, seq in zip(records, (FASTA[1], FASTA[3])):
        n = len(seq.strip())
        assert r["n_res"] == n and r["padded"] == -(-n // 8) * 8
        assert validate(os.path.join(out, f"{r['name']}.npz"), n_res=n)
    _, cycles = next(pipeline.fasta2inputs(FASTA, num_pseudo_msa=2,
                                           num_cycle=2))
    want = omegafold_embed(omegafold_from_state_dict(sd, device="cpu"), cycles)
    with np.load(out / "short.npz") as z:
        np.testing.assert_allclose(z["node_repr"], want.node.numpy(),
                                   atol=1e-5, rtol=0)
        assert abs(float(z["confidence"]) - want.confidence) < 1e-5


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--fasta", "x", "--out-dir", "y", "--weights", "z"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_extract_phase_rehearsal(tmp_path, dtype):
    """chip_smoke.extract_phase on the CPU at the tiny widths: the same
    code path, with no kernel launched."""
    out = chip_smoke.extract_phase("cpu", cli_cfg(), lengths=(19, 13),
                                   num_cycles=2, num_pseudo_msa=2,
                                   pad_multiple=8, tmp=str(tmp_path),
                                   dtype=dtype)
    assert out["launches"] == {"geom_attention": 0, "node_attention": 0}
    assert [r["n_res"] for r in out["records"]] == [13, 19]


def _span_counts(path) -> dict:
    """Events of each name in a Chrome trace written by ``profile_trace``."""
    import json
    from collections import Counter

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in events if e.get("ph") == "X")


def test_spans_never_enter_the_profiler_when_none_runs(weights,  # noqa: F811
                                                       monkeypatch):
    from dynamicpdb_tpu_torch.utils import logging as plogging

    def refuse(name):
        raise AssertionError(f"span {name!r} entered the profiler")

    monkeypatch.setattr(plogging, "record_function", refuse)
    out = list(cli.extract_embeddings(FASTA, weights[3], num_cycles=2,
                                      num_pseudo_msa=2))
    assert [name for name, _, _ in out] == ["short", "long"]


def test_profile_trace_holds_every_span_and_no_op(weights,  # noqa: F811
                                                  tmp_path):
    """Under the light profile each span of the extraction path appears as
    often as its layer runs, and no operator is recorded."""
    from dynamicpdb_tpu_torch.utils.logging import profile_trace

    model, cycles = weights[3], 2
    with profile_trace(str(tmp_path)):
        out = list(cli.extract_embeddings(FASTA, model, num_cycles=cycles,
                                          num_pseudo_msa=2))
    counts = _span_counts(tmp_path / "trace.json")
    seqs = len(out)
    blocks = model.cfg.geo_num_blocks * seqs * cycles
    assert {k: v for k, v in counts.items()
            if k.startswith(("extract.", "omegafold.", "ops."))} == {
        "extract.pipeline": seqs, "extract.fetch": seqs,
        "omegafold.cycle": seqs * cycles, "omegafold.inputs": seqs * cycles,
        "omegafold.plm": seqs * cycles,
        "omegafold.plm_and_embedders": seqs * cycles,
        "omegafold.geoformer": seqs * cycles,
        "omegafold.structure_module": seqs * cycles,
        "omegafold.atom14_and_confidence": seqs * cycles,
        "omegafold.readback": seqs,
        **{f"omegafold.{step}": blocks for step in (
            "attention_w_edge_bias", "column_attention", "node_transition",
            "out_product", "geometric_attention", "edge_transition")},
        "ops.geom_attention": model.cfg.geom_count * blocks,
        "ops.node_attention": blocks,
    }
    assert not [k for k in counts if k.startswith("aten::")]


def test_cli_profile_dir_writes_the_trace(tmp_path):
    torch.save({k: torch.tensor(v) for k, v in random_omegafold_state_dict(
        cli_cfg(), 6).items()}, tmp_path / "w.pt")
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text("".join(FASTA))
    records = cli.main(["--fasta", str(fasta), "--out-dir",
                        str(tmp_path / "out"), "--weights",
                        str(tmp_path / "w.pt"), "--num-cycles", "1",
                        "--num-pseudo-msa", "1", "--device", "cpu",
                        "--profile-dir", str(tmp_path / "prof")])
    counts = _span_counts(tmp_path / "prof" / "trace.json")
    assert counts["extract.fetch"] == len(records) == 2
    assert counts["omegafold.cycle"] == 2
