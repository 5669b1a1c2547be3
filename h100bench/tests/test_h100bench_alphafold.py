"""CPU tests of the AlphaFold2 cell at a tiny size: the driver's run and
check against the frozen reference, a broken timed path failing
``correct``, the traffic's alignments, the kernel roofline's parent spans
and the cell's files.

    python -m pytest h100bench/tests/test_h100bench_alphafold.py -q
"""
from __future__ import annotations

import copy
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from h100bench import costs_alphafold, inputs_alphafold, run  # noqa: E402
from h100bench.tests import tiny  # noqa: E402
from h100bench.tests.test_h100bench_harness import Ev  # noqa: E402

SEED = 2**33 + 29
CELL = "extract-af2-n256-msa4096"


def tiny_reference_cfg():
    from h100bench.reference.models.alphafold import model as ref

    return ref.Config(
        msa_dim=20, pair_dim=16, single_dim=24, extra_msa_dim=12,
        evoformer_blocks=2, extra_msa_blocks=1, msa_heads=2, msa_head_dim=6,
        extra_msa_head_dim=4, pair_heads=2, pair_head_dim=5, opm_dim=4,
        ipa_heads=3, ipa_scalar=5, ipa_points_qk=2, ipa_points_v=3,
        plddt_hidden=12, plddt_bins=10, num_recycle=1, max_msa_clusters=5,
        max_extra_msa=4)


def af2_traffic() -> dict:
    t = copy.deepcopy(tiny.load("traffic", CELL))
    t.update(length=12, distinct=2, msa_rows=14)
    return t


def af2_config() -> dict:
    c = copy.deepcopy(tiny.load("configs", "alphafold2-model5"))
    c.update(num_recycle=1, max_msa_clusters=5, max_extra_msa=4)
    return c


def program(seed, device, data):
    from dynamicpdb_tpu_torch.models.alphafold.model import (
        alphafold_from_state_dict,
    )
    from h100bench.reference import steps_alphafold as steps

    return alphafold_from_state_dict(
        steps.alphafold_weights(seed, device, tiny_reference_cfg()),
        device=device, **data)


def reference(seed, device):
    from h100bench.reference import steps_alphafold as steps

    return steps.alphafold_model(seed, device, tiny_reference_cfg())


def session():
    drv = run.load_module(os.path.join(BENCH, "drivers", "extract_af2.py"),
                          "test_driver_extract_af2")
    return drv.Session(af2_config(), af2_traffic(), SEED, "cpu",
                       model_factory=program)


def test_driver_run_is_correct():
    s = session()
    assert 1 <= s.checked <= af2_traffic()["check_within"]
    run.run_window(s, 0.2)
    while s.done <= s.checked:  # the tiny window may end sooner
        s.unit()
    recycles, _, _ = s.captured
    assert len(recycles) == af2_config()["num_recycle"] + 1
    checks = s.check(reference_model=reference)
    assert set(checks) == {"repr_gap", "pseudo_beta_gap", "plddt_gap"}
    assert checks["repr_gap"]["value"] < 1e-5
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert s.counters["flops_per_unit"] > 0


def test_broken_extraction_fails(monkeypatch):
    from dynamicpdb_tpu_torch.models.alphafold import model as af2

    s = session()
    real = af2.alphafold_recycle

    def skip_last_block(model, inputs, recycle, prev):
        blocks = model.evoformer
        model.evoformer = blocks[:-1]
        try:
            return real(model, inputs, recycle, prev)
        finally:
            model.evoformer = blocks

    monkeypatch.setattr(af2, "alphafold_recycle", skip_last_block)
    while s.done <= s.checked:
        s.unit()
    checks = s.check(reference_model=reference)
    assert checks["repr_gap"]["value"] > checks["repr_gap"]["limit"]


def test_a_broken_structure_module_fails():
    """The program's structure module one IPA layer short: the reprs the
    next recycle reads from it agree on both sides (the reference starts
    from the program's recycled pseudo-beta), so ``repr_gap`` holds, and
    the pseudo-beta and pLDDT gaps fail."""
    s = session()
    s.model.structure_module.num_layers -= 1
    while s.done <= s.checked:
        s.unit()
    checks = s.check(reference_model=reference)
    assert checks["repr_gap"]["value"] <= checks["repr_gap"]["limit"]
    for k in ("pseudo_beta_gap", "plddt_gap"):
        assert checks[k]["value"] > checks[k]["limit"], (k, checks[k])


def test_a_wrong_recycle_input_fails(monkeypatch):
    """The first recycle's features drawn for another recycle: every
    recycle's own pass is held, so the first one's gap fails."""
    from dynamicpdb_tpu_torch.models.alphafold import features

    s = session()
    real = features.recycle_features

    def shifted(msa, tokens, deletions, recycle, **kw):
        return real(msa, tokens, deletions, recycle + 1, **kw)

    monkeypatch.setattr(features, "recycle_features", shifted)
    while s.done <= s.checked:
        s.unit()
    checks = s.check(reference_model=reference)
    assert checks["repr_gap"]["value"] > checks["repr_gap"]["limit"]


def test_the_control_reads_per_recycle():
    from h100bench import controls_alphafold

    gaps = controls_alphafold.extract_af2_control(
        af2_traffic(), SEED, "cpu", tiny_reference_cfg())
    # TF32 does not exist on the CPU: the control reads rounding there
    assert len(gaps["recycle_gaps"]) == 2 and gaps["repr_gap"] < 1e-5
    assert gaps["pseudo_beta_gap"] < 1e-5 and gaps["plddt_gap"] < 1e-5


def test_alignments_follow_the_traffic():
    t = af2_traffic()
    a = inputs_alphafold.alignments(t, SEED)
    assert a == inputs_alphafold.alignments(t, SEED)
    assert len(a) == t["distinct"]
    from dynamicpdb_tpu_torch.models.alphafold.features import parse_a3m

    msa = parse_a3m(a[0])
    assert msa.tokens.shape[1] == t["length"]
    assert msa.tokens.shape[0] <= t["msa_rows"]
    big = dict(t, msa_rows=400, length=200)
    msa = parse_a3m(inputs_alphafold.alignment("A" * 200, big, 5))
    ident = (msa.tokens[1:] == msa.tokens[0]).mean()
    assert 0.5 < ident < 0.65  # the mean of U(0.25, 0.9) plus chance hits
    assert 0.005 < (msa.deletions > 0).mean() < 0.04


def test_roofline_finds_each_call_by_its_parent_span():
    from h100bench.trace import Trace

    reader = run.load_module(os.path.join(BENCH, "metrics",
                                          "kernels_roofline.af2.py"),
                             "test_kernels_roofline_af2")
    # one unit: a row-attention span holding a node-attention call (a
    # kernel of 1000 ns), a triangle span holding the triangle route (2000
    # ns), and a node-attention call outside every alphafold span
    ev = [Ev("bench.unit", 0, 10), Ev("bench.unit", 10, 10_000),
          Ev("alphafold.msa_row_attention", 100, 3000),
          Ev("ops.node_attention", 200, 2000),
          Ev("cudaLaunchKernel", 300, 1, corr=1),
          Ev("k1", 400, 1000, cuda=True, corr=1),
          Ev("alphafold.triangle_multiplication", 4000, 3000),
          Ev("ops.geom_triangle", 4100, 2000),
          Ev("cudaLaunchKernel", 4200, 1, corr=2),
          Ev("k2", 4300, 2000, cuda=True, corr=2),
          Ev("ops.node_attention", 8000, 500),
          Ev("cudaLaunchKernel", 8100, 1, corr=3),
          Ev("k3", 8200, 300, cuda=True, corr=3)]
    trace = Trace(ev, skip_units=1)
    config = tiny.load("configs", "alphafold2-model5")
    counters = {"n_res": 256, "msa_clusters": 512, "extra_rows": 1024}
    want = (costs_alphafold.call_bound_s("alphafold.msa_row_attention",
                                         config, counters)
            + costs_alphafold.call_bound_s(
                "alphafold.triangle_multiplication", config, counters))
    got = reader.read(trace, counters, config)
    assert got == pytest.approx(100.0 * want / 3000e-9)
    assert reader.read(trace, {}, config) is None


def test_cell_files_exist():
    bench = run.load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic, e2e, per_layer = run.cell_spec(bench, CELL)
    assert traffic["driver"] == "extract_af2"
    assert {m["name"] for m in e2e} == {"extract_residues_per_s",
                                        "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in per_layer}
    assert len(names) == 7 and all(n.endswith(".af2") for n in names)
    for n in names:
        assert os.path.exists(os.path.join(BENCH, "metrics", n + ".py"))
    assert np.isclose(run.load_json(ROOT, config["file"])["masked_msa_replace_fraction"], 0.15)
