"""CPU tests of what decides ``correct``, at tiny sizes: the frozen
reference against the port, the cell's run with its timed path broken
(``correct`` must come out false), and the control.

    python -m pytest h100bench/tests -q

The card-only test at the cells' own sizes carries the ``cuda`` marker
and runs there with ``python3 -m pytest --noconftest -p no:cacheprovider
h100bench/tests -m cuda``.
"""
from __future__ import annotations

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from h100bench import controls, run  # noqa: E402
from h100bench.tests import tiny  # noqa: E402

SEED = 2**33 + 17


def driver(name: str):
    return run.load_module(os.path.join(BENCH, "drivers", name + ".py"),
                           "test_driver_" + name)


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def extract_run() -> dict:
    s = driver("extract").Session(tiny.extract_config(),
                                  tiny.extract_traffic(), SEED, "cpu",
                                  model_factory=tiny.program_omegafold)
    run.run_window(s, 0.2)
    return s.check(reference_model=tiny.reference_omegafold)


# ---------------------------------------------------------------------------
# the frozen reference against the port, sound runs
# ---------------------------------------------------------------------------
def test_reference_follows_the_port_extraction():
    # float32 on both sides, the same plain attention on the CPU
    checks = extract_run()
    assert checks["repr_gap"]["value"] < 1e-4 and correct(checks)
    assert checks["cycle_choice_gap"]["value"] == 0.0


# ---------------------------------------------------------------------------
# the timed path broken underneath: correct comes out false
# ---------------------------------------------------------------------------
def test_extraction_answer_altered_fails(monkeypatch):
    from dynamicpdb_tpu_torch.preprocess import extract_embeddings as ee

    produced = ee.extract_embeddings

    def altered(*args, **kwargs):
        for name, arrays, stats in produced(*args, **kwargs):
            edge = arrays["edge_repr"]
            edge[0] += edge.std()  # one residue's pair row shifted
            yield name, arrays, stats

    monkeypatch.setattr(ee, "extract_embeddings", altered)
    assert not correct(extract_run())


def test_extraction_that_keeps_the_least_confident_cycle_fails(monkeypatch):
    """Argmin for argmax: the reprs are the right ones of the cycle the
    program reports, but that cycle is the reference's least confident."""
    import dataclasses

    from dynamicpdb_tpu_torch.preprocess import extract_embeddings as ee

    embed = ee.omegafold_embed

    def least_confident(model, cycles, **kwargs):
        kept = []
        emb = embed(model, cycles, on_cycle=lambda i, node, edge, conf:
                    kept.append((float(conf), i, node, edge)), **kwargs)
        conf, i, node, edge = min(kept, key=lambda k: k[0])
        return dataclasses.replace(emb, node=node.float(), edge=edge.float(),
                                   confidence=conf, cycle=i)

    monkeypatch.setattr(ee, "omegafold_embed", least_confident)
    checks = extract_run()
    assert checks["repr_gap"]["value"] < 1e-4  # the reprs match their cycle
    assert checks["cycle_choice_gap"]["value"] == 1.0
    assert not correct(checks)


def test_wrong_choices_read_from_the_reference_confidences():
    from h100bench.reference import steps

    confs = [0.2, 0.5, 0.4, 0.1, 0.45]
    assert steps.cycle_choice_gap(confs, 1) == 0.0
    assert steps.wrong_choice_gaps({"confidences": confs}) == {
        "last": pytest.approx(0.125), "first": pytest.approx(0.75),
        "least": 1.0}
    assert steps.cycle_choice_gap([0.3, 0.3], 1) == 0.0


# ---------------------------------------------------------------------------
# the controls, at a size a test run holds
# ---------------------------------------------------------------------------
def test_extract_control_runs_on_the_cpu():
    got = controls.extract_control(tiny.extract_config(),
                                   tiny.extract_traffic(), SEED, "cpu",
                                   model_cfg=tiny.omegafold_cfg())
    assert got["repr_gap"] < 1e-4  # no TF32 on the CPU: the same numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["extract-omegafold-n256"])
def test_control_fails_a_limit_at_the_cells_size(card, cell, capsys):
    """On three seeds the control fails at least one of the cell's
    limits."""
    import json

    assert controls.main(["--workload", cell, "--seeds", "1", "2", "3"]) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        r = json.loads(line)
        assert any(v > r["limits"][k] for k, v in r["control"].items()
                   if k in r["limits"]), r
