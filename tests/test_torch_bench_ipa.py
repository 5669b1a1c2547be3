"""tools/bench_ipa.py's pieces that run without a card: every ablation of
``ABLATIONS`` still finds the lines it edits in its kernel's source (an
edit that no longer applies would only fail on the card), and
``route_launcher`` names, for each route, the launcher that
ops/ipa_attention.py launches there. Nothing is compiled."""
import os
import types

import pytest

from dynamicpdb_tpu_torch.ops import _build
from dynamicpdb_tpu_torch.ops import ipa_attention as ipa_mod
from dynamicpdb_tpu_torch.tools import bench_ipa


@pytest.mark.parametrize("kernel", list(bench_ipa.ABLATIONS))
def test_every_ablation_applies_to_its_source(kernel):
    lib = kernel if kernel.endswith("_fwd") else kernel[:kernel.rindex("_")]
    with open(os.path.join(_build.CSRC_DIR, f"{lib}.cu")) as f:
        src = f.read()
    for name, edits in bench_ipa.ABLATIONS[kernel].items():
        out = bench_ipa.ablated_source(src, edits)
        assert (out == src) == (name == "all"), name
    # the launcher it times is one its library exports
    assert kernel in ipa_mod.LIBRARIES[lib][0]


@pytest.mark.parametrize("fn,route", sorted(ipa_mod.COUNTERS))
def test_route_launcher_matches_the_wrapper(fn, route):
    stub = types.SimpleNamespace(kernel_route=lambda *_: route)
    got_route, name = bench_ipa.route_launcher(stub, fn, {})
    assert (got_route, name) == (route, ipa_mod.launcher(fn, route)[1])
