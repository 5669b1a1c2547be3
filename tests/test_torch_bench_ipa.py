"""tools/bench_ipa.py's pieces that run without a card: every ablation of
``ABLATIONS`` still finds the lines it edits in its kernel's source (an
edit that no longer applies would only fail on the card),
``route_launcher`` names, for each route, the launcher that
ops/ipa_attention.py launches there, and ``--library``'s SDPA operands
compute the forward. Nothing is compiled."""
import os
import types

import pytest
import torch

import chip_smoke

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


@pytest.mark.parametrize("rows", [None, (16, 48)], ids=["square", "rect"])
def test_library_call_computes_the_forward(rows):
    """``--library``'s SDPA call on the IPA logits gives the plain
    forward's o and o_pt on real query rows, square and (``--library
    rect``) on a block of query rows against every key, the float mask
    built from the rows' mask and the keys' mask."""
    args, c_qk = chip_smoke.ipa_inputs(torch, "cpu", N=48, H=2, C=16, Pq=4,
                                       Pv=6, Dz=4, masked=9, seed=3)
    key_mask = None
    if rows:
        args, key_mask = chip_smoke.rect_block(args, rows)
    o, o_pt = bench_ipa.sdpa_outputs(
        bench_ipa.sdpa_operands(*args, c_qk, key_mask=key_mask),
        args[0].shape[-1])
    want = ipa_mod.ipa_attention_plain(*args, c_qk, key_mask=key_mask)
    real = args[8].bool()
    assert o.shape == want[0].shape and o_pt.shape == want[1].shape
    for got, w in ((o, want[0]), (o_pt, want[1])):
        assert float((got - w)[real].abs().max()) <= chip_smoke.IPA_ATOL
