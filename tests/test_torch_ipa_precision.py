"""Why the IPA forward and dq kernels run every product in three TF32
passes (csrc/ipa_attention_fwd.cu, csrc/ipa_attention_bwd.cu kernel A).

The kernels' arithmetic is emulated on the CPU at the release widths (one
frame, two heads, N = 256, C = 256, Pq 8, Pv 12, Dz 32, last 56 residues
masked; dq with cotangents zero on pad rows) with every product through
one TF32 pass or through 3xTF32 with the tensor cores' round-toward-zero
accumulation (tools/bench_geom.py mm_one_pass, mm_3xtf32), and held
against the same functions in float64 on real rows, under the tolerances
the kernels are held to on the card: chip_smoke.IPA_ATOL for o, o_pt and
o_pair, chip_smoke.BWD_RTOL of dq's largest magnitude for dq
(tools/bench_ipa.py --precision adds the kernels themselves)."""
import pytest
import torch

import chip_smoke
from dynamicpdb_tpu_torch.tools import bench_ipa


@pytest.fixture(scope="module")
def errors():
    fwd_args, bwd_inputs, c_qk = bench_ipa.precision_inputs(chip_smoke, "cpu")
    results = {name: bench_ipa.emulate(mm, fwd_args, bwd_inputs, c_qk)
               for name, mm in bench_ipa.emulations().items()}
    return bench_ipa.errors_vs_float64(fwd_args, bwd_inputs, c_qk, results)


def _tol(errors, name):
    if name == "dq":
        return chip_smoke.BWD_RTOL * max(1.0, errors["scale"]["dq"])
    return chip_smoke.IPA_ATOL


@pytest.mark.parametrize("name", bench_ipa.NAMES)
def test_three_tf32_passes_keep_the_tolerance(errors, name):
    tol = _tol(errors, name)
    assert errors["plain_float32"][name] <= tol / 10, errors["plain_float32"]
    assert errors["3xtf32_toward_zero"][name] <= tol / 5, errors
    # float32 accuracy, not better: the accumulation costs over plain sums
    assert errors["3xtf32_toward_zero"][name] >= errors["plain_float32"][name]


@pytest.mark.parametrize("name", ("o", "o_pt", "o_pair", "dq"))
def test_one_tf32_pass_misses_it(errors, name):
    assert errors["one_pass"][name] > 2 * _tol(errors, name), errors


def test_emulated_schemes_run_in_float32():
    a = torch.randn(3, 16, 24, dtype=torch.float32)
    b = torch.randn(3, 24, 8, dtype=torch.float32)
    for mm in bench_ipa.emulations().values():
        assert mm(a, b).dtype == torch.float32
