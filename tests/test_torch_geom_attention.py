"""The GeoFormer attention kernels of the PyTorch port
(ops/geom_attention.py): their plain versions, which the wrappers run on
the CPU, against the JAX package's Pallas kernels in interpret mode, as
tests/test_geom_attention_pallas.py runs them, on the same numpy inputs.

Covered: a partial key mask per row, a ragged L, float32 and bfloat16.
Float32 on both sides over sums of at most d + L terms: 1e-5. bfloat16:
both compute in float32 from the same bf16 values and round the output to
bf16, which may then differ by one bf16 step: 2^-7 of the value on top.
The CUDA kernels are held against the plain versions in
test_torch_kernels.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicpdb_tpu.ops.pallas.geom_attention import (
    fused_gated_geom_attention_t as jax_geom,
)
from dynamicpdb_tpu.ops.pallas.geom_attention import (
    fused_gated_node_attention as jax_node,
)
from dynamicpdb_tpu_torch.ops import geom_attention as mod
from dynamicpdb_tpu_torch.tools import bench_geom

torch.set_num_threads(1)

ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
C = 4


def _inputs(seed, B, R, L, d, H, masked=0.0):
    rng = np.random.default_rng(seed)

    def f32(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    kmask = (rng.random((B, L)) > masked).astype(np.float32)
    kmask[:, 0] = 1.0  # every row keeps a key, as the pseudo-MSA's row 0
    return dict(x=f32(B, R, L, d), qg_w=f32(d, R, H, 2 * C, scale=d ** -0.5),
                qg_b=f32(R, H, 1, 2 * C, scale=0.1),
                kv_w=f32(d, R, H, 2 * C, scale=d ** -0.5),
                kv_b=f32(R, H, 1, 2 * C, scale=0.1), bias=f32(R, H, L, L),
                kmask=kmask)


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol)


W_NAMES = ("qg_w", "qg_b", "kv_w", "kv_b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [8, 13], ids=["L8", "ragged-L13"])
def test_geom_plain_matches_pallas_interpret(L, dtype):
    d = _inputs(0, B=L, R=2, L=L, d=8, H=2)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_geom(jnp.asarray(d["x"], jd),
                    *(jnp.asarray(d[n], jd) for n in W_NAMES),
                    jnp.asarray(d["bias"]), c=C, scale=C ** -0.5,
                    interpret=True)
    before = mod.geom_launches
    got = mod.fused_gated_geom_attention_t(
        torch.tensor(d["x"]).to(td), *(torch.tensor(d[n]).to(td)
                                       for n in W_NAMES),
        torch.tensor(d["bias"]), c=C, scale=C ** -0.5)
    assert mod.geom_launches == before  # CPU tensors: the plain version ran
    assert got.dtype == td and tuple(got.shape) == want.shape
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [8, 11], ids=["L8", "ragged-L11"])
def test_node_plain_matches_pallas_interpret(L, dtype):
    d = _inputs(1, B=3, R=1, L=L, d=8, H=2, masked=0.3)
    assert 0 < d["kmask"][1:].sum() < d["kmask"][1:].size  # a partial mask
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_node(jnp.asarray(d["x"][:, 0], jd),
                    *(jnp.asarray(d[n], jd) for n in W_NAMES),
                    jnp.asarray(d["bias"][0]), jnp.asarray(d["kmask"]), c=C,
                    scale=C ** -0.5, interpret=True)
    before = mod.node_launches
    got = mod.fused_gated_node_attention(
        torch.tensor(d["x"][:, 0]).to(td),
        *(torch.tensor(d[n]).to(td) for n in W_NAMES),
        torch.tensor(d["bias"][0]), torch.tensor(d["kmask"]), c=C,
        scale=C ** -0.5)
    assert mod.node_launches == before
    assert got.dtype == td and tuple(got.shape) == want.shape
    _check(got, want, dtype)


def test_masked_keys_get_no_weight():
    """A masked key's value cannot reach the output: changing it changes
    nothing (the 1e9 offset leaves it at exactly zero weight)."""
    d = _inputs(2, B=2, R=1, L=9, d=8, H=1)
    d["kmask"][:, 3] = 0.0
    args = [torch.tensor(d["x"][:, 0])] + [torch.tensor(d[n]) for n in W_NAMES]
    bias, km = torch.tensor(d["bias"][0]), torch.tensor(d["kmask"])
    a = mod.fused_gated_node_attention(*args, bias, km, c=C, scale=C ** -0.5)
    args[0][:, 3] += 5.0  # the masked key's features (and so its k, v)
    b = mod.fused_gated_node_attention(*args, bias, km, c=C, scale=C ** -0.5)
    keep = torch.ones(9, dtype=torch.bool)
    keep[3] = False  # row 3's own query moved with it
    assert torch.equal(a[:, :, keep], b[:, :, keep])


def test_mixed_devices_raise():
    d = _inputs(3, B=2, R=2, L=4, d=4, H=1)
    args = [torch.tensor(d[n]) for n in ("x",) + W_NAMES + ("bias",)]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        mod.fused_gated_geom_attention_t(*args, c=C, scale=1.0)


# ---------------------------------------------------------------------------
# why the CUDA kernels split float32 operands for the tensor cores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["geom", "node"])
def test_tensor_core_precision_needs_3xtf32(kind):
    """At the release widths (d = 128 with 2 axes x 4 heads, d = 256 with 8
    heads; L = 256, c = 32; x ~ N(0, 1), two batch rows), every product
    done in one TF32 pass misses the kernels' float32 tolerance (1e-4,
    chip_smoke.GEOM_ATOL), while the 3xTF32 split (hi.hi + hi.lo + lo.hi)
    with float32 sums rounded to nearest stays within 1e-5 of the float32
    plain version, with hi rounded to nearest and with hi cut (the kernels'
    split, csrc/geom_attention.cu). The kernels' split under a model of the
    tensor cores' accumulators, each 8-deep step's sum rounded toward zero,
    lands further off but inside the tolerance; that model, not the
    nearest-rounded one, is what the kernels read on the card
    (tools/bench_geom.py --precision)."""
    R, H, d = (2, 4, 128) if kind == "geom" else (1, 8, 256)
    L, c = 256, 32
    rng = np.random.default_rng(5)

    def f32(*s, scale=1.0):
        return torch.tensor((rng.normal(size=s) * scale).astype(np.float32))

    x = f32(2, R, L, d)
    w = dict(qg_w=f32(d, R, H, 2 * c, scale=d ** -0.5),
             qg_b=f32(R, H, 1, 2 * c, scale=0.1),
             kv_w=f32(d, R, H, 2 * c, scale=d ** -0.5),
             kv_b=f32(R, H, 1, 2 * c, scale=0.1))
    bias = f32(R, H, L, L)
    scale = c ** -0.5
    if kind == "geom":
        want = mod.geom_attention_plain(x, *w.values(), bias, c=c,
                                        scale=scale)
    else:
        want = mod.node_attention_plain(x[:, 0], *w.values(), bias[0],
                                        torch.ones(2, L), c=c,
                                        scale=scale)[:, None]
    mms = {"one": bench_geom.mm_one_pass,
           "three": functools.partial(bench_geom.mm_3xtf32, cut=False),
           "three_cut": bench_geom.mm_3xtf32,
           "three_cut_toward_zero": functools.partial(
               bench_geom.mm_3xtf32, accumulate="toward_zero")}
    errs = {name: float((bench_geom.gated_attention_mm(
                x, *w.values(), bias, c, scale, mm) - want).abs().max())
            for name, mm in mms.items()}
    assert errs["three"] <= 1e-5 and errs["three_cut"] <= 1e-5, errs
    assert errs["one"] > 1e-4, errs
    assert (errs["three_cut"] < errs["three_cut_toward_zero"] <= 1e-4), errs


def test_round_toward_zero():
    """The accumulator model's rounding: float64 to the float32 neighbour
    nearer zero, exact values kept."""
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 1.0 - 2.0 ** -30,
                      0.5, -3.0, 0.0], dtype=torch.float64)
    got = bench_geom.round_toward_zero(x)
    want = torch.tensor([1.0, -1.0, 1.0 - 2.0 ** -24, 0.5, -3.0, 0.0])
    assert got.dtype == torch.float32 and torch.equal(got, want)
