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

import chip_smoke

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


# ---------------------------------------------------------------------------
# the kernel's two instances (128 or 256 query rows a block)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Lq,rows", [
    (128, 128),  # a 'seq' rank's block of the release window (row 6r)
    (102, 128),  # the ragged rank's rows 102-203, its last a pad row
    (112, 128),  # phase 10a's 224-residue rank
    (96, 128),   # phase 11a's square calls, both kernels
    (1, 128), (5, 128), (16, 128),
    (129, 256),  # past one 128-row chunk: the 256-row tile
    (203, 256), (256, 256),  # the square release and ragged calls
    (256, 256),  # phase 10b's rank: rows 256-511 of 512
    (611, 256),
])
def test_tile_rule(Lq, rows):
    """The instance each call takes: the 128-row tile wherever Lq fits one
    128-row chunk, else the 256-row tile, whose chunks re-project k|v
    less often."""
    assert mod.tile_rows(Lq) == rows
    assert rows in mod.TILE_ROWS


@pytest.mark.parametrize("case", chip_smoke.GEOM_RECT_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}".replace(" ", "-"))
def test_phase_2b_cases_take_their_instance(case):
    """Every call of chip_smoke.GEOM_RECT_CASES takes the instance its
    query rows give: the 'seq' blocks of at most 128 rows and the L 96
    calls the 128-row tile, rows 256-511 of 512 and geom_attention's batch
    rows of a 256 window the 256-row tile."""
    label, kind, L, rows, B = case
    Lq = rows[1] if rows else L
    want = 128 if label in ("rows 128-255", "rows 0-127",
                            "ragged rows 102-203", "L 96") else 256
    assert mod.tile_rows(Lq) == want


class _Recorder:
    """A stand-in for the kernel library: records each launcher's
    arguments and refuses, as the kernel does, a tile it has no instance
    of (cudaErrorInvalidValue, 1)."""

    def __init__(self):
        self.calls = []

    def node_attention(self, *args):
        self.calls.append(args)
        rows = args[-3]  # ..., rows, device, stream
        return 0 if rows in (128, 256) else 1

    geom_attention = node_attention

    def geom_attention_error_string(self, code):
        return b"invalid argument"

    def geom_attention_smem(self, rows):
        return {128: 147968, 256: 201216}.get(rows, -1)


@pytest.mark.parametrize("fn", ["node_attention", "geom_attention"])
def test_launch_passes_the_tile_and_raises_on_refusal(fn):
    """``launch`` hands the kernel the tile of ``tile_rows`` (or the one
    asked for) as the argument before the device, and raises on the code
    the kernel returns for a tile it has no instance of: no fallback."""
    B, R, L, d, H, c = 2, (1 if fn == "node_attention" else 2), 24, 8, 2, 32
    w, b = torch.zeros(d, R, H, 2 * c), torch.zeros(R, H, 1, 2 * c)
    kmask = torch.ones(B, L) if fn == "node_attention" else None
    ops = mod.kernel_inputs(fn, torch.zeros(B, R, L, d), w, b, w, b,
                            torch.zeros(R, H, L, L), kmask, c)
    lib, out = _Recorder(), torch.empty(1)
    mod.launch(lib, fn, ops, out, B, R, H, L, d, c, 1.0, 0, None)
    assert lib.calls[-1][-3:] == (mod.tile_rows(L), 0, None)
    mod.launch(lib, fn, ops, out, B, R, H, L, d, c, 1.0, 0, None, rows=256)
    assert lib.calls[-1][-3] == 256
    for rows in (0, 64, 192, 512):
        with pytest.raises(RuntimeError, match=f"rows={rows} "):
            mod.launch(lib, fn, ops, out, B, R, H, L, d, c, 1.0, 0, None,
                       rows=rows)


@pytest.mark.parametrize("kind,L,Lq", [("node_attention", 256, 128),
                                       ("node_attention", 96, None),
                                       ("geom_attention", 96, None)],
                         ids=["rows-128-255", "node-L96", "geom-L96"])
def test_geom_cost_counts_the_call(kind, L, Lq):
    """chip_smoke.geom_cost against a count by hand. Row 6r, a 'seq'
    rank's rows 128-255 of the release window (M 16, H 8, d 256, c 32):
    per (row, head) 128 x 256 x 64 (q|gate) + 256 x 256 x 64 (k|v) + 128 x
    256 x 32 x 2 (q.k^T, p.v) = 8.4 M multiply-adds, 2/3 of a 256-row
    tile's 12.6 M; L 96 square: 96 x d x 64 twice and 96 x 96 x 32 twice
    per (batch row, axis and head), node_attention M 16 x 8 heads at d
    256, geom_attention B 96 x 2 axes x 4 heads at d 128."""
    per_cell = {"rows-128-255": 128 * 256 * 64 + 256 * 256 * 64
                + 128 * 256 * 32 * 2,
                "node-L96": 2 * 96 * 256 * 64 + 2 * 96 * 96 * 32,
                "geom-L96": 2 * 96 * 128 * 64 + 2 * 96 * 96 * 32}
    # batch rows, (axis, head) cells, axes, depth
    B, G, R, d = (16, 8, 1, 256) if kind == "node_attention" else (96, 8, 2,
                                                                   128)
    key = ("rows-128-255" if Lq else
           "node-L96" if kind == "node_attention" else "geom-L96")
    if Lq:  # 8.4 M against a 256-row tile's 12.6 M
        assert per_cell[key] == 8_388_608
        assert 256 * 256 * 64 * 2 + 256 * 256 * 32 * 2 == 12_582_912
    Lq_ = Lq or L
    ops, nbytes, ew = chip_smoke.geom_cost(kind, L, Lq=Lq)
    assert ops - ew == 2 * B * G * per_cell[key]  # 2 operations a MAC
    assert ew == B * G * (4 * Lq_ * L + 4 * Lq_ * 32)
    # x, the output, the bias, both weights and biases (and the key mask)
    assert nbytes == (4 * (B * R * L * d + B * G * Lq_ * 32)
                      + 4 * (G * Lq_ * L + 2 * G * d * 64 + 2 * G * 64)
                      + (4 * B * L if kind == "node_attention" else 0))


def test_plain_block_of_the_128_row_tile_matches_jax_rows():
    """The plain version on a block the 128-row instance takes, the ragged
    rank's rows 102-203 of L = 203 (Lq 102, not a multiple of 16, its last
    row a pad row past L), a partial key mask per pseudo-MSA row, against
    the JAX kernel's rows (interpret mode): the real rows within 1e-5, the
    pad row finite."""
    L, H, d, q0, Lq = 203, 2, 8, 102, 102
    rng = np.random.default_rng(7)

    def f32(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    x = f32(3, L, d)
    w = [f32(d, 1, H, 2 * C, scale=d ** -0.5), f32(1, H, 1, 2 * C, scale=0.1),
         f32(d, 1, H, 2 * C, scale=d ** -0.5), f32(1, H, 1, 2 * C, scale=0.1)]
    bias = f32(H, q0 + Lq, L)
    kmask = (rng.random((3, L)) > 0.3).astype(np.float32)
    kmask[:, 0] = 1.0
    assert mod.tile_rows(Lq) == 128 and Lq % 16 and q0 + Lq > L
    want = np.asarray(jax_node(jnp.asarray(x), *(jnp.asarray(a) for a in w),
                               jnp.asarray(bias[:, :L]), jnp.asarray(kmask),
                               c=C, scale=C ** -0.5, interpret=True))
    got = mod.fused_gated_node_attention(
        torch.tensor(x), *(torch.tensor(a) for a in w),
        torch.tensor(bias[:, q0:]), torch.tensor(kmask), c=C,
        scale=C ** -0.5, q0=q0)
    assert tuple(got.shape) == (3, H, Lq, C)
    np.testing.assert_allclose(got[:, :, :L - q0].numpy(), want[:, :, q0:],
                               atol=ATOL, rtol=0)
    assert torch.isfinite(got[:, :, L - q0:]).all()


def test_bench_geom_cases_and_ablations_apply():
    """tools/bench_geom.py's pieces that run without a card: every --case
    names calls of phase 2b (chip_smoke.GEOM_RECT_CASES), or the release
    calls, or the triangle branch (phase 2c's release call), or its single
    view (phase 2d's release calls), and every
    ablation still finds the lines it edits in csrc/geom_attention.cu (an
    edit that no longer applies would only fail on the card)."""
    from dynamicpdb_tpu_torch.ops import _build
    from dynamicpdb_tpu_torch.tools import bench_ipa

    labels = {c[0].replace(" ", "-") for c in chip_smoke.GEOM_RECT_CASES}
    assert set(bench_geom.CASES) == labels | {"release", "triangle",
                                              "triangle-view"}
    with open(f"{_build.CSRC_DIR}/geom_attention.cu") as f:
        src = f.read()
    for name, edits in bench_geom.ABLATIONS.items():
        out = bench_ipa.ablated_source(src, edits)
        assert (out == src) == (name == "all"), name


def test_ptxas_usage_names_each_instance():
    """The smoke's build phase reads registers and spills per kernel from
    nvcc's -Xptxas -v output and names each instance of the GeoFormer
    kernel by its template arguments."""
    fn = ("_ZN50_GLOBAL__N__d6d5a32f_17_geom_attention_cu_4cc495c316geom_"
          "attn_kernelI13__nv_bfloat16Lb1ELi3ELi128EEEvPKT_PKfS6_")
    log = (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {fn}\n"
           "    32 bytes stack frame, 16 bytes spill stores, 20 bytes spill "
           "loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers, 32 bytes "
           "cumulative stack size\n")
    assert chip_smoke.ptxas_usage(log) == {
        fn: "255 registers, 16 bytes spill stores, 20 bytes spill loads"}
    assert chip_smoke.geom_instance(fn) == (
        "geom_attn_kernel<bfloat16, masked=1, passes=3, rows=128>")
    assert chip_smoke.geom_instance("ipa_fwd") == "ipa_fwd"
