"""The triangle-multiplicative branch of the OmegaFold GeoFormer's
GeometricAttention: its CUDA route, its plain version, and their wrapper.

``geom_triangle`` takes the branch from the normalised edge to its sum
over the two views, added to the attended branch's output:

  act_row = glu(x_r[i, k] . act_w[:, r, value|gate] + act_b) m[i] (m[k])
  act_col = glu(x_r[j, k] . act_w[:, r, value|gate] + act_b) m[j]
  ab      = LayerNorm_d(sum_k act_row[i, k] act_col[j, k])
  out     = attended + sum_r (ab . out_proj_w[r] + out_proj_b[r])
            * sigmoid(x_r[i, j] . act_w[:, r, 4d:] + act_b[r, 4d:])

for the two views x_0 = edge and x_1 = its column view, with (m[k]) under
``pad_safe`` only.

``geom_triangle_view`` is the single-view form, for AlphaFold2's triangle
multiplications, which apply the views one after the other with weights
of their own: view 0 is its "outgoing" update (sum_k a_ik b_jk), view 1
its "incoming" one (sum_k a_ki b_kj). It computes

  out = residual + (LayerNorm_d(sum_k act_row[i, k] act_col[j, k])
        . out_w + out_b) * sigmoid(x_0[i, j] . act_w[:, 4d:] + act_b[4d:])

with act_row (m[k] always) and act_col as above on the chosen view x_r
and act_w [d, 5d] (the value and gate of a, the value and gate of b, as
in the two-view layout, then the output gate), act_b [5d], out_w [d, d],
out_b [d], over every row of the pair tensor (no 'seq' rows). The gate
reads x_0 = edge for either view, as AlphaFold2's does. On the card it
runs the same three kernels in their single-view instances (``launch``
with ``view``). The JAX package has no kernel for it: its
``geometric_attention`` (``dynamicpdb_tpu/models/omegafold/geoformer.py``)
leaves it to XLA's einsums, and ``geom_triangle_plain`` is that code as
the port ran it before the route, moved here unchanged in what it
computes. For a CPU tensor the wrapper runs the plain version. For a CUDA
tensor it launches three hand-written kernels (``csrc/geom_triangle.cu``,
3xTF32 ``mma.sync``, float32 intermediates) and nothing falls back: a call
they cannot take raises.

Sequence parallelism (``parallel/sp.py``): ``edge`` holds a 'seq' rank's
rows [q0, q0 + Lr) of the window (rows past L pad), ``whole`` every row
(the same tensor outside a 'seq' mesh); act_row covers the rank's rows,
act_col every row, and the product is Lr x L. The kernels read both views
by index, so nothing is stacked or transposed for them.

``triangle_launches`` counts the calls of this process that ran on the
card, ``tri_proj_launches``, ``tri_mm_launches`` and ``tri_out_launches``
each kernel's launches (one a call), ``tri_view_launches`` the
single-view calls on the card (three launches each); a run that must show the route on
its path sets them to 0 before and reads them after. The wrapper's whole
call (the plain path and the launches alike) runs under the span
``ops.geom_triangle`` (``utils.logging.span``), where a profile reads its
device time.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dynamicpdb_tpu_torch.models.omegafold.core import layer_norm_f32
from dynamicpdb_tpu_torch.ops.geom_attention import _f32
from dynamicpdb_tpu_torch.ops.ipa_attention import _device_of
from dynamicpdb_tpu_torch.utils.logging import span

triangle_launches = 0
tri_proj_launches = 0
tri_mm_launches = 0
tri_out_launches = 0
tri_view_launches = 0

KERNEL_D = 128  # the edge width the kernels are compiled for
PAD = 64  # the kernels' operands pad the summed index to a multiple of this


def padded_length(L: int) -> int:
    """The length Lp of the kernels' K-major operands: L rounded up to PAD."""
    return -(-L // PAD) * PAD


def _glu(x):
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def _sliced(w, d_edge: int, shift: int):
    """act_w[..., :4d] unflattened to (4, d), rows [shift::2] -> (2d)."""
    core = w[..., :4 * d_edge].reshape(w.shape[:-1] + (4, d_edge))
    return core[..., shift::2, :].reshape(w.shape[:-1] + (2 * d_edge,))


def _take(x, q0: int, n: int):
    """Rows [q0, q0 + n) of x along dim 0, zeros past its end (a 'seq'
    rank's pad rows)."""
    part = x[min(q0, x.shape[0]):min(q0 + n, x.shape[0])]
    if part.shape[0] == n:
        return part
    return torch.cat([part, part.new_zeros((n - part.shape[0],)
                                           + x.shape[1:])])


def geom_triangle_plain(edge, whole, attended, mask, act_w, act_b,
                        out_proj_w, out_proj_b, *, q0: int = 0,
                        pad_safe: bool = False):
    """``geom_triangle`` as einsums in the input's dtype."""
    Lr, L, d = edge.shape
    cols = whole.transpose(0, 1)  # the column view: cols[j, k] = whole[k, j]
    # axis-major [Lr, 2, L, d]: this rank's rows of both views
    stacked = torch.stack([edge, _take(cols, q0, Lr)], dim=-3)
    m_all = mask.to(stacked.dtype)
    m = _take(m_all, q0, Lr)
    row_w, row_b = _sliced(act_w, d, 0), _sliced(act_b, d, 0)
    col_w, col_b = _sliced(act_w, d, 1), _sliced(act_b, d, 1)
    act_row = _glu(torch.einsum("irkd,drc->ikrc", stacked, row_w) + row_b)
    act_row = act_row * m[:, None, None, None]
    if pad_safe:
        act_row = act_row * m_all[None, :, None, None]

    def col_act(x):  # x [j, 2, L, d] -> [j, L, 2, d]
        return _glu(torch.einsum("jrkd,drc->jkrc", x, col_w) + col_b)

    # every residue j's act_col; a rank's, one row block at a time, so
    # that no more than a block's [rows, L, 2, 2d] projection is alive
    act_col = (col_act(stacked) if (q0, Lr) == (0, L) else torch.cat([
        col_act(torch.stack([whole[j:j + Lr], cols[j:j + Lr]], dim=-3))
        for j in range(0, L, Lr)]))
    act_col = act_col * m_all[:, None, None, None]
    ab = layer_norm_f32(torch.einsum("ikrd,jkrd->ijrd", act_row, act_col))
    gated = torch.einsum("ijrd,rdc->ijrc", ab, out_proj_w) + out_proj_b
    act_g = torch.sigmoid(torch.einsum("irjd,drc->ijrc", stacked,
                                       act_w[..., -d:]) + act_b[..., -d:])
    gated = gated * act_g[:, : gated.shape[1]]
    return attended + gated.sum(-2)


def geom_triangle_view_plain(edge, residual, mask, act_w, act_b, out_w,
                             out_b, *, view: int):
    """``geom_triangle_view`` as einsums in the input's dtype."""
    d = edge.shape[-1]
    x = edge if view == 0 else edge.transpose(0, 1)  # x_r
    m = mask.to(edge.dtype)
    act_row = _glu(torch.einsum("ikd,dc->ikc", x, _sliced(act_w, d, 0))
                   + _sliced(act_b, d, 0)) * (m[:, None] * m[None, :])[..., None]
    act_col = _glu(torch.einsum("jkd,dc->jkc", x, _sliced(act_w, d, 1))
                   + _sliced(act_b, d, 1)) * m[:, None, None]
    ab = layer_norm_f32(torch.einsum("ikd,jkd->ijd", act_row, act_col))
    gate = torch.sigmoid(torch.einsum("ijd,dc->ijc", edge, act_w[:, -d:])
                         + act_b[-d:])
    return residual + (torch.einsum("ijd,dc->ijc", ab, out_w) + out_b) * gate


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, typed."""
    from dynamicpdb_tpu_torch.ops import _build

    lib = _build.load("geom_triangle")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tri_proj.argtypes = [p] * 5 + [i] + [p] * 2 + [i] * 8 + [p]
    lib.tri_mm.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.tri_out.argtypes = [p] * 9 + [i] * 8 + [p]
    for fn in (lib.tri_proj, lib.tri_mm, lib.tri_out):
        fn.restype = i
    lib.geom_triangle_error_string.argtypes = [i]
    lib.geom_triangle_error_string.restype = ctypes.c_char_p
    return lib


def kernel_inputs(edge, whole, attended, mask, act_w, act_b, out_proj_w,
                  out_proj_b, q0: int, views: int = 2) -> dict:
    """The kernels' operands from the wrapper's: edge, whole and attended
    contiguous in their dtype (float32 or bfloat16, all three the same),
    mask and the weights float32 and contiguous (the tensors themselves
    where they already are). ``views`` 1: the single-view form's weights,
    without the view axis. Raises on what the kernels cannot take."""
    fn = "geom_triangle" if views == 2 else "geom_triangle_view"
    v = (2,) if views == 2 else ()
    if edge.dim() != 3:
        raise ValueError(f"{fn}: edge has shape {tuple(edge.shape)}, "
                         "expected [Lr, L, d]")
    Lr, L, d = edge.shape
    if edge.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: edge is {edge.dtype}, the kernels take "
                        "float32 or bfloat16")
    for name, t in (("whole", whole), ("attended", attended)):
        if t.dtype != edge.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, edge {edge.dtype}")
    if d != KERNEL_D:
        raise ValueError(f"{fn}: d={d}, the kernels are built for "
                         f"d={KERNEL_D}")
    if Lr > L:
        raise ValueError(f"{fn}: Lr={Lr} rows of a window of L={L}")
    if q0 < 0:
        raise ValueError(f"{fn}: q0={q0}")
    for name, t, shape in (("whole", whole, (L, L, d)),
                           ("attended", attended, (Lr, L, d)),
                           ("mask", mask, (L,)),
                           ("act_w", act_w, (d,) + v + (5 * d,)),
                           ("act_b", act_b, v + (5 * d,)),
                           ("out_proj_w", out_proj_w, v + (d, d)),
                           ("out_proj_b", out_proj_b, v + (d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    ops = dict(edge=edge.contiguous(), whole=whole.contiguous(),
               attended=attended.contiguous(), mask=_f32(mask),
               act_w=_f32(act_w), act_b=_f32(act_b), out_w=_f32(out_proj_w),
               out_b=_f32(out_proj_b))
    for name, t in ops.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    return ops


def _check(lib, kernel: str, rc: int, Lr, L, q0):
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: "
            f"{lib.geom_triangle_error_string(rc).decode()} (code {rc}; "
            f"Lr={Lr}, L={L}, q0={q0})")


def launch(ops: dict, *, q0: int, pad_safe: bool, kernels=None,
           view: int | None = None):
    """Run the three kernels on ``kernel_inputs``' operands, each launch
    checked; returns out [Lr, L, d] in edge's dtype. ``kernels`` (None:
    all) names the ones to launch, for timing them one at a time; a kernel
    left out finds its input as torch.empty left it. ``view`` 0 or 1: the
    single-view form on ``kernel_inputs(..., views=1)``' operands (the
    per-kernel counters count the two-view launches alone)."""
    global tri_proj_launches, tri_mm_launches, tri_out_launches
    lib = _lib()
    edge = ops["edge"]
    Lr, L, d = edge.shape
    Lp = padded_length(L)
    f32, dev = torch.float32, edge.device
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(edge.dtype == torch.bfloat16)
    run = (lambda name: kernels is None or name in kernels)
    two = view is None
    v, views = (-1, (2,)) if two else (view, ())
    act_row = torch.empty(views + (d, Lr, Lp), dtype=f32, device=dev)
    act_col = torch.empty(views + (d, L, Lp), dtype=f32, device=dev)
    if run("tri_proj"):
        _check(lib, "tri_proj", lib.tri_proj(
            edge.data_ptr(), ops["whole"].data_ptr(), ops["act_w"].data_ptr(),
            ops["act_b"].data_ptr(), ops["mask"].data_ptr(),
            int(pad_safe), act_row.data_ptr(), act_col.data_ptr(),
            Lr, L, Lp, q0, v, d, bf16, device, stream), Lr, L, q0)
        tri_proj_launches += two
    ab = torch.empty(views + (d, Lr, Lp), dtype=f32, device=dev)
    if run("tri_mm"):
        _check(lib, "tri_mm", lib.tri_mm(
            act_row.data_ptr(), act_col.data_ptr(), ab.data_ptr(), Lr, L, Lp,
            2 if two else 1, d, device, stream), Lr, L, q0)
        tri_mm_launches += two
    del act_row, act_col  # the caching allocator takes them back in order
    out = torch.empty_like(ops["attended"])
    if run("tri_out"):
        _check(lib, "tri_out", lib.tri_out(
            ab.data_ptr(), edge.data_ptr(), ops["whole"].data_ptr(),
            ops["attended"].data_ptr(), ops["act_w"].data_ptr(),
            ops["act_b"].data_ptr(), ops["out_w"].data_ptr(),
            ops["out_b"].data_ptr(), out.data_ptr(), Lr, L, Lp, q0, v, d,
            bf16, device, stream), Lr, L, q0)
        tri_out_launches += two
    return out


def geom_triangle(edge, whole, attended, mask, act_w, act_b, out_proj_w,
                  out_proj_b, *, q0: int = 0, pad_safe: bool = False):
    """GeometricAttention's triangle-multiplicative branch, added to the
    attended branch's output.

    edge [Lr, L, d], the normalised edge's rows [q0, q0 + Lr) of the window
    (rows past L pad); whole [L, L, d], every row (edge itself outside
    sequence parallelism); attended [Lr, L, d]; mask [L]; act_w [d, 2, 5d],
    act_b [2, 5d], out_proj_w [2, d, d], out_proj_b [2, d] as
    GeometricAttention stores them. Returns attended + the branch, [Lr, L,
    d], in attended's dtype."""
    global triangle_launches
    with span("ops.geom_triangle"):
        args = (edge, whole, attended, mask, act_w, act_b, out_proj_w,
                out_proj_b)
        if _device_of("geom_triangle", args).type == "cpu":
            return geom_triangle_plain(*args, q0=q0, pad_safe=pad_safe)
        ops = kernel_inputs(*args, q0=q0)
        out = launch(ops, q0=q0, pad_safe=pad_safe)
        triangle_launches += 1
        return out


def geom_triangle_view(edge, residual, mask, act_w, act_b, out_w, out_b, *,
                       view: int):
    """One view of the triangle-multiplicative branch, added to
    ``residual``: AlphaFold2's outgoing (``view`` 0) or incoming (1)
    triangle multiplication.

    edge [L, L, d], the normalised pair tensor; residual [L, L, d]; mask
    [L], which masks a's pairs (i, k) and b's rows j, as AlphaFold2's pair
    mask does; act_w [d, 5d], act_b [5d], out_w [d, d], out_b [d] (the
    module docstring's layout). Returns [L, L, d] in residual's dtype."""
    global tri_view_launches
    if view not in (0, 1):
        raise ValueError(f"geom_triangle_view: view={view}, expected 0 or 1")
    with span("ops.geom_triangle"):
        args = (edge, residual, mask, act_w, act_b, out_w, out_b)
        if _device_of("geom_triangle_view", args).type == "cpu":
            return geom_triangle_view_plain(*args, view=view)
        ops = kernel_inputs(edge, *args, q0=0, views=1)
        out = launch(ops, q0=0, pad_safe=True, view=view)
        tri_view_launches += 1
        return out
