"""Sequence parallelism: the residue axis of a window split over the ranks
of a 'seq' mesh axis.

Port of ``dynamicpdb_tpu/parallel/sp.py``. There, a global toggle turns
``shard`` calls on the residue axis into GSPMD sharding constraints and XLA
inserts the collectives. Here the same toggle (``enable``, ``disable``,
``is_active``, ``activated``) makes the model slice its window to this
rank's rows and call the four collectives below itself; each is an
autograd function whose backward is written out. Inactive (no mesh, or a
'seq' size of 1), every function here is the identity and the model runs
the one-process code.

Rows. A window of N residues is padded to ``S * rows`` (S the 'seq' size,
rows = ceil(N / S)), and rank s owns rows [s * rows, (s + 1) * rows). Pad
rows are masked: IPA never takes them as keys (the gathered keys are cut
back to N), ``global_stat_norm`` leaves them out of its statistics and
``ConvNet`` zeroes them after every convolution, which is what its SAME
zero padding puts past row N. So every real row gets what one process
computes, up to the order of float32 sums. ``row_range`` gives the rows,
``take_rows`` a tensor's.

The collectives run on the mesh's 'seq' group (``Mesh.group('seq')``):

  * ``gather_rows``: all-gather along the residue axis; its backward is a
    reduce-scatter (every rank's queries add a partial gradient to every
    key). IPA's keys.
  * ``gather_replicated``: the same all-gather for a value every rank then
    uses identically (the model's per-residue outputs); its backward takes
    this rank's slice of the gradient, with no sum.
  * ``all_reduce_sum``: a sum over the ranks (statistics); its backward is
    an all-reduce of the gradients.
  * ``halo_exchange``: ``width`` rows of each neighbour on either side of
    this rank's rows (zeros beyond the window's ends); its backward sends
    each halo's gradient back to its owner, who adds it.
  * ``column_view``: this rank's rows of a square tensor's transpose, from
    every rank's rows of the tensor (an all-to-all); its backward is the
    column view of the gradient. OmegaFold's GeometricAttention (its
    column branch's output, [rows, L, .] by the rows of the column view,
    back to the rows of the edge).
  * ``rank0``: rank 0's copy of a value every rank computed identically
    (an all-gather of it), so that a choice made on it (OmegaFold's best
    cycle) cannot differ between ranks.

Every rank of a 'seq' group calls them in the same order: each runs the
same model code on rows of the same shape. A collective that fails raises;
nothing falls back to one process.

OmegaFold (``models/omegafold/``) runs under ``torch.inference_mode``, so
only the forwards of its collectives run there.

``timed(True)`` makes each collective synchronise the device before and
after itself and add its seconds to ``seconds``, so a caller can read the
time a step spent in them (the synchronisations are then part of the
step; ``tools/dp_step.py --time-sp``).

The JAX module's ``shard`` is a sharding constraint for XLA's
partitioner; here each rank holds its rows itself, and the collectives
above move them.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib

_MESH: mesh_lib.Mesh | None = None
_TIMED = False
seconds = 0.0  # collective seconds while timed
calls = 0  # collectives run since the last reset_counts()


def enable(mesh) -> bool:
    """Split the residue axis over ``mesh``'s 'seq' axis if it has one of
    size > 1 (a collective-capable mesh: a process group must exist);
    returns whether it did."""
    global _MESH
    if mesh is not None and mesh.sizes.get("seq", 1) > 1:
        if mesh.group("seq") is None:
            raise RuntimeError(f"{mesh} has a 'seq' axis but no process "
                               "group to split the residues over")
        _MESH = mesh
        return True
    _MESH = None
    return False


def disable() -> None:
    global _MESH
    _MESH = None


def is_active() -> bool:
    return _MESH is not None


@contextmanager
def activated(mesh):
    """Sequence parallelism over ``mesh`` inside the block (nothing when
    it has no 'seq' axis), the previous state after it."""
    global _MESH
    prev = _MESH
    try:
        enable(mesh)
        yield
    finally:
        _MESH = prev


def timed(on: bool) -> None:
    global _TIMED
    _TIMED = on


def reset_counts() -> None:
    global seconds, calls
    seconds, calls = 0.0, 0


def size(mesh=None) -> int:
    mesh = _MESH if mesh is None else mesh
    return 1 if mesh is None else mesh.sizes.get("seq", 1)


def index(mesh=None) -> int:
    mesh = _MESH if mesh is None else mesh
    return 0 if mesh is None else mesh.coords.get("seq", 0)


def row_range(n_res: int, mesh=None) -> tuple[int, int, int]:
    """(start, rows, padded): this rank's rows are [start, start + rows) of
    the window of ``n_res`` residues padded to ``padded`` = S * rows.
    ``mesh`` defaults to the active one (then (0, n_res, n_res) when
    inactive)."""
    S = size(mesh)
    rows = -(-n_res // S)
    return index(mesh) * rows, rows, rows * S


def _real_rows(n_res: int, mesh=None) -> tuple[int, int]:
    """(first, count) of this rank's rows that lie inside the window."""
    start, rows, _ = row_range(n_res, mesh)
    first = min(start, n_res)
    return first, min(start + rows, n_res) - first


def take_rows(x: torch.Tensor, n_res: int, dim: int, fill=None):
    """This rank's rows of ``x`` along ``dim`` (of length ``n_res``), the
    pad rows past ``n_res`` filled with ``fill`` (a tensor broadcast to a
    row, e.g. the identity rigid; None: zeros)."""
    dim = dim % x.dim()
    _, rows, _ = row_range(n_res)
    first, count = _real_rows(n_res)
    part = x.narrow(dim, first, count)
    if count == rows:
        return part
    shape = list(x.shape)
    shape[dim] = rows - count
    pad = (x.new_zeros(shape) if fill is None
           else torch.as_tensor(fill, dtype=x.dtype, device=x.device)
           .expand(shape))
    return torch.cat([part, pad], dim=dim)


def host_edge_rows(batch: dict, mesh=None) -> dict:
    """``batch`` with its edge_repr ([..., N, N, De], numpy or CPU tensor)
    cut to this rank's real rows, [..., count, N, De], before it is copied
    to the device: the model takes them for the whole edge tensor
    (``edge_rows``). ``mesh`` defaults to the active one; without a 'seq'
    axis the batch is returned as it is."""
    if size(mesh) == 1 or "edge_repr" not in batch:
        return batch
    edge = batch["edge_repr"]
    first, count = _real_rows(edge.shape[-2], mesh)
    return dict(batch, edge_repr=edge[..., first:first + count, :, :])


def edge_rows(edge: torch.Tensor, n_res: int) -> torch.Tensor:
    """This rank's rows [rows, N, De] of the edge tensor, from the whole
    [N, N, De] or from the real rows ``host_edge_rows`` kept."""
    first, count = _real_rows(n_res)
    if edge.shape[0] == n_res:
        return take_rows(edge, n_res, 0)
    if edge.shape[0] != count or edge.shape[1] != n_res:
        raise ValueError(
            f"edge_repr {tuple(edge.shape)} is neither the whole window's "
            f"[{n_res}, {n_res}, .] nor this rank's {count} rows")
    _, rows, _ = row_range(n_res)
    if count == rows:
        return edge
    return torch.cat([edge, edge.new_zeros((rows - count,) + edge.shape[1:])])


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
@contextmanager
def _collective(device):
    """Counts a collective; while timed, adds its seconds between device
    synchronisations."""
    global seconds, calls
    calls += 1
    if not _TIMED:
        yield
        return
    sync = torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(device)
    seconds += time.perf_counter() - t0


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """[S, *x.shape]: ``x`` of every rank of ``mesh``'s 'seq' group."""
    with _collective(x.device):
        return mesh_lib.all_gather(x, mesh.group("seq"))


def _cat_parts(parts: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(parts.unbind(0), dim=dim)


# The backward of each collective runs on the mesh its forward ran on (kept
# in ctx), so a backward outside the activated block still pairs with the
# other ranks'.
class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, replicated):
        ctx.dim, ctx.replicated, ctx.mesh = dim, replicated, _MESH
        return _cat_parts(_gather(x, _MESH), dim)

    @staticmethod
    def backward(ctx, g):
        dim, mesh = ctx.dim, ctx.mesh
        rows = g.shape[dim] // size(mesh)
        if ctx.replicated:
            # every rank holds the same gradient of the whole: its slice
            return (g.narrow(dim, index(mesh) * rows, rows).contiguous(),
                    None, None)
        with _collective(g.device):
            g = mesh_lib.reduce_scatter(g, mesh.group("seq"), dim)
        return g, None, None


def gather_rows(x: torch.Tensor, n_res: int, dim: int = 1) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim``, cut to the window's
    ``n_res``: the keys every query row attends over. The gradient that
    reaches a rank's rows is the sum of every rank's (a reduce-scatter)."""
    if _MESH is None:
        return x
    dim = dim % x.dim()
    return _GatherRows.apply(x, dim, False).narrow(dim, 0, n_res)


def gather_replicated(x: torch.Tensor, n_res: int, dim: int = 1):
    """Every rank's rows of ``x`` along ``dim``, cut to ``n_res``, for a
    computation every rank then repeats identically (the model's outputs
    feeding the loss or the sampler): the backward takes this rank's slice
    of the gradient and sums nothing."""
    if _MESH is None:
        return x
    dim = dim % x.dim()
    return _GatherRows.apply(x, dim, True).narrow(dim, 0, n_res)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh = _MESH
        y = x.clone()
        with _collective(y.device):
            mesh_lib.all_reduce_(y, _MESH.group("seq"))
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        with _collective(g.device):
            mesh_lib.all_reduce_(g, ctx.mesh.group("seq"))
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the 'seq' ranks (each rank's partial sums of
    a statistic); the backward sums the ranks' gradients, since each rank's
    rows used the total."""
    if _MESH is None:
        return x
    return _AllReduceSum.apply(x)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, width, dim):
        ctx.width, ctx.dim, ctx.mesh = width, dim, _MESH
        rows = x.shape[dim]
        edges = torch.cat([x.narrow(dim, 0, width),
                           x.narrow(dim, rows - width, width)], dim)
        parts = _gather(edges.float(), _MESH).to(x.dtype)  # [S, .., 2w, ..]
        s, S = index(), size()
        zero = x.new_zeros(x.narrow(dim, 0, width).shape)
        # the rank before's last rows, the rank after's first rows
        top = parts[s - 1].narrow(dim, width, width) if s > 0 else zero
        bot = parts[s + 1].narrow(dim, 0, width) if s + 1 < S else zero
        return torch.cat([top, x, bot], dim)

    @staticmethod
    def backward(ctx, g):
        w, dim, mesh = ctx.width, ctx.dim, ctx.mesh
        rows = g.shape[dim] - 2 * w
        halos = torch.cat([g.narrow(dim, 0, w), g.narrow(dim, rows + w, w)],
                          dim)
        parts = _gather(halos.float(), mesh).to(g.dtype)
        s, S = index(mesh), size(mesh)
        gx = g.narrow(dim, w, rows).clone()
        # my first rows were the rank before's bottom halo, my last rows
        # the rank after's top halo
        if s > 0:
            gx.narrow(dim, 0, w).add_(parts[s - 1].narrow(dim, w, w))
        if s + 1 < S:
            gx.narrow(dim, rows - w, w).add_(parts[s + 1].narrow(dim, 0, w))
        return gx, None, None


def halo_exchange(x: torch.Tensor, width: int, dim: int = 1) -> torch.Tensor:
    """``x`` with ``width`` rows of the neighbouring ranks on either side
    along ``dim`` (zeros at the window's two ends): [..., rows + 2 width,
    ...]. Sent in float32 (exact for bfloat16). Needs rows >= width."""
    if _MESH is None:
        return x
    dim = dim % x.dim()
    if x.shape[dim] < width:
        raise ValueError(f"halo_exchange: {x.shape[dim]} rows a rank, fewer "
                         f"than the halo's {width}; use fewer 'seq' ranks")
    return _HaloExchange.apply(x, width, dim)


class _ColumnView(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_res):
        ctx.n_res, ctx.mesh = n_res, _MESH
        return _column_view(x, n_res, _MESH)

    @staticmethod
    def backward(ctx, g):
        # y[i, k] = x[k, i] over the whole tensor: the adjoint of a
        # transpose is the transpose
        return _column_view(g.contiguous(), ctx.n_res, ctx.mesh), None


def _column_view(x, n_res: int, mesh) -> torch.Tensor:
    """x [rows, n_res, ...] (rows of a square tensor) -> [rows, n_res, ...],
    out[i, k] = whole[k, start + i]. Rank t gets the block x[:, its
    columns] of every rank: one all-to-all (``mesh.all_to_all``; gloo has
    one, with CUDA tensors staged through host memory)."""
    S, rows = size(mesh), x.shape[0]
    rest = x.shape[2:]
    cols = torch.cat([x, x.new_zeros((rows, S * rows - n_res) + rest)], 1)
    # [S * rows columns, rows, ...]: part t is the block rank t receives
    send = cols.transpose(0, 1)
    with _collective(x.device):
        got = mesh_lib.all_to_all(send, mesh.group("seq"))
    # part s is whole[s's rows, my columns], indexed [my column, s's row]
    got = got.reshape((S, rows, rows) + rest).transpose(0, 1)
    return got.reshape((rows, S * rows) + rest)[:, :n_res]


def column_view(x: torch.Tensor, n_res: int) -> torch.Tensor:
    """This rank's rows of the transpose of a square [n_res, n_res, ...]
    tensor of which every rank holds its rows: x [rows, n_res, ...], out
    [rows, n_res, ...] with out[i, k] = whole[k, start + i] (zeros in pad
    rows). Inactive: ``x.transpose(0, 1)``."""
    if _MESH is None:
        return x.transpose(0, 1)
    return _ColumnView.apply(x, n_res)


def rank0(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of the 'seq' group, for a value each
    rank computed identically from the same inputs (forward only)."""
    if _MESH is None:
        return x
    return _gather(x.detach(), _MESH)[0]
