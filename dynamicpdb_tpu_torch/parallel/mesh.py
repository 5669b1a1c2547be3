"""Process mesh and collectives for data-parallel training.

Port of ``dynamicpdb_tpu/parallel/mesh.py``. JAX builds one SPMD program
over a device mesh and lets XLA place the gradient all-reduce; here one
process drives one device, a launcher (``torchrun`` /
``python -m torch.distributed.run``) starts the processes, and the trainer
calls the collectives itself:

  * ``maybe_initialize_distributed`` starts ``torch.distributed`` when a
    launcher's environment is set (the counterpart of
    ``jax.distributed.initialize``);
  * ``Mesh`` names the ranks' axes ('slice', 'data', 'model'), laid out
    row-major over the ranks as ``np.arange(world).reshape(shape)``, and
    holds one process group per set of axes the trainer reduces over;
  * ``batch_axes``, ``data_size`` and ``data_index`` say which rows of the
    global batch a rank trains on (the sampler hands each process its own
    rows, as in the JAX multi-host path, so ``shard_batch`` has no
    counterpart);
  * ``all_reduce_`` and ``all_gather`` run on a mesh group,
    or do nothing when there is no process group (one process, no
    launcher).

The 'seq' axis (residue-axis sequence parallelism, ``parallel/sp.py`` in
the JAX package) is not ported: a mesh that names it raises.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")
NOT_BATCH_AXES = ("model", "seq")
UNPORTED_AXES = {"seq": "sequence parallelism (dynamicpdb_tpu/parallel/sp.py)"}


def launched() -> bool:
    """True when a launcher's environment names this process's rank."""
    return all(os.environ.get(k) for k in LAUNCHER_ENV)


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(backend: str | None = None,
                                 device="cuda") -> bool:
    """Start ``torch.distributed`` from the launcher's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), at any
    world size, 1 included. A no-op returning False without that
    environment; idempotent. ``backend`` defaults to
    ``default_backend(device)``. A failure to join (a bad address, a
    timeout) raises: it never degrades to a single process."""
    if not launched():
        return False
    backend = backend or default_backend(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"torch.distributed already runs {dist.get_backend()!r}, "
                f"not the {backend!r} asked for")
        return True
    dist.init_process_group(backend=backend, init_method="env://")
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return world()[0] == 0


def barrier():
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (the others wait for it)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class Mesh:
    """Named axes over the ranks. ``shape`` and ``axis_names`` as in a JAX
    mesh; ``sizes[axis]`` is an axis's size. Rank r sits at
    ``np.unravel_index(r, shape)``. ``group(*axes)`` is the process group
    of the ranks that differ from this one only on ``axes`` (None without
    a process group). Built without a process group (``groups=False``),
    a mesh only answers questions of sizes and coordinates, as the
    sharding rules need."""

    def __init__(self, shape, axis_names, *, rank: int = 0,
                 groups: bool = True):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)[: len(shape)]
        if len(axis_names) != len(shape):
            raise ValueError(f"mesh shape {shape} needs {len(shape)} axis "
                             f"names, got {axis_names}")
        for axis in axis_names:
            if axis in UNPORTED_AXES:
                raise ValueError(
                    f"mesh axis {axis!r} ({UNPORTED_AXES[axis]}) is not yet "
                    "ported to dynamicpdb_tpu_torch; use 'slice', 'data' "
                    "and 'model' axes")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.shape, self.axis_names = shape, axis_names
        self.sizes = dict(zip(axis_names, shape))
        self.rank = rank
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            rank, shape))))
        self._groups: dict[tuple, object] = {}
        if groups and dist.is_initialized():
            # every rank builds the groups in the same order
            for axes in (batch_axes(self), ("data",), ("model",)):
                if (axes and axes not in self._groups
                        and all(a in self.sizes for a in axes)):
                    self._groups[axes] = self._new_group(axes)

    def size(self, *axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def index(self, *axes) -> int:
        """This rank's row-major index over ``axes`` (0 on absent axes)."""
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, *axes):
        return self._groups.get(tuple(axes))

    def _new_group(self, axes: tuple):
        """Every rank builds every group of the partition by ``axes`` (a
        collective); returns this rank's."""
        grid = np.arange(math.prod(self.shape)).reshape(self.shape)
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.shape)) if i not in keep]
        rows = np.transpose(grid, rest + keep).reshape(
            -1, math.prod(self.shape[i] for i in keep))
        if rows.shape[0] == 1:
            return dist.group.WORLD
        mine, _ = dist.new_subgroups_by_enumeration(rows.tolist())
        return mine

    def __repr__(self):
        return f"Mesh({self.sizes}, rank={self.rank})"


def make_mesh(shape: tuple = (), axes: tuple = ("data",)) -> Mesh:
    """A mesh over every rank; ``shape=()`` puts them all on 'data'. A
    world of one process (with or without a process group) gives a mesh
    of shape (1,). Raises ValueError when the shape does not cover the
    world exactly, or names an axis that is not ported ('seq')."""
    rank, n = world()
    shape = tuple(int(s) for s in shape) or (n,)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks "
                         f"but the world has {n} process(es)")
    return Mesh(shape, axes, rank=rank)


def detect_num_slices() -> int:
    """The number of nodes, ``WORLD_SIZE // LOCAL_WORLD_SIZE`` (the GPU
    analogue of TPU slices: the outer axis whose links are the slow
    ones); 1 without a launcher."""
    n = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return max(n // max(local, 1), 1)


def make_hybrid_mesh(n_slices: int | None = None, model_axis: int = 1) -> Mesh:
    """('slice', 'data'[, 'model']) with slice = node: the launcher numbers
    ranks node by node, so the row-major layout keeps each slice's ranks on
    one node and the gradient all-reduce crosses nodes once per group.
    Pass ``n_slices`` to emulate several nodes on one."""
    rank, n = world()
    if n_slices is None:
        n_slices = detect_num_slices()
    if n % n_slices or (n // n_slices) % model_axis:
        raise ValueError(
            f"{n} devices cannot factor into {n_slices} slices "
            f"x data x model={model_axis}")
    data = n // n_slices // model_axis
    axes = ("slice", "data", "model")[: 2 + (model_axis > 1)]
    shape = (n_slices, data) + ((model_axis,) if model_axis > 1 else ())
    return Mesh(shape, axes, rank=rank)


def batch_axes(mesh: Mesh) -> tuple:
    """The data-like axes, over which the batch is split: every axis but
    'model' (and 'seq'), which replicate it. The counterpart of
    ``batch_sharding``."""
    return tuple(a for a in mesh.axis_names if a not in NOT_BATCH_AXES)


def data_size(mesh: Mesh | None) -> int:
    """How many ways the global batch is split."""
    return 1 if mesh is None else mesh.size(*batch_axes(mesh))


def data_index(mesh: Mesh | None) -> int:
    """This rank's index among ``data_size`` (ranks that differ only on
    'model' share it, and train on the same rows)."""
    return 0 if mesh is None else mesh.index(*batch_axes(mesh))


def local_batch_indices(global_batch: int, process_index: int,
                        process_count: int):
    """Per-host slice of the global batch (replaces DistributedSampler rank
    striding, Dfold_data_loader_dynamic.py:492-522)."""
    per_host = global_batch // process_count
    start = process_index * per_host
    return np.arange(start, start + per_host)


# ---------------------------------------------------------------------------
# collectives on a mesh group (None: no process group, nothing to do)
# ---------------------------------------------------------------------------
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (gloo and NCCL both take CUDA
    tensors here)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[n, *t.shape]: ``t`` of each of the group's n ranks, in group rank
    order, on ``t``'s device. Gloo's all_gather takes only CPU tensors, so
    under gloo a CUDA tensor (two ranks sharing one card) is staged
    through host memory; NCCL gathers on the card."""
    if group is None:
        return t.unsqueeze(0)
    n = dist.get_world_size(group)
    src = t.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)
