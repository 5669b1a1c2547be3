"""Parameter and optimizer-state sharding over a ('data', 'model') mesh.

Port of ``dynamicpdb_tpu/parallel/sharding.py`` for the port's parameter
layout (the reference torch layout): the trailing output axis of a flax
kernel is axis 0 of a torch ``Linear`` or ``Conv2d`` weight, and a vector
keeps its one axis, so the rules below read axis 0 where the JAX rules
read axis -1. A spec is a tuple with one entry per axis: the mesh axis the
tensor is split over, or None.

  * ``param_spec``: a parameter whose output axis divides the 'model' size
    and holds at least 128 entries is split over 'model' along it;
  * ``zero_spec``: an optimizer-state leaf of at least 1024 elements is
    also split over 'data' along its largest other axis that 'data'
    divides (ZeRO-1). 'slice' is never used;
  * ``sharded_fraction``: the share of parameter elements ``param_spec``
    splits.

``ParamLayout`` applies them to a model. Under 'model' each such parameter
is stored as this rank's slice of its output axis between steps
(``release``), gathered whole for the forward and backward
(``materialize``): the split is of storage, not of the products, which
every rank computes in full on the same rows. The optimizer updates only
``region(p, t)`` of each parameter, the slice of this rank on 'model' and,
with ZeRO, on 'data'; its state has the region's shape, and
``gather_updates`` puts the updated regions back together over 'data'.
"""
from __future__ import annotations

import contextlib
import math

import torch

from dynamicpdb_tpu_torch.parallel import mesh as mesh_lib

OUTPUT_AXIS = 0  # of a torch Linear / Conv2d weight, and of a vector
MODEL_MIN = 128  # the output axis's least length worth splitting over 'model'
ZERO_MIN = 1024  # the least number of elements ZeRO splits
STATE_KEYS = ("mu", "nu", "nu_max", "ema")


def param_spec(name: str, shape, model_axis_size: int) -> tuple:
    """Split the output axis over 'model' when it divides and is long
    enough to matter; replicate everything else (biases of narrow layers,
    norms, small heads)."""
    shape = tuple(shape)
    if (len(shape) >= 1 and shape[OUTPUT_AXIS] % model_axis_size == 0
            and shape[OUTPUT_AXIS] >= MODEL_MIN):
        return tuple("model" if i == OUTPUT_AXIS else None
                     for i in range(len(shape)))
    return (None,) * len(shape)


def zero_spec(name: str, shape, mesh: mesh_lib.Mesh) -> tuple:
    """ZeRO-1 spec of one optimizer-state leaf: the parameter's 'model'
    split, and 'data' on the largest remaining axis that the 'data' size
    divides (the first such axis on a tie)."""
    shape = tuple(shape)
    dims = [None] * len(shape)
    if "model" in mesh.sizes:
        dims = list(param_spec(name, shape, mesh.sizes["model"]))
    d = mesh.sizes.get("data", 1)
    if d > 1 and math.prod(shape) >= ZERO_MIN:
        best = -1
        for i, s in enumerate(shape):
            if dims[i] is None and s % d == 0 and (best < 0 or s > shape[best]):
                best = i
        if best >= 0:
            dims[best] = "data"
    return tuple(dims)


def sharded_fraction(named_params, mesh: mesh_lib.Mesh) -> float:
    """Fraction of parameter elements ``param_spec`` splits over 'model'
    (0 without a 'model' axis). ``named_params``: (name, tensor) pairs."""
    if "model" not in mesh.sizes:
        return 0.0
    m = mesh.sizes["model"]
    total = sharded = 0
    for name, p in named_params:
        total += p.numel()
        if any(param_spec(name, p.shape, m)):
            sharded += p.numel()
    return sharded / max(total, 1)


class _Split:
    """Where one parameter is split: ``axis`` into ``count`` equal slices,
    of which this rank holds ``index``."""

    def __init__(self, axis: int, count: int, index: int):
        self.axis, self.count, self.index = axis, count, index

    def take(self, t: torch.Tensor, index: int | None = None) -> torch.Tensor:
        n = t.shape[self.axis] // self.count
        i = self.index if index is None else index
        return t.narrow(self.axis, i * n, n)


class ParamLayout:
    """This rank's share of every parameter of ``model`` on ``mesh``; ZeRO
    over 'data' when ``zero`` (experiment.zero_opt_state)."""

    def __init__(self, model: torch.nn.Module, mesh: mesh_lib.Mesh,
                 zero: bool):
        self.model_group = mesh.group("model")
        self.data_group = mesh.group("data")
        m = mesh.sizes.get("model", 1)
        d = mesh.sizes.get("data", 1)
        self.model_split: dict[torch.nn.Parameter, _Split] = {}
        self.zero_split: dict[torch.nn.Parameter, _Split] = {}
        for name, p in model.named_parameters():
            spec = (zero_spec(name, p.shape, mesh) if zero
                    else param_spec(name, p.shape, m) if m > 1
                    else (None,) * p.ndim)
            for axis, what in enumerate(spec):
                if what == "model" and m > 1:
                    self.model_split[p] = _Split(axis, m,
                                                 mesh.coords["model"])
                elif what == "data":
                    self.zero_split[p] = _Split(axis, d, mesh.coords["data"])
        self.shards: dict[torch.nn.Parameter, torch.Tensor] = {}
        self.params = list(model.parameters())

    # -- the optimizer's view ----------------------------------------------
    def region(self, p: torch.nn.Parameter, t: torch.Tensor) -> torch.Tensor:
        """The part of ``t`` (shaped like the whole ``p``) whose update and
        optimizer state this rank owns."""
        if p in self.model_split:
            t = self.model_split[p].take(t)
        if p in self.zero_split:
            t = self.zero_split[p].take(t)
        return t

    def gather_updates(self):
        """After the optimizer updated each rank's ZeRO region: every
        rank's regions of every parameter, over 'data', in one gather."""
        params = [p for p in self.params if p in self.zero_split]
        if not params or self.data_group is None:
            return
        flat = torch.cat([self.region(p, p.detach()).reshape(-1)
                          for p in params])
        gathered = mesh_lib.all_gather(flat, self.data_group)
        off = 0
        for p in params:
            mine = self.region(p, p.detach())
            n = mine.numel()
            split = self.zero_split[p]
            whole = (self.model_split[p].take(p.detach())
                     if p in self.model_split else p.detach())
            for q in range(split.count):
                split.take(whole, q).copy_(
                    gathered[q, off:off + n].view(mine.shape))
            off += n

    # -- 'model': storage between steps -------------------------------------
    def release(self):
        """Keep only this rank's 'model' slice of each split parameter."""
        if self.shards:
            return
        for p, split in self.model_split.items():
            self.shards[p] = split.take(p.detach()).clone()
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def materialize(self):
        """Every split parameter whole again, from the 'model' slices of
        its group, in one gather."""
        if not self.shards:
            return
        params = [p for p in self.params if p in self.model_split]
        flat = torch.cat([self.shards[p].reshape(-1) for p in params])
        gathered = mesh_lib.all_gather(flat, self.model_group)
        off = 0
        for p in params:
            shard = self.shards[p]
            n = shard.numel()
            p.data = gathered[:, off:off + n].reshape(
                (-1,) + tuple(shard.shape[1:]))
            off += n
        self.shards.clear()

    @contextlib.contextmanager
    def whole(self):
        """Whole parameters inside the block (a checkpoint, an eval), this
        rank's slices again after it; a collective on every rank."""
        self.materialize()
        try:
            yield
        finally:
            self.release()

    # -- the optimizer state in checkpoints ----------------------------------
    def full_state(self, state_dict: dict) -> dict:
        """The optimizer's state dict with every moment gathered to the
        parameter's whole shape (a collective on every rank)."""
        state = {}
        for i, p in enumerate(self.params):
            st = dict(state_dict["state"].get(i, {}))
            for k in STATE_KEYS:
                if k in st:
                    st[k] = self._gather_state(p, st[k])
            if st:
                state[i] = st
        return dict(state_dict, state=state)

    def local_state(self, state_dict: dict) -> dict:
        """The inverse of ``full_state``: this rank's regions of a state
        dict that holds whole moments (a checkpoint of any mesh)."""
        state = {}
        for i, p in enumerate(self.params):
            st = dict(state_dict["state"].get(i, {}))
            for k in STATE_KEYS:
                if k in st:
                    st[k] = self.region(p, st[k]).clone()
            if st:
                state[i] = st
        return dict(state_dict, state=state)

    def _gather_state(self, p, t: torch.Tensor) -> torch.Tensor:
        # float32 on the wire (bf16 -> f32 -> bf16 is exact)
        out = t.float()
        for split, group in ((self.zero_split.get(p), self.data_group),
                             (self.model_split.get(p), self.model_group)):
            if split is not None:
                parts = mesh_lib.all_gather(out, group)
                out = torch.cat(list(parts), dim=split.axis)
        return out.to(t.dtype)
