"""One process, no mesh: the identity of every sequence-parallel helper the
copied modules call, so the reference runs each window whole."""
from __future__ import annotations

import contextlib


def is_active() -> bool:
    return False


def activated(mesh):
    return contextlib.nullcontext()


def row_range(n_res: int, mesh=None) -> tuple[int, int, int]:
    return 0, n_res, n_res


def take_rows(x, n_res: int, dim: int, fill=None):
    return x


def edge_rows(edge, n_res: int):
    return edge


def gather_rows(x, n_res: int, dim: int = 1):
    return x


def gather_replicated(x, n_res: int, dim: int = 1):
    return x


def all_reduce_sum(x):
    return x


def halo_exchange(x, width: int, dim: int = 1):
    raise AssertionError("no halo without a mesh")


def column_view(x, n_res: int):
    return x.transpose(0, 1)


def rank0(x):
    return x
