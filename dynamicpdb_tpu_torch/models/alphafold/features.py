"""AlphaFold2's MSA data path: an a3m file to each recycle's features.

``parse_a3m`` reads an a3m alignment (the query first) into tokens and
deletion counts, as AlphaFold2's ``parsers.parse_a3m`` and
``make_msa_features`` do: lowercase letters are insertions, removed from
the row and counted against the next aligned column; a row equal to an
earlier one is dropped; letters map to AlphaFold2's 20 residue types in
the order ``ARNDCQEGHILKMFPSTWYV`` (B as D, Z as E, U as C), any other to
X (20), '-' to the gap (21).

``recycle_features`` then makes each recycle's inputs as AlphaFold2's
eval pipeline (``input_pipeline.ensembled_transform_fns``, ``num_ensemble``
1) does afresh for every recycle: the query and a random ``max_clusters``
- 1 other rows become the cluster centres, and the rest the extra rows
(``sample_msa``); 15% of the centres' positions are replaced, with 0.1
each by a uniformly drawn residue type, a draw from the column's profile
(the whole MSA's, gaps included) or the token itself, and by the mask
token (22) otherwise (``make_masked_msa``); every extra row joins the
centre it agrees with at the most non-gap positions, the first on a tie
(``nearest_neighbor_clusters``, gap weight 0), which gives each centre
its profile and mean deletions (``summarize_clusters``); a random
``max_extra`` of the extra rows are kept (``crop_extra_msa``); last come
``msa_feat`` [clusters, L, 49] and ``extra_msa_feat`` [extra, L, 25]
(``make_msa_feat``, ``create_extra_msa_feature``).

Every random choice (the cluster order, the replaced positions and what
replaces them, the crop) comes from one NumPy generator seeded with the
sequence's name and the recycle (``recycle_draws``), so any implementation
that draws in the same order draws the same. A draw from a column's
profile is the token of a uniformly drawn row: the same distribution as
AlphaFold2's categorical draw, in integers. The assignment of the extra
rows is an agreement product of one-hot rows, [extra, 23 L] x [23 L,
clusters] (~22 GFLOP at 4,096 rows of 256), so it runs in torch on the
model's device; sums of integers are exact in float32, so the counts,
profiles and assignments do not depend on the order of a sum.

A single sequence takes no padding, so every AlphaFold2 mask (the MSA's,
the extra MSA's, the pair mask) is all ones and none is formed. An
alignment with no more rows than ``max_clusters`` has no extra rows:
AlphaFold2 would pad its extra MSA with masked rows; here the extra stack
is then skipped.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import numpy as np
import torch

RESTYPES = "ARNDCQEGHILKMFPSTWYV"
UNK, GAP, MASK = 20, 21, 22
NUM_TOKENS = 23  # the residue types, X, the gap and the mask token

_TOKENS = np.full(256, UNK, np.int8)
for _i, _a in enumerate(RESTYPES):
    _TOKENS[ord(_a)] = _i
for _a, _b in (("B", "D"), ("Z", "E"), ("U", "C")):
    _TOKENS[ord(_a)] = RESTYPES.index(_b)
_TOKENS[ord("-")] = GAP


@dataclass
class MSA:
    """An alignment: ``tokens`` [N, L] int8 (row 0 the query),
    ``deletions`` [N, L] float32 (insertions before each column)."""

    name: str
    tokens: np.ndarray
    deletions: np.ndarray


def parse_a3m(lines, name: str | None = None) -> MSA:
    """The alignment of a3m text (an iterable of lines, the query's record
    first). ``name`` defaults to the first header's first word."""
    rows: list[str] = []
    parts: list[str] | None = None
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line[0] == ">":
            if parts is not None:
                rows.append("".join(parts))
            elif name is None:
                name = line[1:].split()[0] if line[1:].split() else ""
            parts = []
        elif parts is None:
            raise ValueError("a3m sequence line before any '>' header")
        else:
            parts.append(line)
    if parts is not None:
        rows.append("".join(parts))
    if not rows or not rows[0]:
        raise ValueError("a3m with no query sequence")
    buf = np.frombuffer("".join(rows).encode("ascii"), np.uint8)
    lengths = np.array([len(r) for r in rows])
    lower = (buf >= ord("a")) & (buf <= ord("z"))
    aligned = np.flatnonzero(~lower)
    starts = np.r_[0, np.cumsum(lengths)[:-1]]
    n_aligned = np.add.reduceat((~lower).astype(np.int64), starts)
    L = int(n_aligned[0])
    if np.any(n_aligned != L):
        bad = int(np.flatnonzero(n_aligned != L)[0])
        raise ValueError(f"a3m row {bad} has {n_aligned[bad]} aligned "
                         f"columns, the query {L}")
    tokens = _TOKENS[buf[aligned]].reshape(len(rows), L)
    if np.any(tokens[0] == GAP):
        raise ValueError("the a3m's query has gaps")
    # insertions before each aligned column: lowercase counts between it
    # and the row's previous aligned column (or its start)
    low_before = np.cumsum(lower)[aligned].reshape(len(rows), L)
    base = np.cumsum(np.r_[0, lower])[starts]
    deletions = np.diff(np.concatenate([base[:, None], low_before], 1), axis=1)
    # AlphaFold2 keeps the first of equal aligned rows
    _, first = np.unique(np.ascontiguousarray(tokens).view(
        np.dtype((np.void, L))).ravel(), return_index=True)
    keep = np.sort(first)
    return MSA(name=name or "", tokens=tokens[keep],
               deletions=deletions[keep].astype(np.float32))


def recycle_draws(name: str, recycle: int, n_seq: int, n_res: int, *,
                  max_clusters: int, max_extra: int,
                  replace_fraction: float) -> dict:
    """The random choices of one recycle, in this order: the rows' order
    behind the query, which centre positions are replaced, the kind of
    each replacement, a residue type and a row for each, the extra rows'
    crop. The generator is seeded with [crc32(name), recycle]."""
    rng = np.random.default_rng([zlib.crc32(name.encode("utf-8")),
                                 int(recycle)])
    order = np.concatenate([[0], 1 + rng.permutation(n_seq - 1)])
    n_sel = min(max_clusters, n_seq)
    shape = (n_sel, n_res)
    replaced = rng.random(shape) < replace_fraction
    kind = rng.random(shape)
    residue = rng.integers(0, 20, shape)
    row = rng.integers(0, n_seq, shape)
    crop = rng.permutation(n_seq - n_sel)[:max_extra]
    return dict(centres=order[:n_sel], extra=order[n_sel:], replaced=replaced,
                kind=kind, residue=residue, row=row, crop=crop)


def _deletion_value(d):
    return torch.atan(d / 3.0) * (2.0 / math.pi)


def masked_centres(tokens, draws: dict):
    """The centres' tokens after the masked-MSA replacement (tokens [N, L]
    long on the device)."""
    dev = tokens.device
    t = lambda k: torch.as_tensor(draws[k], device=dev)  # noqa: E731
    centres = tokens[t("centres")]
    cols = torch.arange(tokens.shape[1], device=dev)
    kind = t("kind")
    repl = torch.where(kind < 0.1, t("residue"), torch.where(
        kind < 0.2, tokens[t("row"), cols], torch.where(
            kind < 0.3, centres, torch.full_like(centres, MASK))))
    return torch.where(t("replaced"), repl, centres)


def recycle_features(msa: MSA, tokens, deletions, recycle: int, *,
                     max_clusters: int, max_extra: int,
                     replace_fraction: float) -> dict:
    """One recycle's inputs, on the device of ``tokens`` ([N, L] long) and
    ``deletions`` ([N, L] float32), the alignment's copies there:
    ``msa_feat`` [clusters, L, 49] and ``extra_msa_feat`` [extra, L, 25]
    (extra 0 when the alignment has no rows past the clusters)."""
    N, L = tokens.shape
    draws = recycle_draws(msa.name, recycle, N, L, max_clusters=max_clusters,
                          max_extra=max_extra,
                          replace_fraction=replace_fraction)
    dev = tokens.device
    centres = masked_centres(tokens, draws)
    sel = torch.as_tensor(draws["centres"], device=dev)
    extra = torch.as_tensor(draws["extra"], device=dev)
    c_del = deletions[sel]
    c_hot = torch.nn.functional.one_hot(centres, NUM_TOKENS).float()
    n_sel = c_hot.shape[0]
    if extra.numel():
        e_tok, e_del = tokens[extra], deletions[extra]
        e_hot = torch.nn.functional.one_hot(e_tok, NUM_TOKENS).float()
        weights = torch.ones(NUM_TOKENS, device=dev)
        weights[GAP:] = 0.0  # gaps and the mask token agree with nothing
        agreement = e_hot.reshape(len(extra), -1) @ (
            c_hot * weights).reshape(n_sel, -1).T
        assign = agreement.argmax(1)
        counts = torch.zeros(n_sel, L, device=dev).index_add_(
            0, assign, torch.ones_like(e_del)) + (1.0 + 1e-6)
        profile = (c_hot + torch.zeros_like(c_hot).index_add_(
            0, assign, e_hot)) / counts[..., None]
        del_mean = (c_del + torch.zeros_like(c_del).index_add_(
            0, assign, e_del)) / counts
        crop = torch.as_tensor(draws["crop"], device=dev)
        e_hot, e_del = e_hot[crop], e_del[crop]
    else:
        profile = c_hot / (1.0 + 1e-6)
        del_mean = c_del / (1.0 + 1e-6)
        e_hot = torch.zeros(0, L, NUM_TOKENS, device=dev)
        e_del = torch.zeros(0, L, device=dev)
    msa_feat = torch.cat([
        c_hot, c_del.clamp(0.0, 1.0)[..., None],
        _deletion_value(c_del)[..., None], profile,
        _deletion_value(del_mean)[..., None]], -1)
    extra_feat = torch.cat([
        e_hot, e_del.clamp(0.0, 1.0)[..., None],
        _deletion_value(e_del)[..., None]], -1)
    return {"msa_feat": msa_feat, "extra_msa_feat": extra_feat}


def target_feat(aatype):
    """[L, 22]: the chain-break flag (0 for one chain) and the query's
    residue types, one-hot over 21."""
    hot = torch.nn.functional.one_hot(aatype, 21).float()
    return torch.cat([torch.zeros_like(hot[:, :1]), hot], -1)


def sequence_features(msa: MSA, device, *, num_recycles: int,
                      max_clusters: int, max_extra: int,
                      replace_fraction: float) -> dict:
    """Every recycle's inputs on ``device``: ``aatype`` [L], ``target_feat``
    [L, 22], ``residue_index`` [L] and the list ``recycles`` of
    ``recycle_features``."""
    tokens = torch.as_tensor(msa.tokens, device=device).long()
    deletions = torch.as_tensor(msa.deletions, device=device)
    aatype = tokens[0]
    return {
        "aatype": aatype, "target_feat": target_feat(aatype),
        "residue_index": torch.arange(tokens.shape[1], device=device),
        "recycles": [recycle_features(
            msa, tokens, deletions, r, max_clusters=max_clusters,
            max_extra=max_extra, replace_fraction=replace_fraction)
            for r in range(num_recycles)],
    }
