"""OmegaFold input pipeline: FASTA text to per-cycle pseudo-MSA inputs.

Port of ``dynamicpdb_tpu/models/omegafold/pipeline.py``. Each cycle holds
``num_pseudo_msa`` randomly masked copies of the sequence under the unmasked
row, masked positions carrying the mask token (21). The masks are drawn with
torch's CPU generator seeded by the sequence length, the reference
extractor's ``deterministic`` mode, so the inputs are bitwise those of the
JAX package and of the reference.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

RESTYPES = "ARNDCQEGHILKMFPSTWYV"  # + X (20); '-' / mask token = 21
MASK_TOKEN = 21


def parse_fasta(fasta_lines) -> list[tuple[str, str]]:
    """[(chain_id, sequence)] sorted by sequence length.

    Sequence lines attach to the most recent header; a sequence line before
    any header, or a header with no sequence, raises (the chain id names the
    output file, so a mispairing would corrupt the mapping)."""
    records: list[tuple[str, list[str]]] = []
    for line in fasta_lines:
        line = line.rstrip("\n")
        if len(line) == 0:
            continue
        if line.startswith(">") or line.startswith(":"):
            records.append((line[1:], []))
        else:
            if not records:
                raise ValueError("FASTA sequence line before any '>' header")
            records[-1][1].append(line.upper())
    empty = [cid for cid, parts in records if not parts]
    if empty:
        raise ValueError(f"FASTA records with no sequence: {empty}")
    return sorted(((cid, "".join(parts)) for cid, parts in records),
                  key=lambda x: len(x[1]))


def tokenize(seq: str) -> np.ndarray:
    """Sequence string -> int tokens (Z->E, B->D, U->C, X->20, '-'->21)."""
    seq = seq.replace("Z", "E").replace("B", "D").replace("U", "C")
    out = []
    for aa in seq:
        if aa == "-":
            out.append(MASK_TOKEN)
        elif aa == "X":
            out.append(20)
        else:
            idx = RESTYPES.find(aa)
            if idx < 0:
                raise ValueError(f"unknown residue {aa!r}")
            out.append(idx)
    return np.asarray(out, np.int64)


def make_pseudo_msa(aatype: np.ndarray, *, num_pseudo_msa: int = 15,
                    mask_rate: float = 0.12, num_cycle: int = 10,
                    deterministic: bool = True, seed: int | None = None
                    ) -> list[dict]:
    """Per-cycle {p_msa [M, L], p_msa_mask [M, L]}: row 0 is the sequence,
    rows 1..M-1 randomly masked copies with token 21 where masked."""
    num_res = len(aatype)
    mask = np.ones((num_res,), np.float32)
    g = None
    if deterministic:
        g = torch.Generator()
        g.manual_seed(num_res if seed is None else seed)
    data = []
    for _ in range(num_cycle):
        p_msa_mask = torch.rand([num_pseudo_msa, num_res],
                                generator=g).numpy() > mask_rate
        p_msa_mask = np.concatenate([mask[None, :], p_msa_mask], axis=0)
        p_msa = np.tile(aatype[None, :], (num_pseudo_msa + 1, 1))
        p_msa[p_msa_mask == 0] = MASK_TOKEN
        data.append({"p_msa": p_msa.astype(np.int64),
                     "p_msa_mask": p_msa_mask.astype(np.float32)})
    return data


def pad_cycle_inputs(cycles: list[dict], pad_to: int) -> list[dict]:
    """Right-pad each cycle's inputs along the residue axis to ``pad_to``.

    Padding columns carry token 20 ('X') with mask 0, not the mask token
    21: the PLM's token-dropout rescale counts token-21 positions, so a
    21-padded tail would perturb every real row. Run the model with
    ``pad_safe=True`` and slice the outputs back to 'num_res'."""
    out = []
    for cyc in cycles:
        n = cyc["p_msa"].shape[-1]
        if pad_to < n:
            raise ValueError(f"pad_to={pad_to} < sequence length {n}")
        pad = pad_to - n
        out.append({
            "p_msa": np.pad(cyc["p_msa"], ((0, 0), (0, pad)),
                            constant_values=20),
            "p_msa_mask": np.pad(cyc["p_msa_mask"], ((0, 0), (0, pad))),
            "num_res": n,
        })
    return out


def fasta2inputs(fasta_lines, *, num_pseudo_msa: int = 15,
                 mask_rate: float = 0.12, num_cycle: int = 10,
                 deterministic: bool = True, pad_multiple: int = 0
                 ) -> Iterator[tuple[str, list[dict]]]:
    """Yield (chain_id, cycle_inputs) per sequence, shortest first;
    ``pad_multiple`` > 0 pads each sequence to the next multiple."""
    for ch, seq in parse_fasta(fasta_lines):
        aatype = tokenize(seq)
        cycles = make_pseudo_msa(aatype, num_pseudo_msa=num_pseudo_msa,
                                 mask_rate=mask_rate, num_cycle=num_cycle,
                                 deterministic=deterministic)
        if pad_multiple:
            bucket = -(-len(aatype) // pad_multiple) * pad_multiple
            cycles = pad_cycle_inputs(cycles, bucket)
        yield ch, cycles
