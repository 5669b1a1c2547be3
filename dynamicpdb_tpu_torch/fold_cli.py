"""Structure prediction: FASTA -> PDB with per-residue pLDDT, on the card.

Port of ``dynamicpdb_tpu/fold_cli.py``. The recycling loop that extracts
DFOLD's embeddings also computes a fold in every cycle (structure module
and confidence head); this CLI keeps the most confident cycle's atoms and
pLDDT (``omegafold_embed(return_structure=True)``, selected on the device)
and writes them, the upstream OmegaFold product:

    python -m dynamicpdb_tpu_torch.fold_cli --fasta seqs.fasta \
        --weights release.pt --out-dir folds/ [--num-cycles 10] \
        [--num-pseudo-msa 15] [--dtype float32|bfloat16] \
        [--pad-multiple 32] [--device cuda]

One PDB per sequence (B-factor column = pLDDT x 100, the AlphaFold and
OmegaFold convention) and a JSON sidecar with ``confidence_overall`` and
``mean_plddt``. The flags are the extraction CLI's
(``preprocess/extract_embeddings.add_omegafold_cli_args``).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from dynamicpdb_tpu_torch.models.omegafold.model import (
    OmegaFold,
    omegafold_embed,
)
from dynamicpdb_tpu_torch.models.omegafold.pipeline import fasta2inputs
from dynamicpdb_tpu_torch.ops.frames import atom14_to_atom37

log = logging.getLogger(__name__)


def fold(fasta_lines, model: OmegaFold, *, num_cycles: int = 10,
         num_pseudo_msa: int = 15, pad_multiple: int = 0):
    """Yield (name, result) per sequence, shortest first. ``result``:
    atom37 [L, 37, 3], atom37_mask [L, 37], aatype [L], plddt [L], pos14
    [L, 14, 3] (numpy, float32), confidence_overall, and the selected
    cycle, every cycle's confidence, the padded length and the seconds
    (host clock, the results on the host). ``pad_multiple`` pads each
    sequence to the next multiple, masked; the results are sliced back to
    its length. A sequence with gap or unknown tokens is refused before
    the fold."""
    for name, cycles in fasta2inputs(fasta_lines,
                                     num_pseudo_msa=num_pseudo_msa,
                                     num_cycle=num_cycles,
                                     pad_multiple=pad_multiple):
        n = cycles[0].get("num_res", cycles[0]["p_msa"].shape[-1])
        fasta = np.asarray(cycles[0]["p_msa"][0][:n])  # primary sequence
        if (fasta > 20).any():
            # '-' tokenizes to 21: the atom tables and the PDB writer cover
            # residue types 0..20 only, and a gap has no structure
            raise ValueError(
                f"{name}: sequence contains gap/unknown tokens — remove "
                "'-' characters from the FASTA before folding")
        t0 = time.perf_counter()
        emb = omegafold_embed(model, cycles, pad_safe=bool(pad_multiple),
                              return_structure=True)
        pos14 = emb.pos14[:n]
        atom37, mask37 = atom14_to_atom37(
            pos14, torch.as_tensor(fasta, device=pos14.device).long())
        result = {
            "atom37": atom37.cpu().numpy(),
            "atom37_mask": mask37.cpu().numpy(),
            "aatype": fasta,
            "plddt": emb.plddt[:n].cpu().numpy(),
            "pos14": pos14.cpu().numpy(),
            "confidence_overall": emb.confidence,
            "cycle": emb.cycle,
            "confidences": emb.confidences,
            "padded": cycles[0]["p_msa"].shape[-1],
            "seconds": time.perf_counter() - t0,
        }
        yield name, result


def main(argv=None) -> list[dict]:
    """Fold every sequence of --fasta; returns per sequence its name,
    n_res, padded length, seconds, selected cycle, every cycle's
    confidence, confidence_overall, mean_plddt and the files written."""
    from dynamicpdb_tpu_torch.analysis.pdb_io import write_pdb
    from dynamicpdb_tpu_torch.preprocess.extract_embeddings import (
        add_omegafold_cli_args,
        load_release_weights,
    )
    from dynamicpdb_tpu_torch.utils.platform import resolve_device

    parser = argparse.ArgumentParser(description=__doc__)
    add_omegafold_cli_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    model = load_release_weights(args.weights, device=device, dtype=dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.fasta) as f:
        lines = f.readlines()
    records = []
    for name, result in fold(lines, model, num_cycles=args.num_cycles,
                             num_pseudo_msa=args.num_pseudo_msa,
                             pad_multiple=args.pad_multiple):
        pdb_path = os.path.join(args.out_dir, f"{name}.pdb")
        b = np.broadcast_to((result["plddt"] * 100.0)[:, None],
                            result["atom37_mask"].shape)
        write_pdb(pdb_path, result["atom37"], result["aatype"],
                  atom37_mask=result["atom37_mask"], b_factors=np.asarray(b))
        sidecar = {"confidence_overall": result["confidence_overall"],
                   "mean_plddt": float(result["plddt"].mean())}
        json_path = os.path.join(args.out_dir, f"{name}.json")
        with open(json_path, "w") as f:
            json.dump(sidecar, f)
        log.info("wrote %s (confidence %.3f, cycle %d, %.2f s)", pdb_path,
                 result["confidence_overall"], result["cycle"],
                 result["seconds"])
        records.append(dict(
            sidecar, name=name, n_res=len(result["aatype"]),
            padded=result["padded"], seconds=result["seconds"],
            cycle=result["cycle"], confidences=result["confidences"],
            pdb=pdb_path, json=json_path))
    return records


if __name__ == "__main__":
    main()
