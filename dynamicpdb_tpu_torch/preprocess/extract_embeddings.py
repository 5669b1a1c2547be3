"""OmegaFold embedding extraction on the card.

Port of ``dynamicpdb_tpu/preprocess/extract_embeddings.py``: per sequence,
build the deterministic pseudo-MSA cycles, run the recycling loop, and save
the most confident cycle's node_repr [N, 256], edge_repr [N, N, 128] and
confidence as ``{name}.npz``, the files DFOLD reads.

    python -m dynamicpdb_tpu_torch.preprocess.extract_embeddings \
        --fasta seqs.fasta --out-dir embeds/ --weights release.pt \
        [--num-cycles 10] [--num-pseudo-msa 15] [--dtype float32|bfloat16] \
        [--pad-multiple 32] [--device cuda]

``--weights`` is a ``torch.save``d reference-layout OmegaFold state dict
(or a ``{'model': state_dict}`` wrapper, 'module.' prefixes allowed); its
dimensions come from the tensors' shapes. ``--flash`` and ``--no-scan`` are
accepted for the JAX CLI's command lines and select nothing: the fused
attention kernels always run on the card, and the best cycle is always
selected on the device.

The JAX module's ``resolve_dtype_flash`` picks the Pallas kernel by
backend; here the fused CUDA kernels always run on the card.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from dynamicpdb_tpu_torch.models.omegafold.model import (
    OmegaFold,
    omegafold_embed,
    omegafold_from_state_dict,
)
from dynamicpdb_tpu_torch.models.omegafold.pipeline import fasta2inputs
from dynamicpdb_tpu_torch.utils.platform import resolve_device

log = logging.getLogger(__name__)


def load_release_weights(weights_path: str, device="cuda",
                         dtype=None) -> OmegaFold:
    """The model of a checkpoint file: a raw state dict or a
    {'model': state_dict} wrapper, read with ``weights_only=True``."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and not any(
            k.startswith(("omega_plm", "module.omega_plm")) for k in sd):
        sd = sd["model"]
    return omegafold_from_state_dict(sd, device=device, dtype=dtype)


def extract_embeddings(fasta_lines, model: OmegaFold, *, num_cycles: int = 10,
                       num_pseudo_msa: int = 15, pad_multiple: int = 0):
    """Yield (name, {node_repr, edge_repr, confidence}, stats) per sequence,
    shortest first. ``pad_multiple`` pads each sequence to the next multiple
    (masked so padding cannot perturb real positions) and slices the
    outputs back to its length. ``stats``: n_res, padded length, seconds
    (host clock, the reprs on the host), the selected cycle and every
    cycle's confidence."""
    for name, cycles in fasta2inputs(fasta_lines,
                                     num_pseudo_msa=num_pseudo_msa,
                                     num_cycle=num_cycles,
                                     pad_multiple=pad_multiple):
        t0 = time.perf_counter()
        emb = omegafold_embed(model, cycles, pad_safe=bool(pad_multiple))
        n = cycles[0].get("num_res", emb.node.shape[0])
        arrays = {
            "node_repr": emb.node[:n].cpu().numpy(),
            "edge_repr": emb.edge[:n, :n].cpu().numpy(),
            "confidence": np.float32(emb.confidence),
        }
        stats = dict(name=name, n_res=n, padded=cycles[0]["p_msa"].shape[-1],
                     seconds=time.perf_counter() - t0, cycle=emb.cycle,
                     confidences=emb.confidences)
        log.info("%s: %d res (padded to %d), %d cycles, cycle %d selected, "
                 "confidence %.4f (%.2f s)", name, n, stats["padded"],
                 num_cycles, emb.cycle, emb.confidence, stats["seconds"])
        yield name, arrays, stats


def add_omegafold_cli_args(parser):
    parser.add_argument("--fasta", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--weights", required=True,
                        help="reference-layout OmegaFold state dict "
                             "(torch.save file)")
    parser.add_argument("--num-cycles", type=int, default=10)
    parser.add_argument("--num-pseudo-msa", type=int, default=15)
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="bfloat16: parameters and activations in "
                             "bfloat16, norm statistics in float32")
    parser.add_argument("--flash", choices=["auto", "on", "off"],
                        default="auto",
                        help="accepted for the JAX CLI's command lines; the "
                             "fused kernels always run on the card")
    parser.add_argument("--pad-multiple", type=int, default=0,
                        help="pad each sequence to the next multiple (e.g. "
                             "32), masked; 0 = exact shapes")
    parser.add_argument("--no-scan", action="store_true",
                        help="accepted for the JAX CLI's command lines; the "
                             "best cycle is always selected on the device")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")


def main(argv=None) -> list[dict]:
    """Write one npz per sequence of --fasta; returns each sequence's
    stats (see ``extract_embeddings``)."""
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
    for name, arrays, stats in extract_embeddings(
            lines, model, num_cycles=args.num_cycles,
            num_pseudo_msa=args.num_pseudo_msa,
            pad_multiple=args.pad_multiple):
        out = os.path.join(args.out_dir, f"{name}.npz")
        np.savez_compressed(out, **arrays)
        log.info("wrote %s", out)
        records.append(dict(stats, path=out))
    return records


if __name__ == "__main__":
    main()
