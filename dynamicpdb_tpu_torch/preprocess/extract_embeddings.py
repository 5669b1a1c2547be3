"""Embedding extraction on the card: OmegaFold, or AlphaFold2 from an MSA.

Port of ``dynamicpdb_tpu/preprocess/extract_embeddings.py``: per sequence,
build the deterministic pseudo-MSA cycles, run the recycling loop, and save
the most confident cycle's node_repr [N, 256], edge_repr [N, N, 128] and
confidence as ``{name}.npz``, the files DFOLD reads.

    python -m dynamicpdb_tpu_torch.preprocess.extract_embeddings \
        --fasta seqs.fasta --out-dir embeds/ --weights release.pt \
        [--num-cycles 10] [--num-pseudo-msa 15] [--dtype float32|bfloat16] \
        [--pad-multiple 32] [--device cuda] [--profile-dir DIR]

``--model alphafold2`` runs AlphaFold2 ``model_5``
(``models/alphafold``) on each alignment of ``--a3m`` (an a3m file, or a
directory of ``*.a3m`` files, each named by its stem) instead, and writes
the same keys from its last recycle, node_repr [N, 256] (the MSA's first
row), edge_repr [N, N, 128] (the pair representation) and confidence (the
mean pLDDT, in [0, 1]), plus single_repr [N, 384]:

    python -m dynamicpdb_tpu_torch.preprocess.extract_embeddings \
        --model alphafold2 --a3m msas/ --out-dir embeds/ --weights af2.pt \
        [--device cuda] [--profile-dir DIR]

where ``--weights`` is a ``torch.save``d reference-layout AlphaFold2 state
dict (``models/alphafold/model.alphafold_shapes``); the data settings are
``model_5``'s (3 recycles after the first pass, 512 clusters, 1,024 extra
rows).

``--weights`` is a ``torch.save``d reference-layout OmegaFold state dict
(or a ``{'model': state_dict}`` wrapper, 'module.' prefixes allowed); its
dimensions come from the tensors' shapes. ``--flash`` and ``--no-scan`` are
accepted for the JAX CLI's command lines and select nothing: the fused
attention kernels always run on the card, and the best cycle is always
selected on the device. ``--profile-dir DIR`` profiles the run (the
program's spans, the CUDA runtime calls and the device's work, no
operator: ``utils.logging.profile_trace``) and writes ``DIR/trace.json``,
a Chrome trace (chrome://tracing, Perfetto).

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

from dynamicpdb_tpu_torch.models.alphafold import features as af2_features
from dynamicpdb_tpu_torch.models.alphafold.model import (
    AlphaFold,
    alphafold_embed,
    alphafold_from_state_dict,
    sequence_inputs,
)
from dynamicpdb_tpu_torch.models.omegafold.model import (
    OmegaFold,
    omegafold_embed,
    omegafold_from_state_dict,
)
from dynamicpdb_tpu_torch.models.omegafold.pipeline import (
    fasta2inputs,
    parse_fasta,
)
from dynamicpdb_tpu_torch.utils.logging import profile_trace, span
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
    cycle's confidence.

    Spans (``utils.logging.span``): building a sequence's cycles runs under
    ``extract.pipeline``, the reprs' copies to the host under
    ``extract.fetch``."""
    fasta_lines = list(fasta_lines)
    inputs = fasta2inputs(fasta_lines, num_pseudo_msa=num_pseudo_msa,
                          num_cycle=num_cycles, pad_multiple=pad_multiple)
    # one next() a record, so the span holds a sequence's cycles and never
    # the call that finds the generator's end
    for _ in parse_fasta(fasta_lines):
        with span("extract.pipeline"):
            name, cycles = next(inputs)
        t0 = time.perf_counter()
        emb = omegafold_embed(model, cycles, pad_safe=bool(pad_multiple))
        n = cycles[0].get("num_res", emb.node.shape[0])
        with span("extract.fetch"):
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


def extract_alphafold_embeddings(records, model: AlphaFold):
    """Yield (name, {node_repr, edge_repr, single_repr, confidence},
    stats) per record of ``records``, (name, a3m lines) pairs, in their
    order. ``stats``: n_res, alignment depth, seconds (host clock, the
    reprs on the host), the mean pLDDT and the per-residue ``plddt``.

    Spans (``utils.logging.span``): parsing the alignment and making every
    recycle's features on the model's device (``alphafold.features``) run
    under ``extract.pipeline``, the reprs' copies to the host under
    ``extract.fetch``."""
    dev = model.single.w.device
    for name, lines in records:
        t0 = time.perf_counter()
        with span("extract.pipeline"):
            msa = af2_features.parse_a3m(lines, name=name)
            with span("alphafold.features"):
                inputs = sequence_inputs(model, msa, dev)
        emb = alphafold_embed(model, inputs)
        with span("extract.fetch"):
            arrays = {
                "node_repr": emb.node.cpu().numpy(),
                "edge_repr": emb.edge.cpu().numpy(),
                "single_repr": emb.single.cpu().numpy(),
                "confidence": np.float32(emb.confidence),
            }
            plddt = emb.plddt.cpu().numpy()
        n = arrays["node_repr"].shape[0]
        stats = dict(name=name, n_res=n, depth=msa.tokens.shape[0],
                     seconds=time.perf_counter() - t0,
                     confidence=emb.confidence, plddt=plddt)
        log.info("%s: %d res, %d rows, %d recycles, mean pLDDT %.4f "
                 "(%.2f s)", name, n, stats["depth"],
                 model.cfg.num_recycle + 1, emb.confidence, stats["seconds"])
        yield name, arrays, stats


def a3m_records(path: str) -> list[tuple[str, list[str]]]:
    """(name, lines) of an a3m file (named by its stem) or of every
    ``*.a3m`` file of a directory, sorted by name."""
    paths = ([os.path.join(path, f) for f in sorted(os.listdir(path))
              if f.endswith(".a3m")] if os.path.isdir(path) else [path])
    if not paths:
        raise FileNotFoundError(f"no .a3m file in {path}")
    records = []
    for p in paths:
        with open(p) as f:
            records.append((os.path.splitext(os.path.basename(p))[0],
                            f.readlines()))
    return records


def alphafold_main(argv) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=["alphafold2"], required=True)
    parser.add_argument("--a3m", required=True,
                        help="an a3m file or a directory of *.a3m files")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--weights", required=True,
                        help="reference-layout AlphaFold2 state dict "
                             "(torch.save file)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--profile-dir", default=None,
                        help="profile the run and write DIR/trace.json")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    sd = torch.load(args.weights, map_location="cpu", weights_only=True)
    model = alphafold_from_state_dict(sd, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    records = []
    with profile_trace(args.profile_dir):
        for name, arrays, stats in extract_alphafold_embeddings(
                a3m_records(args.a3m), model):
            out = os.path.join(args.out_dir, f"{name}.npz")
            np.savez_compressed(out, **arrays)
            log.info("wrote %s", out)
            records.append(dict(stats, path=out))
    return records


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
    """Write one npz per sequence of --fasta (per alignment of --a3m with
    ``--model alphafold2``); returns each sequence's stats (see
    ``extract_embeddings``, ``extract_alphafold_embeddings``)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", default="omegafold")
    known, _ = pre.parse_known_args(argv)
    if known.model == "alphafold2":
        return alphafold_main(argv)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=["omegafold"], default="omegafold",
                        help="omegafold (default) or alphafold2 (then "
                             "--a3m; see the module's docstring)")
    add_omegafold_cli_args(parser)
    parser.add_argument("--profile-dir", default=None,
                        help="profile the run and write DIR/trace.json")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    model = load_release_weights(args.weights, device=device, dtype=dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.fasta) as f:
        lines = f.readlines()
    records = []
    with profile_trace(args.profile_dir):
        for name, arrays, stats in extract_embeddings(
                lines, model, num_cycles=args.num_cycles,
                num_pseudo_msa=args.num_pseudo_msa,
                pad_multiple=args.pad_multiple):
            out = os.path.join(args.out_dir, f"{name}.npz")
            np.savez_compressed(out, **arrays)
            log.info("wrote %s", out)
            records.append(dict(stats, path=out))
    if args.profile_dir:
        log.info("wrote %s", os.path.join(args.profile_dir, "trace.json"))
    return records


if __name__ == "__main__":
    main()
