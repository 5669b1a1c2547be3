"""The reference's run of the timed extraction path, in plain PyTorch,
float32 with TF32 off, one sequence at a time.

It takes only what the benchmark made (the seed's weights and the raw
sequences) and recomputes everything the program derived from them.
"""
from __future__ import annotations

import torch

from h100bench import harness, weights as bench_weights
from h100bench.reference.models.omegafold.model import (
    OmegaFold,
    omegafold_embed,
)
from h100bench.reference.models.omegafold.pipeline import fasta2inputs


def float32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def omegafold_shapes(cfg=None) -> dict:
    """The reference-layout state dict's shapes (the release model by
    default)."""
    with torch.device("meta"):
        model = OmegaFold() if cfg is None else OmegaFold(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def omegafold_model(seed: int, device, cfg=None) -> OmegaFold:
    """OmegaFold (the release model by default) with the seed's weights,
    float32."""
    weights = bench_weights.omegafold_weights(omegafold_shapes(cfg), seed,
                                              device)
    with torch.device("meta"):
        model = OmegaFold() if cfg is None else OmegaFold(cfg)
    model.load_state_dict(weights, strict=True, assign=True)
    float32_exact()
    return model.eval()


def omegafold_sequence(model: OmegaFold, name: str, seq: str, *,
                       num_cycles: int, num_pseudo_msa: int) -> dict:
    """``extract_embeddings`` of one sequence in the reference: the
    pseudo-MSA cycles, the recycling loop and the confidence-based choice
    of a cycle. Returns every cycle's node_repr and edge_repr (numpy) and
    confidence, and the chosen cycle."""
    (_, cycles), = fasta2inputs([f">{name}\n", seq + "\n"],
                                num_pseudo_msa=num_pseudo_msa,
                                num_cycle=num_cycles)
    nodes, edges, confs = [], [], []

    def keep(i, node, edge, conf):
        nodes.append(node.float().cpu().numpy())
        edges.append(edge.float().cpu().numpy())
        confs.append(float(conf))

    emb = omegafold_embed(model, cycles, on_cycle=keep)
    return {"node_repr": nodes, "edge_repr": edges, "confidences": confs,
            "cycle": emb.cycle}


def cycle_choice_gap(confidences, cycle: int) -> float:
    """How far the reference's confidence of ``cycle`` lies below its best
    cycle's, as a share of the range of its confidences over the cycles:
    0 for the best cycle, 1 for the least confident one."""
    best, worst = max(confidences), min(confidences)
    if best == worst:
        return 0.0
    return (best - confidences[cycle]) / (best - worst)


# wrong choices of a cycle, each read by ``cycle_choice_gap`` from the
# reference's own confidences: no choice (the last cycle's reprs, as with
# ``predict_with_confidence`` off), the first cycle's, and argmin for argmax
WRONG_CHOICES = {
    "last": lambda c: len(c) - 1,
    "first": lambda c: 0,
    "least": lambda c: min(range(len(c)), key=c.__getitem__),
}


def omegafold_gaps(node, edge, confidences, cycle: int, want: dict) -> dict:
    """The extraction's numbers. ``repr_gap``: the reprs a run kept against
    the reference's reprs of the same cycle, the norm of the difference
    over the reference's norm (the widest gap over the largest magnitude,
    a diagnostic, swings with the odd pair whose recycled distance falls
    in the other bin). ``cycle_choice_gap``: whether that cycle is the one
    the reference finds most confident, up to a near tie. Every cycle's
    confidence against the reference's (``confidence_gap``) is a
    diagnostic."""
    ref_node, ref_edge = want["node_repr"][cycle], want["edge_repr"][cycle]
    return {
        "repr_gap": max(harness.norm_rel_gap(node, ref_node),
                        harness.norm_rel_gap(edge, ref_edge)),
        "cycle_choice_gap": cycle_choice_gap(want["confidences"], cycle),
        "repr_widest_gap": max(harness.max_rel_gap(node, ref_node),
                               harness.max_rel_gap(edge, ref_edge)),
        "confidence_gap": harness.max_rel_gap(confidences,
                                              want["confidences"]),
    }


def wrong_choice_gaps(want: dict) -> dict:
    """``cycle_choice_gap`` of each of ``WRONG_CHOICES`` on the reference's
    confidences: the readings a run that chose so would give."""
    c = want["confidences"]
    return {k: cycle_choice_gap(c, pick(c)) for k, pick in
            WRONG_CHOICES.items()}
