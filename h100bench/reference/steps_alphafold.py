"""The reference's run of the AlphaFold2 cell's timed extraction path, in
plain PyTorch, float32 with TF32 off, one alignment at a time.

It takes only what the benchmark made (the seed's weights and the raw a3m
lines) and recomputes everything the program derived from them, features
included. Each recycle is held to the reference's pass from the same
recycled inputs (``recycles_on``): a recycle feeds the next one the
one-hot distogram of its pseudo-beta distances, and a distance within
rounding of a bin edge falls in the other bin in two float32 runs, so
end to end the pair representations of two sound float32 runs part by
~1e-3 after four recycles (several hundred pairs in another bin), as far
as a TF32 run's do; one recycle on the same inputs parts by rounding.
The bins are what the next recycle reads: every recycle's pseudo-beta
positions themselves, continuous, are held to the reference's, and so is
the last recycle's pLDDT (the npz's ``confidence`` is its mean).
"""
from __future__ import annotations

import math

import torch

from h100bench import harness, weights as bench_weights
from h100bench.reference.models.alphafold import model as ref

float32_exact = ref.float32_exact


def alphafold_shapes(cfg=None) -> dict:
    """The reference-layout state dict's shapes (``model_5`` by default)."""
    with torch.device("meta"):
        model = ref.AlphaFold(cfg or ref.Config())
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def alphafold_rule(name: str, shape) -> tuple[float, float]:
    """``random_alphafold_state_dict``'s distributions: LayerNorms 1 + N(0,
    0.1^2) (weights) and N(0, 0.1^2) (biases), linear weights N(0,
    1/fan_in), every other vector N(0, 0.1^2)."""
    owner, leaf = name.split(".")[-2:]
    if "norm" in owner:
        return (1.0 if leaf == "weight" else 0.0), 0.1
    if leaf == "weight" and len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 0.1


def alphafold_weights(seed: int, device, cfg=None) -> dict:
    """The seed's weights, drawn on ``device`` in one call."""
    return bench_weights._draw(alphafold_shapes(cfg), seed, device,
                               alphafold_rule)


def alphafold_model(seed: int, device, cfg=None) -> ref.AlphaFold:
    """The reference (``model_5`` by default) with the seed's weights."""
    model = ref.alphafold_model(alphafold_weights(seed, device, cfg),
                                cfg or ref.Config(), device)
    float32_exact()
    return model


def alphafold_sequence(model: ref.AlphaFold, name: str, a3m_lines,
                       on_recycle=None) -> dict:
    """``extract_alphafold_embeddings`` of one alignment in the reference,
    every recycle from the reference's own last."""
    return ref.extract(model, a3m_lines, name=name, on_recycle=on_recycle)


RECYCLED = ("msa_first_row", "pair", "pseudo_beta")
COMPARED = ("msa_first_row", "pair", "single")


def host_outputs(outputs: dict) -> dict:
    """A recycle's outputs as float32 CPU tensors."""
    return {k: v.float().cpu() for k, v in outputs.items()}


@torch.no_grad()
def recycles_on(model: ref.AlphaFold, name: str, a3m_lines,
                outputs: list[dict]) -> list[dict]:
    """The reference's pass of each recycle r from the recycled outputs
    (``RECYCLED``) of recycle r - 1 in ``outputs`` (zeros before the
    first): every recycle of another run, each on that run's own inputs.
    The features are the reference's own, drawn from ``name``."""
    cfg = model.cfg
    dev = model.evoformer.linear_single.weight.device
    _, tokens, deletions = ref.parse_a3m(a3m_lines)
    L = tokens.shape[1]
    aatype = torch.as_tensor(tokens[0], device=dev)
    prev = {"msa_first_row": torch.zeros(L, cfg.msa_dim, device=dev),
            "pair": torch.zeros(L, L, cfg.pair_dim, device=dev),
            "pseudo_beta": torch.zeros(L, 3, device=dev)}
    want = []
    for r in range(len(outputs)):
        msa_feat, extra_feat = ref.recycle_features(name, tokens, deletions,
                                                    r, cfg, dev)
        want.append(host_outputs(model.recycle(aatype, msa_feat, extra_feat,
                                               prev)))
        prev = {k: outputs[r][k].to(dev) for k in RECYCLED}
    return want


def recycle_gaps(outputs: list[dict], want: list[dict]) -> dict:
    """Each recycle held to the reference's pass from the same recycled
    inputs. ``repr_gap``: the largest, over the recycles and over the
    MSA's first row, the pair and the single representation, of the norm
    of the difference over the reference's norm; ``pseudo_beta_gap``: the
    same over the recycles' pseudo-beta positions (the structure module's
    frames); ``plddt_gap``: the widest per-residue gap of the last pLDDT,
    in [0, 1] units. ``recycle_gaps`` (each recycle's largest repr gap) is
    a diagnostic."""
    each = [max(harness.norm_rel_gap(o[k], w[k]) for k in COMPARED)
            for o, w in zip(outputs, want)]
    return {"repr_gap": max(each), "recycle_gaps": each,
            "pseudo_beta_gap": max(
                harness.norm_rel_gap(o["pseudo_beta"], w["pseudo_beta"])
                for o, w in zip(outputs, want)),
            "plddt_gap": float((outputs[-1]["plddt"]
                                - want[-1]["plddt"]).abs().max())}
