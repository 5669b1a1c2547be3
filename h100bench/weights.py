"""Seeded random weights, made on the device in one draw.

Both sides of a comparison call the same function with the same seed: the
program loads the result into its model, and the reference makes its own
copy anew, so it takes nothing the program has held. One standard normal
draw of every parameter's numbers from a ``torch.Generator`` on the card,
then one scale (and shift) a leaf, in the order of the sorted names.
"""
from __future__ import annotations

import math

import torch

# OmegaFold's parameter names -> the input dims each contracts over (the
# layout of the reference state dict; ``random_omegafold_state_dict``'s
# rule), and its norms, which start near 1
OMEGAFOLD_FAN_IN = {
    "qg_weights": (0,), "kv_weights": (0,), "linear_b_weights": (0,),
    "act_w": (0,), "o_weights": (1, 2), "out_weights": (0, 1),
    "out_proj_w": (1,),
}
OMEGAFOLD_NORMS = ("output_norm", "layernorm_node", "layernorm_edge",
                   "node_norm", "edge_norm", "input_norm", "update_norm",
                   "multi_headed_scaling")


ALIGN = 64  # numbers: each leaf starts 256 bytes into the draw, as the
# allocator aligns a tensor (the kernels take 16-byte aligned operands)


def _draw(shapes: dict, seed: int, device, rule) -> dict:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    slots = [-(-n // ALIGN) * ALIGN for n in sizes]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(slots), generator=g, device=device)
    out = {}
    for name, size, part in zip(names, sizes, flat.split(slots)):
        mean, std = rule(name, shapes[name])
        t = part[:size].view(shapes[name]).mul_(std)
        out[name] = t.add_(mean) if mean else t
    return out


def omegafold_rule(name: str, shape) -> tuple[float, float]:
    """``random_omegafold_state_dict``'s distributions: norms 1 + N(0,
    0.1^2), weights N(0, 1/fan_in), vectors N(0, 0.1^2)."""
    owner, leaf = name.split(".")[-2:]
    if owner in OMEGAFOLD_NORMS:
        return (1.0 if leaf == "weight" else 0.0), 0.1
    if leaf in OMEGAFOLD_FAN_IN:
        return 0.0, 1.0 / math.sqrt(math.prod(
            shape[i] for i in OMEGAFOLD_FAN_IN[leaf]))
    if leaf == "weight" and len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 0.1


def omegafold_weights(shapes: dict, seed: int, device) -> dict:
    return _draw(shapes, seed, device, omegafold_rule)
