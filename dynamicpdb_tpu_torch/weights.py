"""Parameters carried across from the JAX package, and seeded random ones.

``state_dict_from_jax`` keeps the port's own copy of the mapping of
``dynamicpdb_tpu/train/export_torch.py:77 reference_state_dict_from_flax``
(the reference torch layout, with xyz-major point projections), minus the
dead ``embedding_layer.*`` entries, so the result loads into
``DFoldScoreNetwork`` with ``strict=True``.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch

from dynamicpdb_tpu_torch.config import ModelConfig


def point_perm(n_heads: int, n_pts: int) -> np.ndarray:
    """JAX point-projection column o = hp*3 + xyz -> reference row
    o' = xyz*(H*P) + hp."""
    hp = np.arange(n_heads * n_pts)
    perm = np.empty(3 * n_heads * n_pts, dtype=int)
    for xyz in range(3):
        perm[xyz * n_heads * n_pts + hp] = hp * 3 + xyz
    return perm


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v, np.float32)
    return flat


def state_dict_from_jax(params: Mapping, model_cfg: ModelConfig
                        ) -> dict[str, torch.Tensor]:
    """The JAX params tree (nested dicts of arrays, with or without the
    top-level "params" key) as the port's state dict. Raises on a
    parameter the reference layout cannot hold."""
    tree = params["params"] if "params" in params else params
    flat = _flatten(tree)
    used: set[str] = set()
    ipa = model_cfg.ipa
    H, PQ, PV = ipa.no_heads, ipa.no_qk_points, ipa.no_v_points
    sd: dict[str, np.ndarray] = {}

    def take(key: str) -> np.ndarray:
        used.add(key)
        if key not in flat:
            raise KeyError(f"param '{key}' not in the JAX params tree: the "
                           f"model config (num_blocks={ipa.num_blocks}, "
                           f"c_s={ipa.c_s}, c_z={ipa.c_z}) does not match it")
        return flat[key]

    def lin(mine: str, ref: str):
        sd[f"{ref}.weight"] = take(f"{mine}/kernel").T
        if f"{mine}/bias" in flat:
            sd[f"{ref}.bias"] = take(f"{mine}/bias")

    def mlp(mine: str, ref: str):
        lin(f"{mine}/Dense_0", f"{ref}.0")
        lin(f"{mine}/Dense_1", f"{ref}.2")

    def points(mine: str, ref: str, n_pts: int):
        perm = point_perm(H, n_pts)
        sd[f"{ref}.weight"] = take(f"{mine}/kernel").T[perm]
        sd[f"{ref}.bias"] = take(f"{mine}/bias")[perm]

    lin("expand_node", "expand_node")
    lin("expand_edge", "expand_edge")
    for name in ("force_embeder", "vel_embeder", "index_embeder",
                 "rigid_embeder", "angle_embeder"):
        mlp(name, f"score_model.{name}")
    for b in range(ipa.num_blocks):
        mine, ref = f"ipa_{b}", f"score_model.trunk.ipa_{b}"
        lin(f"{mine}/linear_q", f"{ref}.linear_q")
        lin(f"{mine}/linear_kv", f"{ref}.linear_kv")
        points(f"{mine}/linear_q_points", f"{ref}.linear_q_points", PQ)
        points(f"{mine}/linear_kv_points", f"{ref}.linear_kv_points", PQ + PV)
        lin(f"{mine}/linear_b", f"{ref}.linear_b")
        lin(f"{mine}/down_z", f"{ref}.down_z")
        lin(f"{mine}/linear_out", f"{ref}.linear_out")
        sd[f"{ref}.head_weights"] = take(f"{mine}/head_weights")
        # dead in the reference IPA; zeros keep the layout
        sd[f"{ref}.linear_rbf.weight"] = np.zeros((1, 20), np.float32)
        sd[f"{ref}.linear_rbf.bias"] = np.zeros((1,), np.float32)
        lin(f"bb_update_{b}/Dense_0", f"score_model.trunk.bb_update_{b}.linear")
    for i in range(4):
        for j, conv_idx in ((0, 0), (1, 2)):
            k = take(f"conv_0/Conv_{2 * i + j}/kernel")  # [kh, kw, in, out]
            ref = f"score_model.trunk.conv_0.conv{i + 1}.{conv_idx}"
            sd[f"{ref}.weight"] = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
            sd[f"{ref}.bias"] = take(f"conv_0/Conv_{2 * i + j}/bias")
    lin("angle_resnet/Dense_0", "score_model.angle_resnet.linear_initial")
    lin("angle_resnet/Dense_1", "score_model.angle_resnet.linear_in")
    for i in range(2):
        lin(f"angle_resnet/AngleResnetBlock_{i}/Dense_0",
            f"score_model.angle_resnet.layers.{i}.linear_1")
        lin(f"angle_resnet/AngleResnetBlock_{i}/Dense_1",
            f"score_model.angle_resnet.layers.{i}.linear_2")
    lin("angle_resnet/Dense_2", "score_model.angle_resnet.linear_out")

    unmapped = sorted(set(flat) - used)
    if unmapped:
        raise ValueError("JAX params the reference layout cannot hold: "
                         + ", ".join(unmapped))
    return {k: torch.tensor(v) for k, v in sd.items()}


@torch.no_grad()
def randomize_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw EVERY parameter from a seeded CPU generator, whatever device the
    model is on: weights ~ N(0, 1/fan_in), vectors ~ N(0, 0.1^2). Unlike a
    fresh JAX init, nothing is zero, so every layer (the zero-initialised
    output layers included) reaches the output."""
    g = torch.Generator().manual_seed(seed)
    for _, p in sorted(model.named_parameters()):
        std = 1.0 / math.sqrt(p[0].numel()) if p.ndim >= 2 else 0.1
        p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


# The JAX package's init of each parameter (models/layers.py INITS), by the
# parameter's name in the reference layout: "torch" = U(+-1/sqrt(fan_in)),
# "default"/"relu" = fan-in truncated normal of variance 1 / 2 (AF2),
# "final" = zeros. Biases are zeros; head_weights start at softplus^-1(1).
_JAX_INIT_RULES = (  # the first key contained in the name decides
    ("angle_resnet.linear_initial.", "default"),
    ("angle_resnet.linear_in.", "default"),
    ("angle_resnet.linear_out.", "default"),
    (".linear_out.", "final"),  # the IPA out-projection
    ("bb_update_", "final"),
    (".linear_1.", "relu"),
    (".linear_2.", "final"),
    (".linear_rbf.", "final"),
    ("", "torch"),
)
_TRUNC_CORR = 0.87962566103423978  # 1 / std of the normal truncated at +-2


@torch.no_grad()
def init_like_jax_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw every parameter from a seeded CPU generator by the JAX
    package's init rule for it (the distributions, not JAX's numbers), as a
    fresh ``DFoldScoreNetwork.init`` would: zero-initialised output layers
    and backbone updates, so training starts from the same function."""
    g = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        if name.endswith("head_weights"):
            p.fill_(0.541324854612918)
            continue
        if p.ndim < 2:
            p.zero_()
            continue
        rule = next(r for key, r in _JAX_INIT_RULES if key in name)
        fan_in = p[0].numel()
        if rule == "final":
            p.zero_()
        elif rule == "torch":
            limit = 1.0 / math.sqrt(fan_in)
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * limit)
        else:
            std = math.sqrt((2.0 if rule == "relu" else 1.0) / fan_in) \
                / _TRUNC_CORR
            x = torch.empty(p.shape)
            torch.nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0, generator=g)
            p.copy_(x * std)
    return model
