"""Parameters carried across from the JAX package, and seeded random ones.

``state_dict_from_jax`` keeps the port's own copy of the mapping of
``dynamicpdb_tpu/train/export_torch.py:77 reference_state_dict_from_flax``
(the reference torch layout, with xyz-major point projections), minus the
dead ``embedding_layer.*`` entries, so the result loads into
``DFoldScoreNetwork`` with ``strict=True``. With
``embed.use_aatype_embedding`` on it also carries JAX's
``aatype_embed/embedding`` [21, D] to the port-only key
``score_model.aatype_embed.weight``; with the option off that entry is
refused like any other the layout cannot hold.
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
    if model_cfg.embed.use_aatype_embedding:
        sd["score_model.aatype_embed.weight"] = take("aatype_embed/embedding")

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
# "embed" = flax's default embed init, variance-scaling fan-in normal (not
# truncated) of variance 1 / D: the aatype embedding [21, D].
_JAX_INIT_RULES = (  # the first key contained in the name decides
    ("aatype_embed.", "embed"),
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
        elif rule == "embed":
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
        else:
            std = math.sqrt((2.0 if rule == "relu" else 1.0) / fan_in) \
                / _TRUNC_CORR
            x = torch.empty(p.shape)
            torch.nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0, generator=g)
            p.copy_(x * std)
    return model


# ---------------------------------------------------------------------------
# OmegaFold (embedding extraction)
# ---------------------------------------------------------------------------
_OMEGAFOLD_NORMS = ("output_norm", "layernorm_node", "layernorm_edge",
                    "node_norm", "edge_norm", "input_norm", "update_norm",
                    "multi_headed_scaling")
# parameter name -> the input dims it contracts over (leading dims of its
# reference layout); nn.Linear and nn.Embedding weights contract dim 1
_OMEGAFOLD_FAN_IN = {
    "qg_weights": (0,), "kv_weights": (0,), "linear_b_weights": (0,),
    "act_w": (0,), "o_weights": (1, 2), "out_weights": (0, 1),
    "out_proj_w": (1,),
}


def omegafold_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Every key of the reference OmegaFold state dict at ``cfg`` and its
    shape (from the port's module built on the meta device)."""
    from dynamicpdb_tpu_torch.models.omegafold.model import OmegaFold

    with torch.device("meta"):
        model = OmegaFold(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def random_omegafold_state_dict(cfg, seed: int) -> dict[str, np.ndarray]:
    """A reference-layout OmegaFold state dict of float32 numpy arrays drawn
    from ``np.random.default_rng(seed)``: LayerNorm and scale-shift weights
    ~ 1 + N(0, 0.1^2), weights ~ N(0, 1/fan_in), vectors ~ N(0, 0.1^2), so
    activations stay near unit scale through every layer."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in omegafold_shapes(cfg).items():
        owner, name = key.split(".")[-2:]
        mean, std = 0.0, 0.1
        if owner in _OMEGAFOLD_NORMS:
            mean = 1.0 if name == "weight" else 0.0
        elif name in _OMEGAFOLD_FAN_IN:
            std = 1.0 / math.sqrt(math.prod(shape[i]
                                            for i in _OMEGAFOLD_FAN_IN[name]))
        elif name == "weight" and len(shape) == 2:
            std = 1.0 / math.sqrt(shape[1])
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        sd[key] = x + np.float32(mean) if mean else x
    return sd


def omegafold_state_dict_from_jax(params, cfg) -> dict[str, np.ndarray]:
    """The JAX package's ``OmegaFoldParams`` (its NamedTuple tree, leaves as
    numpy arrays) as the reference-layout state dict: the [num_layers] and
    [num_blocks] axes unstacked and the converters' transposes undone.
    Raises unless the keys are exactly those of ``OmegaFold(cfg)``."""
    sd: dict[str, np.ndarray] = {}

    def put(key, x):
        sd[key] = np.ascontiguousarray(np.asarray(x, np.float32))

    def lin(key, p, i=None):  # LinearParams (w [in, out], b), or stacked
        w, b = (p[0], p[1]) if i is None else (p[0][i], p[1][i])
        put(key + ".weight", np.asarray(w).T)
        put(key + ".bias", b)

    def ln(key, p, i=None):
        put(key + ".weight", p[0] if i is None else p[0][i])
        put(key + ".bias", p[1] if i is None else p[1][i])

    def attn(key, a, i):
        for f in ("qg_weights", "qg_bias", "kv_weights", "kv_bias",
                  "o_weights", "o_bias"):
            put(f"{key}.{f}", getattr(a, f)[i])

    plm = params.plm
    put("omega_plm.input_embedding.weight", plm.embedding)
    for i in range(plm.layers.gva_w.shape[0]):
        k, lp = f"omega_plm.layers.{i}.gau.", plm.layers
        lin(k + "gva_proj.0", (lp.gva_w, lp.gva_b), i)
        ln(k + "multi_headed_scaling", (lp.mhs_weight, lp.mhs_bias), i)
        put(k + "relpos.weight", lp.relpos_table[i])
        lin(k + "output_proj", (lp.out_w, lp.out_b), i)
    ln("omega_plm.output_norm", (plm.out_ln_weight, plm.out_ln_bias))
    lin("plm_node_embedder", params.plm_node_embedder)
    lin("plm_edge_embedder", params.plm_edge_embedder)
    e = params.input_embedder
    put("input_embedder.proj_i.weight", e.proj_i)
    put("input_embedder.proj_j.weight", e.proj_j)
    put("input_embedder.relpos.weight", e.relpos_table)
    r = params.recycle
    ln("recycle_embedder.layernorm_node", r.ln_node)
    ln("recycle_embedder.layernorm_edge", r.ln_edge)
    put("recycle_embedder.prev_pos_embed.weight", r.prev_pos_embed)

    geo = params.geoformer
    bl = geo.blocks
    for i in range(bl.node_transition.w1.shape[0]):
        k = f"omega_fold_cycle.geoformer.blocks.{i}."
        lin(k + "attention_w_edge_bias.proj_edge_bias",
            (bl.attn_edge_bias.proj_edge_w, bl.attn_edge_bias.proj_edge_b), i)
        attn(k + "attention_w_edge_bias.attention", bl.attn_edge_bias.attn, i)
        attn(k + "column_attention", bl.column_attn, i)
        for name in ("node_transition", "edge_transition"):
            t = getattr(bl, name)
            lin(k + name + ".network.0", (t.w1, t.b1), i)
            lin(k + name + ".network.2", (t.w2, t.b2), i)
        op = bl.out_product
        lin(k + "out_product.input_proj", (op.in_w, op.in_b), i)
        put(k + "out_product.out_weights", op.out_weights[i])
        put(k + "out_product.out_bias", op.out_bias[i])
        for j, g in enumerate(bl.geom):
            gk = k + f"geometric_attention.{j}."
            for f, jf in (("linear_b_weights", "linear_b_w"),
                          ("linear_b_bias", "linear_b_b"), ("act_w", "act_w"),
                          ("act_b", "act_b"), ("out_proj_w", "out_proj_w"),
                          ("out_proj_b", "out_proj_b")):
                put(gk + f, getattr(g, jf)[i])
            attn(gk + "attention", g.attn, i)
    lin("omega_fold_cycle.geoformer.node_final_proj",
        (geo.final_proj_w, geo.final_proj_b))

    s = params.structure
    k = "omega_fold_cycle.structure_module."
    ln(k + "node_norm", s.node_norm)
    ln(k + "edge_norm", s.edge_norm)
    lin(k + "init_proj", s.init_proj)
    for c, cp in enumerate(s.cycles):
        ck = f"{k}cycles.{c}."
        for f in ("q_scalar", "k_scalar", "v_scalar", "q_point", "k_point",
                  "v_point", "bias_2d"):
            lin(ck + "ipa." + f, getattr(cp.ipa, f))
        lin(ck + "ipa.output_projection", cp.ipa.out)
        put(ck + "ipa.trainable_point_weights", cp.ipa.point_weights)
        ln(ck + "input_norm", cp.input_norm)
        for t, lp in enumerate(cp.transition):
            lin(f"{ck}transition.{t}", lp)
        ln(ck + "update_norm", cp.update_norm)
        lin(ck + "affine_update", cp.affine_update)
    th = s.torsion
    for name, group in (("input_projection", th.input_projection),
                        ("resblock1", th.resblock1),
                        ("resblock2", th.resblock2)):
        for t, lp in enumerate(group):
            lin(f"{k}torsion_angle_pred.{name}.{t}", lp)
    lin(k + "torsion_angle_pred.unnormalized_angles", th.unnormalized)
    for t, lp in zip((0, 2, 4), params.confidence.layers):
        lin(f"omega_fold_cycle.confidence_head.network.{t}", lp)

    want = omegafold_shapes(cfg)
    got = {key: v.shape for key, v in sd.items()}
    if got != want:
        bad = sorted(set(got) ^ set(want)) or sorted(
            key for key in got if got[key] != want[key])
        raise ValueError(f"the JAX params do not make OmegaFold({cfg}): "
                         f"{bad[:5]}")
    return sd
