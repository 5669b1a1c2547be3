"""AlphaFold2, monomer ``model_5``, for embedding extraction.

The model of Jumper et al., Nature 596:583 (2021), Supplementary
Information, Algorithms 2-32, at the widths of ``alphafold/model/config.py``
(``CONFIG`` with ``CONFIG_DIFFS['model_5']``: no templates): per recycle,
the input embedder with relative positions (Algorithms 3-4), the recycling
embedder (32), the extra-MSA stack (18-19) and the Evoformer (6-15), the
single projection, the structure module (20-24) and the pLDDT head. The
reprs of the last recycle are kept: the MSA's first row (``node_repr``
[L, 256]), the pair representation (``edge_repr`` [L, L, 128]), the
single representation the structure module reads (``single_repr`` [L,
384]) and the mean pLDDT (``confidence``, in [0, 1]).

The work runs on the shared GeoFormer kernels where their equations are
AlphaFold2's:

* MSA row attention with pair bias: ``fused_gated_node_attention`` over
  the clusters' rows (M rows of L keys, the pair bias shared by the rows);
* MSA column attention: the same wrapper on the MSA's transpose (L rows of
  M keys, a zero bias);
* triangle attention around the starting and the ending node:
  ``fused_gated_geom_attention_t`` with one axis, on z and on z^T;
* the outgoing and incoming triangle multiplications: the single-view
  triangle route (``ops.geom_triangle.geom_triangle_view``, views 0 and
  1), each update adding to the pair tensor as AlphaFold2 applies them,
  one after the other.

The extra-MSA stack's attentions have heads 8 wide, which the kernels
(``KERNEL_C`` 32) do not take: its row attention runs as the kernel's
plain version (``node_attention_plain``) over blocks of rows, its global
column attention in plain torch, on the card as on the CPU. The
transitions, the outer product mean and the projections are float32
matrix products.

Each LayerNorm's affine is folded into the weights that read it at load
time (``alphafold_from_state_dict``): x_hat (gamma W) + (beta W + b) for
(gamma x_hat + beta) W + b, which changes rounding only; the kernels and
the modules then normalise without an affine. The structure module is
OmegaFold's ``StructureCycle`` (``models/omegafold/structure.py``: the
IPA, the transition and the quaternion backbone update of Algorithms
20-23, at these same widths), applied 8 times with its weights shared, as
AlphaFold2's is; the pLDDT head is OmegaFold's ``ConfidenceHead`` with the
head's LayerNorm folded in. What extraction reads nothing of is not
computed: the side-chain torsions (the angle resnet), and the distogram,
masked-MSA and experimentally-resolved heads. The next recycle's
pseudo-beta positions need only the backbone frames: Cβ lies in the
backbone's rigid group (CA for glycine and X).

A single sequence has no padding, so every mask of AlphaFold2 is all ones
(``features``' docstring): none is applied beyond the kernels' all-ones
key masks. Dropout is off at inference.

Spans (``utils.logging.span``): ``alphafold.recycle`` around each recycle,
within it ``alphafold.embedders``, ``alphafold.extra_msa_stack``,
``alphafold.evoformer`` and ``alphafold.structure_module``; within each
block ``alphafold.msa_row_attention``, ``alphafold.msa_column_attention``
(the Evoformer's) or ``alphafold.msa_column_global_attention`` (the extra
stack's), ``alphafold.msa_transition``, ``alphafold.outer_product_mean``,
``alphafold.triangle_multiplication`` (each update),
``alphafold.triangle_attention`` (each node) and
``alphafold.pair_transition``.

``AlphaFold``'s weights come from a reference-layout state dict (the keys
of ``alphafold_shapes``, those of the plain reference in ``reference.py``,
with torch ``nn.Linear`` and ``nn.LayerNorm`` layouts).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from dynamicpdb_tpu_torch.models.alphafold import features as feats
from dynamicpdb_tpu_torch.models.omegafold import atoms
from dynamicpdb_tpu_torch.models.omegafold.core import LayerNorm, linear
from dynamicpdb_tpu_torch.models.omegafold.core import layer_norm_f32 as _normalize
from dynamicpdb_tpu_torch.models.omegafold.model import StructConfig
from dynamicpdb_tpu_torch.models.omegafold.structure import (
    ConfidenceHead,
    StructureCycle,
)
from dynamicpdb_tpu_torch.ops.geom_attention import (
    fused_gated_geom_attention_t,
    fused_gated_node_attention,
    node_attention_plain,
)
from dynamicpdb_tpu_torch.ops.geom_triangle import geom_triangle_view
from dynamicpdb_tpu_torch.utils.logging import span

MODEL_5_STRUCT = StructConfig(
    node_dim=384, edge_dim=128, num_cycle=8, num_transition=3, num_head=12,
    num_point_qk=4, num_point_v=8, num_scalar_qk=16, num_scalar_v=16,
    num_channel=128, num_residual_block=2, hidden_dim=128, num_bins=50)


@dataclass(frozen=True)
class AlphaFoldConfig:
    """``model_5`` by default. The triangle multiplications' intermediate
    width is the pair width (128 in every AlphaFold2 model), the width the
    triangle kernels take."""

    msa_dim: int = 256
    pair_dim: int = 128
    extra_msa_dim: int = 64
    target_feat_dim: int = 22
    msa_feat_dim: int = 49
    extra_msa_feat_dim: int = 25
    max_relative_feature: int = 32
    evoformer_blocks: int = 48
    extra_msa_blocks: int = 4
    msa_heads: int = 8
    msa_head_dim: int = 32
    extra_msa_head_dim: int = 8
    pair_heads: int = 4
    pair_head_dim: int = 32
    transition_factor: int = 4
    opm_dim: int = 32
    prev_pos_bins: int = 15
    prev_pos_min: float = 3.25
    prev_pos_max: float = 20.75
    struct: StructConfig = field(default_factory=lambda: MODEL_5_STRUCT)
    # data: num_recycle 3 (4 passes), num_ensemble 1
    num_recycle: int = 3
    max_msa_clusters: int = 512
    max_extra_msa: int = 1024
    masked_msa_replace_fraction: float = 0.15


# ---------------------------------------------------------------------------
# the reference layout
# ---------------------------------------------------------------------------
def _add_lin(sd, key, n_in, n_out, bias=True):
    sd[key + ".weight"] = (n_out, n_in)
    if bias:
        sd[key + ".bias"] = (n_out,)


def _add_ln(sd, key, n):
    sd[key + ".weight"] = (n,)
    sd[key + ".bias"] = (n,)


def _attention_shapes(sd, p, c_in, heads, c, bias_from=None):
    if bias_from is not None:
        _add_ln(sd, p + "layer_norm_m", c_in)
        _add_ln(sd, p + "layer_norm_z", bias_from)
        _add_lin(sd, p + "linear_z", bias_from, heads, bias=False)
    else:
        _add_ln(sd, p + "layer_norm", c_in)
    for n in "qkv":
        _add_lin(sd, p + f"linear_{n}", c_in, heads * c, bias=False)
    _add_lin(sd, p + "linear_g", c_in, heads * c)
    _add_lin(sd, p + "linear_o", heads * c, c_in)


def _block_shapes(sd, p, cfg: AlphaFoldConfig, extra: bool):
    z, f = cfg.pair_dim, cfg.transition_factor
    c_m = cfg.extra_msa_dim if extra else cfg.msa_dim
    c = cfg.extra_msa_head_dim if extra else cfg.msa_head_dim
    H = cfg.msa_heads
    _attention_shapes(sd, p + "msa_row_attention.", c_m, H, c, bias_from=z)
    if extra:
        g = p + "msa_column_global_attention."
        _add_ln(sd, g + "layer_norm", c_m)
        _add_lin(sd, g + "linear_q", c_m, H * c, bias=False)
        _add_lin(sd, g + "linear_k", c_m, c, bias=False)
        _add_lin(sd, g + "linear_v", c_m, c, bias=False)
        _add_lin(sd, g + "linear_g", c_m, H * c)
        _add_lin(sd, g + "linear_o", H * c, c_m)
    else:
        _attention_shapes(sd, p + "msa_column_attention.", c_m, H, c)
    for name, width in (("msa_transition.", c_m), ("pair_transition.", z)):
        _add_ln(sd, p + name + "layer_norm", width)
        _add_lin(sd, p + name + "linear_1", width, f * width)
        _add_lin(sd, p + name + "linear_2", f * width, width)
    o = p + "outer_product_mean."
    _add_ln(sd, o + "layer_norm", c_m)
    _add_lin(sd, o + "linear_a", c_m, cfg.opm_dim)
    _add_lin(sd, o + "linear_b", c_m, cfg.opm_dim)
    _add_lin(sd, o + "linear_out", cfg.opm_dim ** 2, z)
    for d in ("outgoing", "incoming"):
        t = p + f"triangle_multiplication_{d}."
        _add_ln(sd, t + "layer_norm_in", z)
        for n in ("a_p", "a_g", "b_p", "b_g", "g"):
            _add_lin(sd, t + f"linear_{n}", z, z)
        _add_ln(sd, t + "layer_norm_out", z)
        _add_lin(sd, t + "linear_z", z, z)
    for node in ("starting", "ending"):
        a = p + f"triangle_attention_{node}."
        _add_ln(sd, a + "layer_norm", z)
        _add_lin(sd, a + "linear_z", z, cfg.pair_heads, bias=False)
        for n in "qkv":
            _add_lin(sd, a + f"linear_{n}", z, cfg.pair_heads * cfg.pair_head_dim,
                 bias=False)
        _add_lin(sd, a + "linear_g", z, cfg.pair_heads * cfg.pair_head_dim)
        _add_lin(sd, a + "linear_o", cfg.pair_heads * cfg.pair_head_dim, z)


def alphafold_shapes(cfg: AlphaFoldConfig = AlphaFoldConfig()) -> dict:
    """Every key of the reference-layout state dict at ``cfg`` and its
    shape."""
    sd: dict[str, tuple] = {}
    m, z, s = cfg.msa_dim, cfg.pair_dim, cfg.struct.node_dim
    tf = cfg.target_feat_dim
    _add_lin(sd, "input_embedder.linear_tf_m", tf, m)
    _add_lin(sd, "input_embedder.linear_msa_m", cfg.msa_feat_dim, m)
    _add_lin(sd, "input_embedder.linear_tf_z_i", tf, z)
    _add_lin(sd, "input_embedder.linear_tf_z_j", tf, z)
    _add_lin(sd, "input_embedder.linear_relpos", 2 * cfg.max_relative_feature + 1,
         z)
    _add_lin(sd, "recycling_embedder.linear", cfg.prev_pos_bins, z)
    _add_ln(sd, "recycling_embedder.layer_norm_m", m)
    _add_ln(sd, "recycling_embedder.layer_norm_z", z)
    _add_lin(sd, "extra_msa_embedder.linear", cfg.extra_msa_feat_dim,
         cfg.extra_msa_dim)
    for i in range(cfg.extra_msa_blocks):
        _block_shapes(sd, f"extra_msa_stack.blocks.{i}.", cfg, extra=True)
    for i in range(cfg.evoformer_blocks):
        _block_shapes(sd, f"evoformer.blocks.{i}.", cfg, extra=False)
    _add_lin(sd, "evoformer.linear_single", m, s)
    _add_ln(sd, "structure_module.node_norm", s)
    _add_ln(sd, "structure_module.edge_norm", cfg.struct.edge_dim)
    _add_lin(sd, "structure_module.init_proj", s, s)
    with torch.device("meta"):
        cycle = StructureCycle(cfg.struct)
    for k, v in cycle.state_dict().items():
        sd["structure_module.cycle." + k] = tuple(v.shape)
    _add_ln(sd, "plddt_head.layer_norm", s)
    _add_lin(sd, "plddt_head.linear_1", s, cfg.struct.hidden_dim)
    _add_lin(sd, "plddt_head.linear_2", cfg.struct.hidden_dim,
         cfg.struct.hidden_dim)
    _add_lin(sd, "plddt_head.linear_3", cfg.struct.hidden_dim, cfg.struct.num_bins)
    return sd


def _is_norm(key: str) -> bool:
    return "norm" in key.split(".")[-2]


def random_alphafold_state_dict(cfg: AlphaFoldConfig, seed: int
                                ) -> dict[str, np.ndarray]:
    """A reference-layout state dict of float32 numpy arrays drawn from
    ``np.random.default_rng(seed)`` in ``random_omegafold_state_dict``'s
    distributions: LayerNorm weights ~ 1 + N(0, 0.1^2) and biases ~ N(0,
    0.1^2), linear weights ~ N(0, 1/fan_in), every other vector ~ N(0,
    0.1^2)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in alphafold_shapes(cfg).items():
        mean, std = 0.0, 0.1
        if _is_norm(key):
            mean = 1.0 if key.endswith(".weight") else 0.0
        elif key.endswith(".weight") and len(shape) == 2:
            std = 1.0 / math.sqrt(shape[1])
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        sd[key] = x + np.float32(mean) if mean else x
    return sd


def _count(sd, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    found = [int(m.group(1)) for k in sd if (m := pat.match(k))]
    return 1 + max(found) if found else 0


def infer_config_from_state_dict(sd, **data) -> AlphaFoldConfig:
    """Every width and depth from the tensors' shapes and the keys'
    counts; the data settings (``num_recycle``, ``max_msa_clusters``,
    ``max_extra_msa``, ...) from ``data`` or ``model_5``'s."""
    shp = lambda k: tuple(sd[k].shape)  # noqa: E731
    m = shp("input_embedder.linear_tf_m.weight")[0]
    z = shp("input_embedder.linear_tf_z_i.weight")[0]
    row = "evoformer.blocks.0.msa_row_attention."
    H = shp(row + "linear_z.weight")[0]
    ext = "extra_msa_stack.blocks.0.msa_column_global_attention."
    tri = "evoformer.blocks.0.triangle_attention_starting."
    Hp = shp(tri + "linear_z.weight")[0]
    ipa = "structure_module.cycle.ipa."
    Hs = shp(ipa + "trainable_point_weights")[0]
    s = shp("evoformer.linear_single.weight")[0]
    struct = StructConfig(
        node_dim=s, edge_dim=z, num_cycle=MODEL_5_STRUCT.num_cycle,
        num_transition=_count(sd, "structure_module.cycle.transition."),
        num_head=Hs,
        num_point_qk=shp(ipa + "q_point.weight")[0] // (3 * Hs),
        num_point_v=shp(ipa + "v_point.weight")[0] // (3 * Hs),
        num_scalar_qk=shp(ipa + "q_scalar.weight")[0] // Hs,
        num_scalar_v=shp(ipa + "v_scalar.weight")[0] // Hs,
        num_channel=MODEL_5_STRUCT.num_channel,
        num_residual_block=MODEL_5_STRUCT.num_residual_block,
        hidden_dim=shp("plddt_head.linear_1.weight")[0],
        num_bins=shp("plddt_head.linear_3.weight")[0])
    return AlphaFoldConfig(
        msa_dim=m, pair_dim=z,
        extra_msa_dim=shp("extra_msa_embedder.linear.weight")[0],
        target_feat_dim=shp("input_embedder.linear_tf_m.weight")[1],
        msa_feat_dim=shp("input_embedder.linear_msa_m.weight")[1],
        extra_msa_feat_dim=shp("extra_msa_embedder.linear.weight")[1],
        max_relative_feature=(shp("input_embedder.linear_relpos.weight")[1]
                              - 1) // 2,
        evoformer_blocks=_count(sd, "evoformer.blocks."),
        extra_msa_blocks=_count(sd, "extra_msa_stack.blocks."),
        msa_heads=H, msa_head_dim=shp(row + "linear_q.weight")[0] // H,
        extra_msa_head_dim=shp(ext + "linear_k.weight")[0],
        pair_heads=Hp, pair_head_dim=shp(tri + "linear_q.weight")[0] // Hp,
        transition_factor=shp("evoformer.blocks.0.msa_transition.linear_1."
                              "weight")[0] // m,
        opm_dim=shp("evoformer.blocks.0.outer_product_mean.linear_a.weight")[0],
        prev_pos_bins=shp("recycling_embedder.linear.weight")[1],
        struct=struct, **data)


# ---------------------------------------------------------------------------
# the model: folded weights in the layouts the kernels read
# ---------------------------------------------------------------------------
class Params(nn.Module):
    """A bag of tensors (buffers), by name."""

    def __init__(self, **tensors):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)


def _folded(sd, norm: str | None, lin: str, bias: bool = True):
    """(W [out, in], b [out]) of ``lin`` with LayerNorm ``norm``'s affine
    folded in (float64 products, float32 results)."""
    W = sd[lin + ".weight"].double()
    b = (sd[lin + ".bias"].double() if bias else
         torch.zeros(W.shape[0], dtype=W.dtype, device=W.device))
    if norm is not None:
        g, beta = sd[norm + ".weight"].double(), sd[norm + ".bias"].double()
        b = b + W @ beta
        W = W * g[None, :]
    return W.float(), b.float()


def _heads(W, b, H):
    """[H c, in], [H c] -> [in, H, c], [H, c]."""
    return W.T.reshape(W.shape[1], H, -1), b.reshape(H, -1)


def _gated_attention_params(sd, p, H, norm, bias_norm=None) -> Params:
    """The kernels' layout of a gated attention: qg_w, kv_w [d, 1, H, 2c];
    qg_b, kv_b [1, H, 1, 2c]; o_w [H, c, out], o_b [out]; and, for a
    bias from the pair tensor, z_w [z, H], z_b [H]."""
    q = _heads(*_folded(sd, norm, p + "linear_q", bias=False), H)
    g = _heads(*_folded(sd, norm, p + "linear_g"), H)
    k = _heads(*_folded(sd, norm, p + "linear_k", bias=False), H)
    v = _heads(*_folded(sd, norm, p + "linear_v", bias=False), H)

    def pair(a, b):
        return (torch.cat([a[0], b[0]], -1)[:, None].contiguous(),
                torch.cat([a[1], b[1]], -1)[None, :, None].contiguous())

    qg_w, qg_b = pair(q, g)
    kv_w, kv_b = pair(k, v)
    Wo = sd[p + "linear_o.weight"]
    out = dict(qg_w=qg_w, qg_b=qg_b, kv_w=kv_w, kv_b=kv_b,
               o_w=Wo.T.reshape(H, -1, Wo.shape[0]).contiguous(),
               o_b=sd[p + "linear_o.bias"].float())
    if bias_norm is not None:
        Wz, bz = _folded(sd, bias_norm, p + "linear_z", bias=False)
        out.update(z_w=Wz.T.contiguous(), z_b=bz)
    return Params(**out)


def _global_attention_params(sd, p, H) -> Params:
    n = p + "layer_norm"
    q, bq = _folded(sd, n, p + "linear_q", bias=False)
    k, bk = _folded(sd, n, p + "linear_k", bias=False)
    v, bv = _folded(sd, n, p + "linear_v", bias=False)
    g, bg = _folded(sd, n, p + "linear_g")
    return Params(q_w=q.T.contiguous(), q_b=bq, k_w=k.T.contiguous(), k_b=bk,
                  v_w=v.T.contiguous(), v_b=bv, g_w=g.T.contiguous(), g_b=bg,
                  o_w=sd[p + "linear_o.weight"].T.contiguous(),
                  o_b=sd[p + "linear_o.bias"].float())


def _transition_params(sd, p) -> Params:
    w1, b1 = _folded(sd, p + "layer_norm", p + "linear_1")
    return Params(w1=w1.T.contiguous(), b1=b1,
                  w2=sd[p + "linear_2.weight"].T.contiguous(),
                  b2=sd[p + "linear_2.bias"].float())


def _opm_params(sd, p) -> Params:
    n = p + "layer_norm"
    a, ba = _folded(sd, n, p + "linear_a")
    b, bb = _folded(sd, n, p + "linear_b")
    return Params(ab_w=torch.cat([a, b]).T.contiguous(),
                  ab_b=torch.cat([ba, bb]),
                  out_w=sd[p + "linear_out.weight"].T.contiguous(),
                  out_b=sd[p + "linear_out.bias"].float())


def _tri_mul_params(sd, p) -> Params:
    """The single-view triangle route's layout: act_w [d, 5d] = [a value,
    b value, a gate, b gate, output gate], act_b [5d], out_w [d, d], out_b
    [d], both LayerNorms folded."""
    n = p + "layer_norm_in"
    parts = [_folded(sd, n, p + f"linear_{k}")
             for k in ("a_p", "b_p", "a_g", "b_g", "g")]
    out_w, out_b = _folded(sd, p + "layer_norm_out", p + "linear_z")
    return Params(act_w=torch.cat([w for w, _ in parts]).T.contiguous(),
                  act_b=torch.cat([b for _, b in parts]),
                  out_w=out_w.T.contiguous(), out_b=out_b)


class Block(nn.Module):
    """One Evoformer or extra-MSA block's folded weights."""

    def __init__(self, sd, p, cfg: AlphaFoldConfig, extra: bool):
        super().__init__()
        self.extra = extra
        self.head_dim = cfg.extra_msa_head_dim if extra else cfg.msa_head_dim
        H = cfg.msa_heads
        r = p + "msa_row_attention."
        self.msa_row = _gated_attention_params(sd, r, H, r + "layer_norm_m",
                                               r + "layer_norm_z")
        if extra:
            self.msa_col = _global_attention_params(
                sd, p + "msa_column_global_attention.", H)
        else:
            c = p + "msa_column_attention."
            self.msa_col = _gated_attention_params(sd, c, H, c + "layer_norm")
        self.msa_transition = _transition_params(sd, p + "msa_transition.")
        self.opm = _opm_params(sd, p + "outer_product_mean.")
        self.tri_mul = nn.ModuleList(
            _tri_mul_params(sd, p + f"triangle_multiplication_{d}.")
            for d in ("outgoing", "incoming"))
        self.tri_att = nn.ModuleList(_gated_attention_params(
            sd, a, cfg.pair_heads, a + "layer_norm", a + "layer_norm")
            for a in (p + f"triangle_attention_{n}."
                      for n in ("starting", "ending")))
        self.pair_transition = _transition_params(sd, p + "pair_transition.")


class StructureModule(nn.Module):
    """Algorithm 20 without the side chains: OmegaFold's ``StructureCycle``
    applied ``num_cycle`` times with shared weights."""

    def __init__(self, s: StructConfig):
        super().__init__()
        self.num_layers = s.num_cycle
        self.node_norm = LayerNorm(s.node_dim)
        self.edge_norm = LayerNorm(s.edge_dim)
        self.init_proj = nn.Linear(s.node_dim, s.node_dim)
        self.cycle = StructureCycle(s)

    def forward(self, single, pair, mask):
        """single [L, c_s], pair [L, L, c_z], mask [L] -> (s [L, c_s],
        rots [L, 3, 3], trans [L, 3] in Angstrom)."""
        node = linear(self.init_proj, self.node_norm(single))
        edge = self.edge_norm(pair)
        L = node.shape[0]
        rots = torch.eye(3, device=node.device).expand(L, 3, 3)
        trans = torch.zeros(L, 3, device=node.device)
        for _ in range(self.num_layers):
            node, rots, trans = self.cycle(node, edge, rots, trans, mask)
        return node, rots, trans * 10.0


class AlphaFold(nn.Module):
    def __init__(self, sd, cfg: AlphaFoldConfig):
        super().__init__()
        self.cfg = cfg
        f = lambda k: sd[k].float()  # noqa: E731
        self.input_embedder = Params(**{
            k.split(".")[1] + "_" + k.split(".")[2]: f(k) for k in sd
            if k.startswith("input_embedder.")})
        r = "recycling_embedder."
        self.recycling_embedder = Params(
            pos_w=f(r + "linear.weight").T.contiguous(),
            pos_b=f(r + "linear.bias"),
            m_w=f(r + "layer_norm_m.weight"), m_b=f(r + "layer_norm_m.bias"),
            z_w=f(r + "layer_norm_z.weight"), z_b=f(r + "layer_norm_z.bias"))
        self.extra_msa_embedder = Params(
            w=f("extra_msa_embedder.linear.weight").T.contiguous(),
            b=f("extra_msa_embedder.linear.bias"))
        self.extra_msa_stack = nn.ModuleList(
            Block(sd, f"extra_msa_stack.blocks.{i}.", cfg, extra=True)
            for i in range(cfg.extra_msa_blocks))
        self.evoformer = nn.ModuleList(
            Block(sd, f"evoformer.blocks.{i}.", cfg, extra=False)
            for i in range(cfg.evoformer_blocks))
        self.single = Params(w=f("evoformer.linear_single.weight").T.contiguous(),
                             b=f("evoformer.linear_single.bias"))
        with torch.device("meta"):
            self.structure_module = StructureModule(cfg.struct)
            self.plddt_head = ConfidenceHead(cfg.struct)
        self.structure_module.load_state_dict(
            {k.removeprefix("structure_module."): f(k) for k in sd
             if k.startswith("structure_module.")}, strict=True, assign=True)
        w1, b1 = _folded(sd, "plddt_head.layer_norm", "plddt_head.linear_1")
        self.plddt_head.load_state_dict({
            "network.0.weight": w1, "network.0.bias": b1,
            "network.2.weight": f("plddt_head.linear_2.weight"),
            "network.2.bias": f("plddt_head.linear_2.bias"),
            "network.4.weight": f("plddt_head.linear_3.weight"),
            "network.4.bias": f("plddt_head.linear_3.bias")},
            strict=True, assign=True)
        cb = atoms.tables(sd["evoformer.linear_single.weight"].device)[
            "restype_atom14_aa_positions"][:, 4]
        self.register_buffer("cb_literature", cb.float())  # [21, 3]


def alphafold_from_state_dict(sd, device="cuda", **data) -> AlphaFold:
    """The model of a reference-layout state dict (torch tensors or numpy
    arrays; 'module.' prefixes stripped), float32 on ``device``. The
    widths and depths come from the shapes; ``data`` sets the data
    settings (``AlphaFoldConfig``'s last four fields)."""
    sd = {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}
    want = alphafold_shapes(infer_config_from_state_dict(sd))
    if set(sd) != set(want):
        raise KeyError(f"not an AlphaFold2 state dict: missing "
                       f"{sorted(set(want) - set(sd))[:5]}, unexpected "
                       f"{sorted(set(sd) - set(want))[:5]}")
    sd = {k: v.to(device) for k, v in sd.items()}
    return AlphaFold(sd, infer_config_from_state_dict(sd, **data)).eval()


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------
def _lin(x, w, b):
    return x @ w + b


def msa_row_attention(p: Params, m, z, c: int, *, plain: bool,
                      rows: int = 256):
    """Algorithm 7 (19 for the extra stack): m [M, L, c_m], z [L, L, c_z]
    -> the update of m. ``plain``: the kernel's plain version, ``rows``
    MSA rows at a time."""
    bias = _lin(_normalize(z), p.z_w, p.z_b).permute(2, 0, 1).contiguous()
    x = _normalize(m)
    kmask = torch.ones(x.shape[:2], device=x.device)
    kw = dict(c=c, scale=c ** -0.5)
    args = (p.qg_w, p.qg_b, p.kv_w, p.kv_b, bias)
    if plain:
        out = torch.cat([node_attention_plain(x[i:i + rows], *args,
                                              kmask[i:i + rows], **kw)
                         for i in range(0, x.shape[0], rows)])
    else:
        out = fused_gated_node_attention(x, *args, kmask, **kw)
    return torch.einsum("mhlc,hco->mlo", out, p.o_w) + p.o_b


def msa_column_attention(p: Params, m, c: int):
    """Algorithm 8: m [M, L, c_m] -> the update of m (attention over the
    M rows of each column, on the MSA's transpose)."""
    x = _normalize(m).transpose(0, 1).contiguous()  # [L, M, c_m]
    L, M = x.shape[:2]
    H = p.o_w.shape[0]
    bias = torch.zeros(H, M, M, device=x.device)
    out = fused_gated_node_attention(
        x, p.qg_w, p.qg_b, p.kv_w, p.kv_b, bias,
        torch.ones(L, M, device=x.device), c=c, scale=c ** -0.5)
    return torch.einsum("lhmc,hco->mlo", out, p.o_w) + p.o_b


def msa_column_global_attention(p: Params, m, c: int):
    """Algorithm 19: m [M, L, c_e] -> the update of m (one query a column,
    the mean of the rows' queries; keys and values one head wide)."""
    x = _normalize(m)
    H = p.g_b.shape[0] // c
    q = _lin(x.mean(0), p.q_w, p.q_b).reshape(-1, H, c) * c ** -0.5  # [L, H, c]
    k = _lin(x, p.k_w, p.k_b)  # [M, L, c]
    v = _lin(x, p.v_w, p.v_b)
    w = torch.softmax(torch.einsum("lhc,mlc->lhm", q, k), dim=-1)
    avg = torch.einsum("lhm,mlc->lhc", w, v)
    g = torch.sigmoid(_lin(x, p.g_w, p.g_b)).reshape(*x.shape[:2], H, c)
    return _lin((g * avg).reshape(*x.shape[:2], H * c), p.o_w, p.o_b)


def transition(p: Params, x):
    """Algorithms 9 and 15."""
    return _lin(torch.relu(_lin(_normalize(x), p.w1, p.b1)), p.w2, p.b2)


def outer_product_mean(p: Params, m, cols: int = 64):
    """Algorithm 10: m [M, L, c_m] -> the update of z [L, L, c_z]: the
    mean over the rows of a_i (x) b_j, projected, ``cols`` residues i at a
    time."""
    M = m.shape[0]
    ab = _lin(_normalize(m), p.ab_w, p.ab_b)
    a, b = ab.chunk(2, dim=-1)
    C = a.shape[-1]
    out = []
    for i in range(0, a.shape[1], cols):
        o = torch.einsum("mic,mjd->ijcd", a[:, i:i + cols], b)
        out.append(_lin(o.reshape(*o.shape[:2], C * C), p.out_w, p.out_b))
    return torch.cat(out) / (M + 1e-3)


def triangle_multiplication(p: Params, z, view: int, mask):
    """Algorithms 11 (``view`` 0, outgoing) and 12 (1, incoming): z plus
    its update, on the single-view triangle route."""
    return geom_triangle_view(_normalize(z), z, mask, p.act_w, p.act_b,
                              p.out_w, p.out_b, view=view)


def triangle_attention(p: Params, z, c: int):
    """Algorithm 13 on z [L, L, c_z] (14 on its transpose): each row i
    attends over its own entries, the bias b[j, k] shared by the rows."""
    x = _normalize(z)
    bias = _lin(x, p.z_w, p.z_b).permute(2, 0, 1)[None].contiguous()
    out = fused_gated_geom_attention_t(
        x.unsqueeze(1), p.qg_w, p.qg_b, p.kv_w, p.kv_b, bias, c=c,
        scale=c ** -0.5)  # [L, 1, H, L, c]
    return torch.einsum("irhjc,hco->ijo", out, p.o_w) + p.o_b


def evoformer_block(p: Block, m, z, mask):
    """Algorithm 6 (18 for the extra stack, ``p.extra``): (m, z) -> (m,
    z)."""
    c = p.head_dim
    with span("alphafold.msa_row_attention"):
        m = m + msa_row_attention(p.msa_row, m, z, c, plain=p.extra)
    if p.extra:
        with span("alphafold.msa_column_global_attention"):
            m = m + msa_column_global_attention(p.msa_col, m, c)
    else:
        with span("alphafold.msa_column_attention"):
            m = m + msa_column_attention(p.msa_col, m, c)
    with span("alphafold.msa_transition"):
        m = m + transition(p.msa_transition, m)
    with span("alphafold.outer_product_mean"):
        z = z + outer_product_mean(p.opm, m)
    for view, tm in enumerate(p.tri_mul):
        with span("alphafold.triangle_multiplication"):
            z = triangle_multiplication(tm, z, view, mask)
    cp = p.tri_att[0].o_w.shape[1]
    with span("alphafold.triangle_attention"):
        z = z + triangle_attention(p.tri_att[0], z, cp)
    with span("alphafold.triangle_attention"):
        z = z + triangle_attention(p.tri_att[1], z.transpose(0, 1),
                                   cp).transpose(0, 1)
    with span("alphafold.pair_transition"):
        z = z + transition(p.pair_transition, z)
    return m, z


def distogram(positions, cfg: AlphaFoldConfig):
    """One-hot [L, L, bins] of the squared distances between the
    pseudo-beta positions (``dgram_from_positions``)."""
    lower = torch.linspace(cfg.prev_pos_min, cfg.prev_pos_max,
                           cfg.prev_pos_bins, device=positions.device) ** 2
    upper = torch.cat([lower[1:], lower.new_tensor([1e8])])
    d2 = ((positions[:, None] - positions[None]) ** 2).sum(-1, keepdim=True)
    return ((d2 > lower) & (d2 < upper)).float()


def embed(model: AlphaFold, inputs: dict, recycle: dict, prev: dict):
    """Algorithms 3, 4 and 32 and the extra MSA's embedding: (m [M, L,
    c_m], z [L, L, c_z], extra m [E, L, c_e])."""
    e = model.input_embedder
    tf = inputs["target_feat"]
    m = _lin(recycle["msa_feat"], e.linear_msa_m_weight.T, e.linear_msa_m_bias)
    m = _lin(tf, e.linear_tf_m_weight.T, e.linear_tf_m_bias)[None] + m
    z = (_lin(tf, e.linear_tf_z_i_weight.T, e.linear_tf_z_i_bias)[:, None]
         + _lin(tf, e.linear_tf_z_j_weight.T, e.linear_tf_z_j_bias)[None])
    r = model.recycling_embedder
    z = z + _lin(distogram(prev["pseudo_beta"], model.cfg), r.pos_w, r.pos_b)
    m = torch.cat([m[:1] + _normalize(prev["msa_first_row"], r.m_w, r.m_b),
                   m[1:]])
    z = z + _normalize(prev["pair"], r.z_w, r.z_b)
    ri = inputs["residue_index"]
    k = model.cfg.max_relative_feature
    rel = torch.clamp(ri[:, None] - ri[None, :] + k, 0, 2 * k)
    z = z + e.linear_relpos_weight.T[rel] + e.linear_relpos_bias
    x = model.extra_msa_embedder
    return m, z, _lin(recycle["extra_msa_feat"], x.w, x.b)


def pseudo_beta(model: AlphaFold, rots, trans, aatype):
    """Cβ in the backbone frames (CA for glycine and X), [L, 3]."""
    lit = model.cb_literature[aatype]
    return torch.einsum("lij,lj->li", rots, lit) + trans


def alphafold_recycle(model: AlphaFold, inputs: dict, recycle: dict,
                      prev: dict) -> dict:
    """One pass of the network (one recycle): the outputs the next recycle
    reads and those extraction keeps."""
    L = inputs["aatype"].shape[0]
    mask = torch.ones(L, device=inputs["aatype"].device)
    with span("alphafold.embedders"):
        m, z, m_e = embed(model, inputs, recycle, prev)
    with span("alphafold.extra_msa_stack"):
        if m_e.shape[0]:
            for blk in model.extra_msa_stack:
                m_e, z = evoformer_block(blk, m_e, z, mask)
    with span("alphafold.evoformer"):
        for blk in model.evoformer:
            m, z = evoformer_block(blk, m, z, mask)
        single = _lin(m[0], model.single.w, model.single.b)
    with span("alphafold.structure_module"):
        s, rots, trans = model.structure_module(single, z, mask)
        plddt = model.plddt_head(s)
        pb = pseudo_beta(model, rots, trans, inputs["aatype"])
    # m[0] copied: a view would hold the whole MSA (134 MB at model_5's 512
    # clusters) through the next recycle
    return {"msa_first_row": m[0].clone(), "pair": z, "single": single,
            "plddt": plddt, "pseudo_beta": pb}


@dataclass
class Embedding:
    """The last recycle's reprs (float32, on the model's device) and its
    mean pLDDT."""

    node: torch.Tensor  # [L, c_m], the MSA's first row
    edge: torch.Tensor  # [L, L, c_z]
    single: torch.Tensor  # [L, c_s]
    plddt: torch.Tensor  # [L], in [0, 1]
    confidence: float


@torch.inference_mode()
def alphafold_embed(model: AlphaFold, inputs: dict,
                    on_recycle=None) -> Embedding:
    """Run every recycle of ``inputs`` (``features.sequence_features``:
    ``aatype``, ``target_feat``, ``residue_index`` and the per-recycle
    ``recycles``) on the model's device, each under ``alphafold.recycle``.
    ``on_recycle(i, outputs)``, if given, sees each recycle's outputs."""
    cfg = model.cfg
    L = inputs["aatype"].shape[0]
    dev = inputs["aatype"].device
    prev = {"msa_first_row": torch.zeros(L, cfg.msa_dim, device=dev),
            "pair": torch.zeros(L, L, cfg.pair_dim, device=dev),
            "pseudo_beta": torch.zeros(L, 3, device=dev)}
    for i, recycle in enumerate(inputs["recycles"]):
        with span("alphafold.recycle"):
            prev = alphafold_recycle(model, inputs, recycle, prev)
        if on_recycle is not None:
            on_recycle(i, prev)
    return Embedding(node=prev["msa_first_row"], edge=prev["pair"],
                     single=prev["single"], plddt=prev["plddt"],
                     confidence=float(prev["plddt"].mean()))


def sequence_inputs(model: AlphaFold, msa: feats.MSA, device) -> dict:
    """``features.sequence_features`` at the model's data settings (one
    recycle more than ``num_recycle``: the first pass)."""
    cfg = model.cfg
    return feats.sequence_features(
        msa, device, num_recycles=cfg.num_recycle + 1,
        max_clusters=cfg.max_msa_clusters, max_extra=cfg.max_extra_msa,
        replace_fraction=cfg.masked_msa_replace_fraction)
