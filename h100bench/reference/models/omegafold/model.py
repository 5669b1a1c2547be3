"""OmegaFold: the recycling model behind embedding extraction.

Port of ``dynamicpdb_tpu/models/omegafold/model.py``. Per recycling cycle:
OmegaPLM over the pseudo-MSA, the PLM projections and the edge embedder,
the recycle embedder (previous node, edge and atoms), the GeoFormer, the
structure module, atom14 and the confidence head. The reprs of the most
confident cycle are kept: a cycle wins only if its confidence is strictly
greater than the best so far, which starts at 0.0, and the first cycle is
kept when none beats it. The selection stays on the device (no host sync
per cycle), as the JAX package's ``omegafold_embed_scan``.

Sequence parallelism (``parallel/sp.py``, inside ``sp.activated(mesh)``
with a 'seq' axis; JAX ``model.py:123-126`` and the constraints of its PLM
and GeoFormer): the PLM, the embedders and the GeoFormer run on this
rank's residues and on its rows of every [L, L, .] tensor. Before the
structure module the cycle gathers the GeoFormer's node and edge whole
(``sp.gather_replicated``), and the structure module, atom14 and the
confidence head run whole on every rank (JAX leaves them unconstrained):
every rank computes the same fold. ``omegafold_embed`` keeps the previous
and the best cycle's edge as rows between cycles and gathers the selected
one once, at the end; the choice of a cycle reads rank 0's confidence
(``sp.rank0``), so no two ranks can choose differently. A window that S
does not divide is padded to S ceil(L / S) rows; the pad rows never reach
a real one and are cut by every gather.

``OmegaFold``'s state-dict keys are the reference OmegaFold's, the keys
the JAX package's ``params_from_state_dict`` reads, so a released
checkpoint loads strictly (``omegafold_from_state_dict``).

The JAX module's ``OmegaFoldParams`` pytree and its converters
(``params_from_state_dict``, ``params_from_torch``) are ``OmegaFold``'s own
parameters and ``omegafold_from_state_dict`` here; ``omegafold_embed_scan``
(the cycles under ``lax.scan``) is ``omegafold_embed``, which keeps the
best cycle on the device without a scan.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from h100bench.reference.models.omegafold import atoms
from h100bench.reference.models.omegafold.core import layer_norm_f32, linear
from h100bench.reference.models.omegafold.embedders import (
    EdgeEmbedder,
    RecycleEmbedder,
)
from h100bench.reference.models.omegafold.geoformer import GeoFormer, _span
from h100bench.reference.models.omegafold.plm import OmegaPLM, PLMConfig
from h100bench.reference.models.omegafold.structure import (
    ConfidenceHead,
    StructureModule,
)
from h100bench.reference.parallel import sp


@dataclass(frozen=True)
class StructConfig:
    node_dim: int = 384
    edge_dim: int = 128
    num_cycle: int = 8
    num_transition: int = 3
    num_head: int = 12
    num_point_qk: int = 4
    num_point_v: int = 8
    num_scalar_qk: int = 16
    num_scalar_v: int = 16
    num_channel: int = 128
    num_residual_block: int = 2
    hidden_dim: int = 128
    num_bins: int = 50


@dataclass(frozen=True)
class OmegaFoldConfig:
    """The release configuration by default: upstream OmegaFold's
    ``make_config()`` (795M parameters)."""

    plm: PLMConfig = PLMConfig()
    alphabet_size: int = 21
    node_dim: int = 256
    edge_dim: int = 128
    relpos_len: int = 32
    prev_pos_num_bins: int = 16
    geo_num_blocks: int = 50
    attn_c: int = 32
    attn_n_head: int = 8
    transition_multiplier: int = 4
    opm_dim: int = 32
    geom_count: int = 2
    geom_c: int = 32
    geom_head: int = 4
    struct: StructConfig = StructConfig()


class OmegaFoldCycle(nn.Module):
    def __init__(self, cfg: OmegaFoldConfig, device=None):
        super().__init__()
        self.geoformer = GeoFormer(cfg, device=device)
        self.structure_module = StructureModule(cfg.struct, device=device)
        self.confidence_head = ConfidenceHead(cfg.struct, device=device)


class OmegaFold(nn.Module):
    def __init__(self, cfg: OmegaFoldConfig = OmegaFoldConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.omega_plm = OmegaPLM(cfg.plm, device=device)
        self.plm_node_embedder = nn.Linear(cfg.plm.node, cfg.node_dim,
                                           device=device)
        self.plm_edge_embedder = nn.Linear(cfg.plm.num_layers, cfg.edge_dim,
                                           device=device)
        self.input_embedder = EdgeEmbedder(cfg.alphabet_size, cfg.edge_dim,
                                           cfg.relpos_len, device=device)
        self.recycle_embedder = RecycleEmbedder(
            cfg.node_dim, cfg.edge_dim, cfg.prev_pos_num_bins, device=device)
        self.omega_fold_cycle = OmegaFoldCycle(cfg, device=device)


def _normalize_unbiased(x, eps=1e-5):
    """The reference's in-place normalize: torch.var's unbiased estimator."""
    return layer_norm_f32(x, eps=eps, unbiased=True)


def get_all_confidence(plddt, ca_pos, mask, cutoff: float = 15.0):
    """Overall lDDT confidence of a cycle (a 0-dim float32 tensor)."""
    d = torch.sqrt(((ca_pos[:, None] - ca_pos[None, :]) ** 2).sum(-1) + 1e-10)
    eye = torch.eye(d.shape[0], dtype=d.dtype, device=d.device)
    scored = (d < cutoff) * mask[:, None] * mask[None, :] * (1.0 - eye)
    return (plddt * (scored.sum(-1) + 1e-10)).sum() / (1e-10 + scored.sum())


def deep_sequence_embed(model: OmegaFold, p_msa, p_msa_mask):
    """PLM forward, its projections and the input edge embedder: node
    [M, Lr, node_dim] and edge [Lr, L, edge_dim], this rank's rows (the
    PLM's edge stack stays as rows; Lr = L outside sequence
    parallelism)."""
    node, edges = model.omega_plm(p_msa, p_msa_mask)
    node = linear(model.plm_node_embedder, _normalize_unbiased(node))
    edge = linear(model.plm_edge_embedder,
                  _normalize_unbiased(edges.permute(1, 2, 0)))
    return node, model.input_embedder(p_msa[0], out=edge)


def omegafold_cycle(model: OmegaFold, p_msa, p_msa_mask, prev_node,
                    prev_edge, prev_x, *, pad_safe: bool = False):
    """One recycling iteration on prev_node [L, node_dim], prev_edge
    [Lr, L, edge_dim] (this rank's rows; Lr = L outside sequence
    parallelism) and prev_x [L, 14, 3]. Returns (node_out [L, node_dim],
    edge_out [Lr, L, edge_dim], confidence, plddt [L], pos14 [L, 14, 3]):
    all but the edge whole, the same on every rank. Each stage runs under a
    profiler range named for it."""
    fasta, mask = p_msa[0], p_msa_mask[0]
    cyc = model.omega_fold_cycle
    with _span("plm_and_embedders"):
        node, edge = deep_sequence_embed(model, p_msa, p_msa_mask)
        node, edge = model.recycle_embedder(fasta, prev_node, prev_edge,
                                            prev_x, node, edge)
    with _span("geoformer"):
        node, edge, final_node = cyc.geoformer(node, edge, p_msa_mask,
                                               pad_safe=pad_safe)
    L = fasta.shape[-1]
    node0 = sp.gather_replicated(node[0], L, dim=0)
    with _span("structure_module"):
        node_struct, (rots, trans), torsions = cyc.structure_module(
            sp.gather_replicated(final_node[0], L, dim=0),
            sp.gather_replicated(edge, L, dim=0), mask)
    with _span("atom14_and_confidence"):
        pos14, _ = atoms.frames_and_torsions_to_atom14(
            rots, trans, mask.bool(), torsions.float(), fasta)
        plddt = cyc.confidence_head(node_struct)
        conf = get_all_confidence(plddt, pos14[..., 1, :], mask.float())
    return node0, edge, conf, plddt, pos14


@dataclass
class Embedding:
    """The reprs of the selected cycle (float32, on the model's device)
    and, fetched once at the end, the confidences. With
    ``return_structure`` also that cycle's fold: ``pos14`` [L, 14, 3] and
    ``plddt`` [L] (float32, on the device)."""

    edge: torch.Tensor  # [L, L, edge_dim]
    node: torch.Tensor  # [L, node_dim]
    confidence: float  # the best cycle's (the selected one's by default)
    cycle: int  # the selected cycle's index
    confidences: list  # every cycle's
    pos14: torch.Tensor | None = None
    plddt: torch.Tensor | None = None


@torch.inference_mode()
def omegafold_embed(model: OmegaFold, cycle_inputs, *,
                    predict_with_confidence: bool = True,
                    pad_safe: bool = False,
                    return_structure: bool = False,
                    on_cycle=None) -> Embedding:
    """Run every recycling cycle of ``cycle_inputs`` (the pipeline's
    {p_msa, p_msa_mask} dicts) on the model's device and dtype; keep the
    most confident cycle's reprs, or the last cycle's when
    ``predict_with_confidence`` is False (``confidence`` is the best
    cycle's either way, as in the JAX package). ``return_structure`` also
    keeps the selected cycle's pos14 and pLDDT, selected on the device like
    the reprs. ``pad_safe`` for inputs padded by the pipeline (the outputs
    then carry the padded length). ``on_cycle(i, node, edge, confidence)``,
    if given, sees each cycle's outputs as it ends (edge: this rank's
    rows).

    Under sequence parallelism every rank returns the same Embedding."""
    w = model.plm_node_embedder.weight
    dev, act = w.device, w.dtype
    cfg = model.cfg
    L = cycle_inputs[0]["p_msa"].shape[-1]
    rows = sp.row_range(L)[1]
    prev_node = torch.zeros(L, cfg.node_dim, dtype=act, device=dev)
    prev_edge = torch.zeros(rows, L, cfg.edge_dim, dtype=act, device=dev)
    prev_x = torch.zeros(L, 14, 3, dtype=act, device=dev)
    best_conf = torch.zeros((), dtype=torch.float32, device=dev)
    best_cycle = torch.zeros((), dtype=torch.int64, device=dev)
    best_node, best_edge, confs = prev_node, prev_edge, []
    best_pos14 = best_plddt = None
    for i, cyc in enumerate(cycle_inputs):
        p_msa = torch.as_tensor(cyc["p_msa"], device=dev)
        mask = torch.as_tensor(cyc["p_msa_mask"], device=dev).to(act)
        node, edge, conf, plddt, pos14 = omegafold_cycle(
            model, p_msa, mask, prev_node, prev_edge, prev_x,
            pad_safe=pad_safe)
        prev_node, prev_edge, prev_x = node.to(act), edge.to(act), pos14.to(act)
        if on_cycle is not None:
            on_cycle(i, node, edge, conf)
        conf = sp.rank0(conf)  # one choice on every rank
        better = conf > best_conf
        if i == 0 or not predict_with_confidence:  # this cycle fills them
            better = torch.ones_like(better)
        best_node = torch.where(better, prev_node, best_node)
        best_edge = torch.where(better, prev_edge, best_edge)
        best_cycle = torch.where(better, i, best_cycle)
        if return_structure:
            pos14, plddt = pos14.float(), plddt.float()
            best_pos14 = pos14 if i == 0 else torch.where(better, pos14,
                                                          best_pos14)
            best_plddt = plddt if i == 0 else torch.where(better, plddt,
                                                          best_plddt)
        best_conf = torch.where(conf > best_conf, conf.float(), best_conf)
        confs.append(conf.float())
    best_edge = sp.gather_replicated(best_edge, L, dim=0)
    return Embedding(edge=best_edge.float(), node=best_node.float(),
                     confidence=float(best_conf), cycle=int(best_cycle),
                     confidences=torch.stack(confs).tolist(),
                     pos14=best_pos14, plddt=best_plddt)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _count(sd, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    return 1 + max(int(m.group(1)) for k in sd if (m := pat.match(k)))


def infer_config_from_state_dict(sd) -> OmegaFoldConfig:
    """Every dimension and depth from the tensors' shapes and the keys'
    counts (masked_ratio and the distogram's bin edges are reference
    constants, kept at their defaults)."""
    shp = lambda k: tuple(sd[k].shape)  # noqa: E731
    plm = "omega_plm.layers.0.gau."
    alphabet, plm_node = shp("omega_plm.input_embedding.weight")
    edge_dim, num_layers = shp("plm_edge_embedder.weight")
    attn_dim = shp(plm + "multi_headed_scaling.weight")[1]
    proj_dim = (shp(plm + "gva_proj.0.weight")[0] - attn_dim) // 2
    geo = "omega_fold_cycle.geoformer.blocks."
    node_dim = shp("plm_node_embedder.weight")[0]
    _, _, attn_head, a2c = shp(geo + "0.attention_w_edge_bias.attention.qg_weights")
    _, _, geom_head, g2c = shp(geo + "0.geometric_attention.0.attention.qg_weights")
    st = "omega_fold_cycle.structure_module."
    ipa = st + "cycles.0.ipa."
    H = shp(ipa + "trainable_point_weights")[0]
    conf = "omega_fold_cycle.confidence_head.network."
    return OmegaFoldConfig(
        plm=PLMConfig(alphabet_size=alphabet, node=plm_node,
                      num_layers=num_layers, proj_dim=proj_dim,
                      attn_dim=attn_dim,
                      num_relpos=shp(plm + "relpos.weight")[0]),
        alphabet_size=shp("input_embedder.proj_i.weight")[0],
        node_dim=node_dim,
        edge_dim=edge_dim,
        relpos_len=(shp("input_embedder.relpos.weight")[0] - 1) // 2,
        prev_pos_num_bins=shp("recycle_embedder.prev_pos_embed.weight")[0],
        geo_num_blocks=_count(sd, geo),
        attn_c=a2c // 2,
        attn_n_head=attn_head,
        transition_multiplier=shp(
            geo + "0.node_transition.network.0.weight")[0] // node_dim,
        opm_dim=shp(geo + "0.out_product.out_weights")[0],
        geom_count=_count(sd, geo + "0.geometric_attention."),
        geom_c=g2c // 2,
        geom_head=geom_head,
        struct=StructConfig(
            node_dim=shp("omega_fold_cycle.geoformer.node_final_proj.weight")[0],
            edge_dim=shp(st + "edge_norm.weight")[0],
            num_cycle=_count(sd, st + "cycles."),
            num_transition=_count(sd, st + "cycles.0.transition."),
            num_head=H,
            num_point_qk=shp(ipa + "q_point.weight")[0] // (3 * H),
            num_point_v=shp(ipa + "v_point.weight")[0] // (3 * H),
            num_scalar_qk=shp(ipa + "q_scalar.weight")[0] // H,
            num_scalar_v=shp(ipa + "v_scalar.weight")[0] // H,
            num_channel=shp(st + "torsion_angle_pred.input_projection.0.weight")[0],
            num_residual_block=_count(sd, st + "torsion_angle_pred.resblock1."),
            hidden_dim=shp(conf + "0.weight")[0],
            num_bins=shp(conf + "4.weight")[0],
        ),
    )


def omegafold_from_state_dict(sd, device="cuda", dtype=None) -> OmegaFold:
    """The model of a reference-layout state dict (torch tensors or numpy
    arrays; 'module.' prefixes stripped), loaded strictly, on ``device`` in
    ``dtype`` (None: float32). The dimensions come from the shapes."""
    sd = {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}
    with torch.device("meta"):
        model = OmegaFold(infer_config_from_state_dict(sd))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=device, dtype=dtype or torch.float32).eval()
