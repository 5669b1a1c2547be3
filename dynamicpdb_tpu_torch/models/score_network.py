"""DFOLD score network: the trajectory-diffusion denoiser.

Port of ``dynamicpdb_tpu/models/score_network.py``. The network sees ONE
window of F frames x N residues:

  * frames 0..F-2 are clean references; the prediction slot F-1 starts as a
    copy of frame F-2 ("ref-cat") for rigids, forces, velocities, torsions;
  * only the last frame's rigid is updated per block;
  * node features = index embedding + expanded OmegaFold node_repr; edge
    features = expanded edge_repr, one [N, N, c_z] tensor for all frames;
  * the x0 prediction becomes rot/trans scores against the noisy rigids_t in
    ``score_forward``, outside the module.

Parameter names are the reference torch layout of
``dynamicpdb_tpu/train/export_torch.py`` without its dead
``embedding_layer.*`` entries; ``weights.state_dict_from_jax`` maps JAX
params onto it. ``embed.use_aatype_embedding`` adds one parameter the
reference layout has no key for, ``score_model.aatype_embed.weight``
[21, D] (JAX's ``nn.Embed``, ``score_network.py:127-130``): a
frame-shared embedding of ``aatype[0]`` added to the node features before
the node mask, in float32 as flax's embedding returns it. It is
registered only when the option is on, so checkpoints without it load
strictly; ``train/export_torch.py`` refuses it in a strict export.

``drop_ref`` makes classifier-free guidance work as the JAX package's does
(``score_network.py:95-104``): 1 replaces the reference-frame conditioning
(rigids, forces, velocities, angles) with the unconditional identity.
``model.remat`` wraps each IPA block in ``torch.utils.checkpoint``, as
``nn.remat`` does (``:148-157``): its activations are recomputed in the
backward instead of kept.

Sequence parallelism (``parallel/sp.py``, active inside
``sp.activated(mesh)``): the forward takes the whole window's features on
every rank and first cuts every per-residue input to this rank's rows
(``_local_window``), edge_repr to [rows, N, De] before ``expand_edge``, so
no activation is [N, N, .]. The input edge_repr itself is whole on the
device unless the caller cut it on the host (``sp.host_edge_rows``: the
Trainer, ``sampling/evaluate.py`` and ``tools/sp_run.py`` do; a caller of
the samplers under ``sp.activated`` should too). The trunk runs on those rows
(IPA gathers its keys, GlobalStatNorm sums its statistics, ConvNet trades
halo rows), and the per-residue outputs are gathered back to the whole
window at the end (``sp.gather_replicated``, one collective): every rank
returns the one-process outputs, so the score conversion, the loss and the
samplers run unchanged on every rank. Their gradient is the same on every
rank, and the gather's backward hands each rank its rows' slice; every
parameter is used on this rank's rows only, so a parameter's gradient is
this rank's share, and the trainer sums the shares over 'seq'.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dynamicpdb_tpu_torch.config import ModelConfig
from dynamicpdb_tpu_torch.models.ipa import InvariantPointAttention
from dynamicpdb_tpu_torch.models.layers import (
    AngleResnet,
    BackboneUpdate,
    ConvNet,
    Linear,
    MLPEmbedder,
    global_stat_norm,
)
from dynamicpdb_tpu_torch.ops import frames as frame_ops
from dynamicpdb_tpu_torch.ops.rigid import Rigid
from dynamicpdb_tpu_torch.parallel import sp
from dynamicpdb_tpu_torch.utils.platform import resolve_device

# the per-residue inputs of the forward, by the axis that runs over residues
ROW_INPUTS = {"res_mask": 1, "fixed_mask": 1, "seq_idx": 1, "rigids_0": 1,
              "torsion_angles_sin_cos": 1, "torsion_angles_mask": 1,
              "force": 1, "vel": 1, "aatype": 1, "node_repr": 0}
OUTPUT_KEYS = ("rigids", "angles", "unorm_angles", "rigid_update", "atom14",
               "atom37")
IDENTITY7 = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _ref_cat(x):
    """[F, ...] -> references + copy of F-2 in the last slot."""
    return torch.cat([x[:-1], x[-2:-1]], dim=0)


def _local_window(feats: dict) -> dict:
    """The forward's inputs cut to this rank's rows (pad rows past the
    window: masked, identity rigids); edge_repr [rows, N, De]."""
    n_res = feats["res_mask"].shape[1]
    out = {k: sp.take_rows(feats[k], n_res, dim,
                           fill=IDENTITY7 if k == "rigids_0" else None)
           for k, dim in ROW_INPUTS.items()}
    out["edge_repr"] = sp.edge_rows(feats["edge_repr"], n_res)
    return out


def _gather_outputs(out: dict, n_res: int) -> dict:
    """The per-residue outputs [F, rows, ...] of every rank, in one
    collective, as the whole window's [F, n_res, ...]."""
    F, rows = out["rigids"].shape[:2]
    flat = torch.cat([out[k].reshape(F, rows, -1) for k in OUTPUT_KEYS], -1)
    whole = sp.gather_replicated(flat, n_res, dim=1)
    widths = [out[k][0, 0].numel() for k in OUTPUT_KEYS]
    return {k: part.reshape((F, n_res) + out[k].shape[2:])
            for k, part in zip(OUTPUT_KEYS, whole.split(widths, dim=-1))}


class _Trunk(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        ipa = cfg.ipa
        for b in range(ipa.num_blocks):
            self.add_module(
                f"ipa_{b}", InvariantPointAttention(ipa, compute_dtype=dtype))
            self.add_module(f"bb_update_{b}", BackboneUpdate(ipa.c_s * 5))
        self.conv_0 = ConvNet(ipa.c_s * 5, compute_dtype=dtype)


class _ScoreModel(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        D = cfg.node_embed_size
        self.force_embeder = MLPEmbedder(3, D, dtype)
        self.vel_embeder = MLPEmbedder(3, D, dtype)
        self.index_embeder = MLPEmbedder(1, D, dtype)
        self.rigid_embeder = MLPEmbedder(7, D, dtype)
        self.angle_embeder = MLPEmbedder(14, D, dtype)
        self.trunk = _Trunk(cfg, dtype)
        self.angle_resnet = AngleResnet(
            cfg.ipa.c_s * 5, no_blocks=2, no_angles=7, eps=1e-12,
            compute_dtype=dtype,
        )
        if cfg.embed.use_aatype_embedding:
            self.aatype_embed = nn.Embedding(21, D)


class DFoldScoreNetwork(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        # bf16 projections / embedders / ConvNet / angle head; geometry,
        # IPA logits and block outputs stay float32
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.expand_node = Linear(cfg.node_repr_dim, cfg.node_embed_size)
        self.expand_edge = Linear(cfg.edge_repr_dim, cfg.edge_embed_size)
        self.score_model = _ScoreModel(cfg, self.dtype)
        self.to(resolve_device(device))

    def forward(self, feats: dict[str, Any], drop_ref=False):
        """Raw x0 prediction for one window.

        feats: rigids_0 [F,N,7], res_mask [F,N], fixed_mask [F,N],
          seq_idx [F,N], node_repr [N,Dn], edge_repr [N,N,De],
          torsion_angles_sin_cos [F,N,7,2], torsion_angles_mask [F,N,7],
          force [F,N,3], vel [F,N,3], aatype [F,N].
        drop_ref: False, or a 0/1 float (tensor) that drops the
          conditioning when 1.
        Returns rigids (tensor-7, unscaled), angles, unorm_angles,
          rigid_update, atom14, atom37. Under sequence parallelism
          edge_repr may also be this rank's rows alone
          (``sp.host_edge_rows``).
        """
        if not sp.is_active():
            return self._forward(feats, drop_ref)
        n_res = feats["res_mask"].shape[1]
        out = self._forward(_local_window(feats), drop_ref)
        return _gather_outputs(out, n_res)

    def _forward(self, feats: dict[str, Any], drop_ref=False):
        cfg, sm = self.cfg, self.score_model
        ipa_cfg = cfg.ipa
        dtype = self.dtype
        D = cfg.node_embed_size

        node_mask = feats["res_mask"].float()  # [F, N]
        diffuse_mask = (1 - feats["fixed_mask"].float()) * node_mask
        F, N = node_mask.shape

        expand_node = self.expand_node(feats["node_repr"])
        edge_embed = self.expand_edge(feats["edge_repr"])  # [N, N, c_z]

        # conditioning with the prediction slot seeded from frame F-2
        curr_rigids = _ref_cat(feats["rigids_0"].float())
        force = _ref_cat(feats["force"].float())
        vel = _ref_cat(feats["vel"].float())
        angle = feats["torsion_angles_sin_cos"].float()
        angle = angle * feats["torsion_angles_mask"][..., None].float()
        angle = _ref_cat(angle).reshape(F, N, -1)  # [F, N, 14]
        if drop_ref is not False:
            keep = 1.0 - torch.as_tensor(drop_ref, dtype=torch.float32,
                                         device=node_mask.device)
            identity7 = torch.zeros_like(curr_rigids)
            identity7[..., 0] = 1.0
            curr_rigids = keep * curr_rigids + (1 - keep) * identity7
            force, vel, angle = force * keep, vel * keep, angle * keep

        force_embed = sm.force_embeder(force, mask=node_mask)
        vel_embed = sm.vel_embeder(vel, mask=node_mask)
        angle_embed = sm.angle_embeder(angle, mask=node_mask)

        seq_idx = feats["seq_idx"][0:1, :, None].float()  # [1, N, 1]
        node_embed = sm.index_embeder(seq_idx, mask=node_mask[0:1])
        node_embed = node_embed.expand(F, N, D) + expand_node[None]
        if cfg.embed.use_aatype_embedding:  # frame-shared, float32
            node_embed = node_embed + sm.aatype_embed(
                feats["aatype"][0].long())[None]
        node_embed = node_embed * node_mask[..., None]

        trunk = sm.trunk
        last_only = torch.zeros((F, 1, 1), device=node_mask.device)
        last_only[-1] = 1.0
        init_node_feat = None
        rigid_update = None
        for b in range(ipa_cfg.num_blocks):
            rigids_embed = sm.rigid_embeder(curr_rigids, mask=node_mask)
            ipa_args = (node_embed, edge_embed,
                        Rigid.from_tensor_7(curr_rigids), node_mask)
            ipa = getattr(trunk, f"ipa_{b}")
            if cfg.remat and torch.is_grad_enabled():
                ipa_out = checkpoint(ipa, *ipa_args, use_reentrant=False)
            else:
                ipa_out = ipa(*ipa_args)
            ipa_out = global_stat_norm(ipa_out, mask=node_mask)
            node_feat = torch.cat(
                [t.float() for t in (rigids_embed, ipa_out, force_embed,
                                     vel_embed, angle_embed)],
                dim=-1,
            )  # [F, N, 5*c_s]
            node_feat = trunk.conv_0(
                node_feat.to(dtype) if dtype else node_feat, mask=node_mask
            ).float()

            rigid_update = getattr(trunk, f"bb_update_{b}")(node_feat)
            rigid_update = rigid_update * last_only  # references never move
            curr = Rigid.from_tensor_7(curr_rigids).compose_q_update_vec(
                rigid_update, diffuse_mask[..., None])
            curr_rigids = curr.to_tensor_7()
            if b == 0:
                init_node_feat = node_feat

        unorm_angles, angles = sm.angle_resnet(node_feat, init_node_feat)

        final = Rigid.from_tensor_7(curr_rigids).scale_translation(
            1.0 / ipa_cfg.coordinate_scaling)

        # fixed-mask passthrough for angles
        fixed = feats["fixed_mask"].float()[..., None, None]
        gt_angles = feats["torsion_angles_sin_cos"].float()
        angles = (1 - fixed) * angles + fixed * gt_angles
        unorm_angles = (1 - fixed) * unorm_angles + fixed * gt_angles

        aatype = feats["aatype"].long()
        all_frames = frame_ops.torsion_angles_to_frames(final, angles, aatype)
        atom14 = frame_ops.frames_to_atom14_pos(all_frames, aatype)
        atom37, _ = frame_ops.atom14_to_atom37(atom14, aatype)

        return {
            "rigids": final.to_tensor_7(),
            "angles": angles,
            "unorm_angles": unorm_angles,
            "rigid_update": rigid_update,
            "atom14": atom14,
            "atom37": atom37,
        }


def score_forward(model: DFoldScoreNetwork, diffuser, feats, drop_ref=False):
    """Model forward + analytic score conversion: x0 prediction -> rot/trans
    scores against the noisy rigids_t."""
    out = model(feats, drop_ref)
    node_mask = feats["res_mask"].float()
    t = feats["t"]
    init = Rigid.from_tensor_7(feats["rigids_t"].float())
    pred = Rigid.from_tensor_7(out["rigids"])

    rot_score = diffuser.calc_rot_score(init.quat, pred.quat, t)
    out["rot_score"] = rot_score * node_mask[..., None]
    trans_score = diffuser.calc_trans_score(
        init.trans, pred.trans, t[:, None, None], scale=True)
    out["trans_score"] = trans_score * node_mask[..., None]
    return out
