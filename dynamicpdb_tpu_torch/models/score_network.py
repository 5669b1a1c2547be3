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
params onto it. ``remat`` (training) and ``drop_ref`` (classifier-free
guidance, which the ported sampler does not use) are not ported.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

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
from dynamicpdb_tpu_torch.utils.platform import resolve_device


def _ref_cat(x):
    """[F, ...] -> references + copy of F-2 in the last slot."""
    return torch.cat([x[:-1], x[-2:-1]], dim=0)


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


class DFoldScoreNetwork(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.embed.use_aatype_embedding:
            raise ValueError("use_aatype_embedding has no reference-layout "
                             "parameters and is not ported")
        self.cfg = cfg
        # bf16 projections / embedders / ConvNet / angle head; geometry,
        # IPA logits and block outputs stay float32
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.expand_node = Linear(cfg.node_repr_dim, cfg.node_embed_size)
        self.expand_edge = Linear(cfg.edge_repr_dim, cfg.edge_embed_size)
        self.score_model = _ScoreModel(cfg, self.dtype)
        self.to(resolve_device(device))

    def forward(self, feats: dict[str, Any]):
        """Raw x0 prediction for one window.

        feats: rigids_0 [F,N,7], res_mask [F,N], fixed_mask [F,N],
          seq_idx [F,N], node_repr [N,Dn], edge_repr [N,N,De],
          torsion_angles_sin_cos [F,N,7,2], torsion_angles_mask [F,N,7],
          force [F,N,3], vel [F,N,3], aatype [F,N].
        Returns rigids (tensor-7, unscaled), angles, unorm_angles,
          rigid_update, atom14, atom37.
        """
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

        force_embed = sm.force_embeder(force, mask=node_mask)
        vel_embed = sm.vel_embeder(vel, mask=node_mask)
        angle_embed = sm.angle_embeder(angle, mask=node_mask)

        seq_idx = feats["seq_idx"][0:1, :, None].float()  # [1, N, 1]
        node_embed = sm.index_embeder(seq_idx, mask=node_mask[0:1])
        node_embed = node_embed.expand(F, N, D) + expand_node[None]
        node_embed = node_embed * node_mask[..., None]

        trunk = sm.trunk
        last_only = torch.zeros((F, 1, 1), device=node_mask.device)
        last_only[-1] = 1.0
        init_node_feat = None
        rigid_update = None
        for b in range(ipa_cfg.num_blocks):
            rigids_embed = sm.rigid_embeder(curr_rigids, mask=node_mask)
            ipa_out = getattr(trunk, f"ipa_{b}")(
                node_embed, edge_embed, Rigid.from_tensor_7(curr_rigids),
                node_mask,
            )
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


def score_forward(model: DFoldScoreNetwork, diffuser, feats):
    """Model forward + analytic score conversion: x0 prediction -> rot/trans
    scores against the noisy rigids_t."""
    out = model(feats)
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
