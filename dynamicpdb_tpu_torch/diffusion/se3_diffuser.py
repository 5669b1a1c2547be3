"""SE(3) diffusion: SO(3) x R^3 product diffusion over backbone frames.

Port of ``dynamicpdb_tpu/diffusion/se3_diffuser.py``. Rotations stay
quaternions on the device; the rotation-vector maps are tensor ops.
"""
from __future__ import annotations

import dataclasses

import torch

from dynamicpdb_tpu_torch.diffusion.r3_diffuser import R3Config, R3Diffuser
from dynamicpdb_tpu_torch.diffusion.so3_diffuser import SO3Config, SO3Diffuser
from dynamicpdb_tpu_torch.ops import so3
from dynamicpdb_tpu_torch.ops.rigid import Rigid
from dynamicpdb_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class SE3Config:
    diffuse_rot: bool = True
    diffuse_trans: bool = True
    so3: SO3Config = dataclasses.field(default_factory=SO3Config)
    r3: R3Config = dataclasses.field(default_factory=R3Config)


class SE3Diffuser:
    def __init__(self, conf: SE3Config = SE3Config(), device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        self.so3d = SO3Diffuser(conf.so3, device=self.device)
        self.r3d = R3Diffuser(conf.r3, device=self.device)

    # -- model-side score conversions ----------------------------------------
    def calc_rot_score(self, quats_t, quats_0, t):
        """rotvec_0t = Log(q_0^{-1} ⊗ q_t); score = IGSO3 score there.
        ``t`` has the leading batch (frame) shape."""
        quats_0t = so3.quat_multiply(so3.quat_invert(quats_0), quats_t)
        return self.so3d.score(so3.quat_to_rotvec(quats_0t), t)

    def calc_trans_score(self, trans_t, trans_0, t, scale: bool = True):
        return self.r3d.score(trans_t, trans_0, t, scale=scale)

    def score_scaling(self, t):
        return self.so3d.score_scaling(t), self.r3d.score_scaling(t)

    # -- reverse sampling -------------------------------------------------------
    def reverse(self, rigid_t: Rigid, rot_score, trans_score, t, dt,
                diffuse_mask=None, center: bool = True,
                noise_scale: float = 1.0, *, generator=None,
                rot_z=None, trans_z=None) -> Rigid:
        """One reverse step from t to t - dt. ``rot_z``/``trans_z`` are the
        standard normals of the two SDEs, drawn from ``generator`` unless
        given."""
        rot_t = so3.quat_to_rotvec(rigid_t.quat)
        trans_t = rigid_t.trans

        if self.conf.diffuse_rot:
            rot_t_1 = self.so3d.reverse(
                rot_t, rot_score, t, dt, noise_scale=noise_scale,
                generator=generator, z=rot_z,
            )
        else:
            rot_t_1 = rot_t
        if self.conf.diffuse_trans:
            trans_t_1 = self.r3d.reverse(
                trans_t, trans_score, t, dt, center=center,
                noise_scale=noise_scale, generator=generator, z=trans_z,
            )
        else:
            trans_t_1 = trans_t

        if diffuse_mask is not None:
            m = diffuse_mask[..., None]
            rot_t_1 = m * rot_t_1 + (1 - m) * rot_t
            trans_t_1 = m * trans_t_1 + (1 - m) * trans_t
        return Rigid(so3.rotvec_to_quat(rot_t_1), trans_t_1)

    def sample_ref(self, shape, *, generator=None, rot_axis=None, rot_u=None,
                   trans_z=None) -> torch.Tensor:
        """Frames from the t=1 reference distribution as tensor-7; ``shape``
        = batch dims, e.g. (F, N)."""
        rot_ref = self.so3d.sample_ref(shape, generator=generator,
                                       axis=rot_axis, u=rot_u)
        trans_ref = self.r3d._unscale(
            self.r3d.sample_ref(shape, generator=generator, z=trans_z))
        return Rigid(so3.rotvec_to_quat(rot_ref), trans_ref).to_tensor_7()
