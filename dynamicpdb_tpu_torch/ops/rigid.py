"""Quaternion-native SE(3) rigid transforms on tensors.

Port of ``dynamicpdb_tpu/ops/rigid.py``: one canonical representation, a
unit quaternion [..., 4] (scalar first) plus a translation [..., 3];
rotation matrices are built on demand. The tensor-7 layout (quat ++ trans)
is the reference's ``Rigid.to_tensor_7``.
"""
from __future__ import annotations

import torch

from dynamicpdb_tpu_torch.ops import so3


class Rigid:
    """Batch of rigid transforms; shape = broadcast batch dims of quat/trans."""

    def __init__(self, quat: torch.Tensor, trans: torch.Tensor):
        self.quat = quat  # [..., 4]
        self.trans = trans  # [..., 3]

    @classmethod
    def from_tensor_7(cls, t: torch.Tensor, normalize: bool = True) -> "Rigid":
        quat = t[..., :4]
        if normalize:
            quat = so3.quat_normalize(quat)
        return cls(quat, t[..., 4:])

    def to_tensor_7(self) -> torch.Tensor:
        return torch.cat([self.quat, self.trans], dim=-1)

    @classmethod
    def from_rotmat(cls, m: torch.Tensor, trans: torch.Tensor) -> "Rigid":
        return cls(so3.rotmat_to_quat(m), trans)

    def rotmat(self) -> torch.Tensor:
        return so3.quat_to_rotmat(self.quat)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Rotate + translate points [..., 3]."""
        return torch.einsum("...ij,...j->...i", self.rotmat(), pts) + self.trans

    def invert_apply(self, pts: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ji,...j->...i", self.rotmat(), pts - self.trans)

    def compose_q_update_vec(
        self, update: torch.Tensor, mask: torch.Tensor | None = None
    ) -> "Rigid":
        """AF2 backbone update (Algorithm 23).

        ``update`` [..., 6]: the (b, c, d) imaginary parts of a quaternion
        whose real part is 1, then a translation in the local frame.
        ``mask`` [..., 1]: residues to update (1) or freeze (0).
        """
        if mask is not None:
            update = update * mask
        vec_quat = torch.cat(
            [torch.ones_like(update[..., :1]), update[..., :3]], dim=-1
        )
        new_quat = so3.quat_normalize(so3.quat_multiply(self.quat, vec_quat))
        trans_update = torch.einsum(
            "...ij,...j->...i", self.rotmat(), update[..., 3:]
        )
        return Rigid(new_quat, self.trans + trans_update)

    def scale_translation(self, factor) -> "Rigid":
        return Rigid(self.quat, self.trans * factor)

    def unsqueeze(self, dim: int) -> "Rigid":
        d = dim if dim >= 0 else dim - 1
        return Rigid(self.quat.unsqueeze(d), self.trans.unsqueeze(d))
