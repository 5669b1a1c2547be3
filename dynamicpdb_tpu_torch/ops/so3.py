"""SO(3) primitives on tensors: quaternion / rotation-matrix / rotation-vector
conversions and Lie-group maps.

Port of ``dynamicpdb_tpu/ops/so3.py``. Shape-polymorphic over leading batch
dims, branch-free, guarded at the angle -> 0 and angle -> pi limits.
Quaternions are [w, x, y, z], scalar first.
"""
from __future__ import annotations

import math

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2, scalar-first."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a (possibly non-unit) quaternion: conj(q) / |q|^2."""
    return quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix [..., 3, 3]."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion; branch-free Shepperd method."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidates, each scaled by 4*q_i^2 (positive in its own case)
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)

    # argmax returns the first maximum, as jnp.argmax does
    case = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)[..., None]
    q = torch.where(
        case == 0, qw,
        torch.where(case == 1, qx, torch.where(case == 2, qy, qz)),
    )
    return quat_normalize(q)


def rotvec_to_quat(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> unit quaternion, stable at |v| -> 0 via sinc."""
    angle = torch.linalg.norm(v, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = 0.5 * torch.sinc(half / math.pi)  # sin(half) / angle
    return torch.cat([torch.cos(half), k * v], dim=-1)


def quat_to_rotvec(q: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Unit quaternion -> axis-angle vector.

    Sign-flip so w >= 0 (angle in [0, pi]), angle = 2 atan2(|xyz|, w), with
    the small-angle Taylor branch below 1e-3: this function defines the
    rotation-score targets, so the branch point stays where the JAX package
    (``ops/so3.py:105``) and the reference put it.
    """
    flip = (q[..., :1] < 0).to(q.dtype)
    q = (1 - 2 * flip) * q
    im_norm = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2 * torch.atan2(im_norm, q[..., 0])
    angle2 = angle * angle
    small_scale = 2 + angle2 / 12 + 7 * angle2 * angle2 / 2880
    large_scale = angle / torch.sin(angle / 2 + eps)
    scale = torch.where(angle <= 1e-3, small_scale, large_scale)
    return scale[..., None] * q[..., 1:]


def compose_rotvec(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """rotvec of R(r1) @ R(r2) (right-multiplied composition)."""
    return quat_to_rotvec(quat_multiply(rotvec_to_quat(r1), rotvec_to_quat(r2)))
