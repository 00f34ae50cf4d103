"""Quaternion / 3D covariance math (counterpart of
`splatter_a_video_tpu/ops/quaternion.py`).

Point-wise over the Gaussian axis, so plain tensor code; gradients come
from autograd. Quaternions are (w, x, y, z); covariance 6-vectors are the
upper triangle (xx, xy, xz, yy, yz, zz).
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis. [..., 4] -> [..., 4]."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix. [..., 4] -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_cov3d(scaling: torch.Tensor, rotation: torch.Tensor, visible=None) -> torch.Tensor:
    """3D covariance 6-vector from scale [N,3] + quaternion [N,4] (any norm).

    Sigma = R S S^T R^T. Kept in the JAX package's scalar-channel form
    (not a batched 3x3 matmul) so the rounding matches it term by term.
    Rows with `visible` false are zeroed. Returns [N, 6].
    """
    rows = quat_to_rotmat(quat_normalize(rotation)).unbind(-2)
    (r00, r01, r02), (r10, r11, r12), (r20, r21, r22) = (r.unbind(-1) for r in rows)
    s0, s1, s2 = scaling[..., 0], scaling[..., 1], scaling[..., 2]
    v0, v1, v2 = s0 * s0, s1 * s1, s2 * s2
    cov6 = torch.stack(
        [
            r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2,
            r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2,
            r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2,
            r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2,
            r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2,
            r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2,
        ],
        dim=-1,
    )
    if visible is not None:
        cov6 = cov6 * visible.reshape(visible.shape[0], 1).to(cov6.dtype)
    return cov6


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(x / (1-x)), the inverse of the opacity activation."""
    return torch.log(x / (1.0 - x))
