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


def rotmat_to_quat(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z). [..., 3, 3] -> [..., 4].

    Shepperd's construction without branches, as in the JAX package: all
    four candidates are formed and the best-conditioned one is selected.
    """
    m = R
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    floor = lambda x: torch.sqrt(torch.clamp_min(x, eps)) * 2.0
    s0 = floor(t + 1.0)
    c0 = torch.stack([0.25 * s0, (m[..., 2, 1] - m[..., 1, 2]) / s0,
                      (m[..., 0, 2] - m[..., 2, 0]) / s0, (m[..., 1, 0] - m[..., 0, 1]) / s0], dim=-1)
    s1 = floor(1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2])
    c1 = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s1, 0.25 * s1,
                      (m[..., 0, 1] + m[..., 1, 0]) / s1, (m[..., 0, 2] + m[..., 2, 0]) / s1], dim=-1)
    s2 = floor(1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2])
    c2 = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / s2, (m[..., 0, 1] + m[..., 1, 0]) / s2,
                      0.25 * s2, (m[..., 1, 2] + m[..., 2, 1]) / s2], dim=-1)
    s3 = floor(1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2])
    c3 = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / s3, (m[..., 0, 2] + m[..., 2, 0]) / s3,
                      (m[..., 1, 2] + m[..., 2, 1]) / s3, 0.25 * s3], dim=-1)
    # argmax takes the first of equal maxima, as jnp.argmax does
    best = torch.argmax(torch.stack([t, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1), dim=-1)[..., None]
    out = torch.where(best == 0, c0, torch.where(best == 1, c1, torch.where(best == 2, c2, c3)))
    return quat_normalize(out)


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
