"""SE(3) / SO(3) exponential maps and pose helpers (counterpart of
`splatter_a_video_tpu/utils/pose.py`): the twist parameterisation behind
camera refinement, and COLMAP quaternion conversions. Differentiable,
also at the identity.
"""

from __future__ import annotations

import torch

from ..ops.quaternion import quat_to_rotmat, rotmat_to_quat


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _exp_coeffs(theta2: torch.Tensor):
    """Rodrigues coefficients A = sin(th)/th, B = (1 - cos(th))/th^2 and
    C = (th - sin(th))/th^3 on the unnormalised skew matrix, with Taylor
    branches below th^2 = 1e-8. The exact branch divides by `th2_safe`,
    which is 1 where the Taylor branch is taken: refinement starts at
    xi = 0, and a `where` whose untaken branch divides by th would give
    NaN gradients there."""
    small = theta2 < 1e-8
    th2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(th2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / th2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (th2_safe * theta))
    return A, B, C


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    A, B, _ = _exp_coeffs(theta2)
    K = hat(w)
    return _eye_like(K) + A * K + B * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [..., 6] = (v, w) -> [..., 4, 4] rigid transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    A, B, C = _exp_coeffs(theta2)
    K = hat(w)
    K2 = K @ K
    eye = _eye_like(K)
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = xi.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def qvec2rotmat(q: torch.Tensor) -> torch.Tensor:
    """COLMAP-convention quaternion (w,x,y,z) -> rotation matrix."""
    return quat_to_rotmat(q)


def rotmat2qvec(R: torch.Tensor) -> torch.Tensor:
    return rotmat_to_quat(R)


def apply_se3_to_extrinsic(extr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-compose a twist onto a [3,4] world->camera extrinsic."""
    T = se3_exp(xi)
    E = torch.cat([extr, extr.new_tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)
    return (T @ E)[:3]
