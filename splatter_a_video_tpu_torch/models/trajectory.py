"""Per-Gaussian trajectory bases (counterpart of
`splatter_a_video_tpu/models/trajectory.py`): polynomial + Fourier,
linear-blend skinning, and cubic splines. Evaluation only; the JAX
stop-gradients become `.detach()`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

POLY_DIM = 4
FOURIER_DIM = 8


def _time(t_norm, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t_norm, dtype=torch.float32, device=like.device)


def poly_fourier_basis(t_norm: torch.Tensor, poly_dim: int = POLY_DIM, fourier_dim: int = FOURIER_DIM):
    """(poly [poly_dim] = t^k, fourier [fourier_dim] = [cos(l pi t)..., sin(l pi t)...],
    l = 1..fourier_dim/2) at normalised time t in [0, 1]."""
    dev = t_norm.device
    k = torch.arange(poly_dim, dtype=torch.float32, device=dev)
    poly = torch.pow(t_norm, k)
    l = torch.arange(fourier_dim // 2, dtype=torch.float32, device=dev) + 1.0
    fourier = torch.cat([torch.cos(t_norm * l * math.pi), torch.sin(t_norm * l * math.pi)])
    return poly, fourier


def poly_fourier_offset(poly_feat: torch.Tensor, fourier_feat: torch.Tensor, t_norm) -> torch.Tensor:
    """sum_k poly_k t^k + sum_l (a_l cos + b_l sin): [N,P,C] + [N,F,C] -> [N,C]."""
    poly, fourier = poly_fourier_basis(_time(t_norm, poly_feat), poly_feat.shape[1], fourier_feat.shape[1])
    return torch.einsum("npc,p->nc", poly_feat, poly) + torch.einsum("nfc,f->nc", fourier_feat, fourier)


def position_poly_fourier(position, pos_poly_feat, pos_fourier_feat, t_norm, detach_pos: bool = False):
    """Centre trajectory: base + poly/Fourier offset."""
    base = position.detach() if detach_pos else position
    return base + poly_fourier_offset(pos_poly_feat, pos_fourier_feat, t_norm)


def rotation_poly_fourier(rotation, rot_poly_feat, rot_fourier_feat, t_norm):
    """Unnormalised quaternion trajectory; the time-varying delta is detached
    (the reference's `.detach()`), so only the base quaternion trains."""
    return rotation + poly_fourier_offset(rot_poly_feat, rot_fourier_feat, t_norm).detach()


def position_lbs(position, skin_logits, bone_poly, bone_fourier, t_norm, detach_pos: bool = False):
    """x_i(t) = x_i + sum_k softmax(w_i)_k * bone_k(t) with K translation bones."""
    base = position.detach() if detach_pos else position
    bone_off = poly_fourier_offset(bone_poly, bone_fourier, t_norm)  # [K, 3]
    return base + torch.softmax(skin_logits, dim=-1) @ bone_off


def spline_knots(num_frames: int, frames_per_knot: int = 5) -> np.ndarray:
    """Normalised knots: ceil(T/5) intervals at truncated-linspace frames."""
    interval_num = -(-num_frames // frames_per_knot)
    idx = np.linspace(0, num_frames - 1, interval_num + 1).astype(np.int64)
    return (idx / (num_frames - 1)).astype(np.float32)


def fit_cubic_spline(track_seq: np.ndarray, frames_per_knot: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Fit per-point cubic splines to 3D tracks [T, N, 3] (host, scipy).

    Returns (coeff [N, 4, M, 3], knots [M+1]); coeff[:, k, i] multiplies
    (t - knot_i)^(3-k), scipy's `CubicSpline.c` layout, fitted on the delta
    from the frame-0 positions.
    """
    from scipy.interpolate import CubicSpline

    T = track_seq.shape[0]
    delta = track_seq - track_seq[0][None]
    knots = spline_knots(T, frames_per_knot)
    idx = np.linspace(0, T - 1, len(knots)).astype(np.int64)
    cs = CubicSpline(knots, delta[idx], axis=0)
    coeff = np.transpose(cs.c, (2, 0, 1, 3)).astype(np.float32)
    return coeff, knots


def position_cubic_spline(position, coeff, knots, t_norm, detach_pos: bool = False):
    """Spline trajectory at normalised time t: interval from
    searchsorted(knots, t - 1e-7, left) - 1, clipped; cubic Horner on the offset."""
    t = _time(t_norm, position)
    i = torch.searchsorted(knots, (t - 1e-7).reshape(1), right=False) - 1
    i = i.clamp(0, coeff.shape[2] - 1)
    d = t - knots[i][0]
    c = torch.index_select(coeff, 2, i).squeeze(2)  # [N, 4, 3]
    offset = ((c[:, 0] * d + c[:, 1]) * d + c[:, 2]) * d + c[:, 3]
    base = position.detach() if detach_pos else position
    return base + offset
