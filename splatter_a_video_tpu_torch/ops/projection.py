"""Camera projection + EWA covariance projection (counterpart of
`splatter_a_video_tpu/ops/projection.py`).

Point-wise over Gaussians. Culled Gaussians are zeroed rather than
compacted, as in the JAX package. `extr` is the [3,4] world->camera
matrix, `intr` is (fx, fy, cx, cy), `uv` is in pixels with the
reference's -0.5 offset, and tiles are `block` = bx x by pixels.

The integer outputs (radius, tiles, tile rects) are computed with the same
float expressions as the JAX package so they come out identical.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import blocking_to

BLOCK = 16


def _block_xy(block) -> Tuple[int, int]:
    if isinstance(block, tuple):
        return block
    return (block, block)


def tile_grid(W: int, H: int, block=BLOCK) -> Tuple[int, int]:
    """Number of tiles along (x, y)."""
    bx, by = _block_xy(block)
    return (-(-W // bx), -(-H // by))


def _culled(uv, depth_mask, W, H, extent):
    wh = blocking_to([W, H], uv.device, uv.dtype)
    lo = (1.0 - extent) * wh * 0.5
    hi = (1.0 + extent) * wh * 0.5
    return depth_mask | torch.any((uv < lo) | (uv > hi), dim=-1)


def project_ortho(xyz, extr, W: int, H: int, nearest: float = 0.01, extent: float = 1.3):
    """uv = ((R x + t)_xy + 1) * (W, H) / 2 - 0.5, depth = (R x + t)_z.

    Points with depth <= nearest or uv beyond `extent` times the image
    half-size get uv = 0 and depth = 0. Returns (uv [N,2], depth [N]).
    """
    R = extr[:3, :3]
    t = extr[:3, 3]
    pt_cam = xyz @ R.T + t
    wh = blocking_to([W, H], xyz.device, xyz.dtype)
    uv = (pt_cam[:, :2] + 1.0) * wh * 0.5 - 0.5
    depth = torch.nan_to_num(pt_cam[:, 2])
    culled = _culled(uv, depth <= nearest, W, H, extent)
    uv = torch.where(culled[:, None], 0.0, uv)
    depth = torch.where(culled, 0.0, depth)
    return uv, depth


def project_persp(xyz, intr, extr, W: int, H: int, nearest: float = 0.2, extent: float = 1.3):
    """Pinhole projection, same culling-to-zero convention as `project_ortho`."""
    R = extr[:3, :3]
    t = extr[:3, 3]
    pt_cam = xyz @ R.T + t
    z = pt_cam[:, 2]
    inv_z = 1.0 / (z + 1e-7)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    u = fx * pt_cam[:, 0] * inv_z + cx - 0.5
    v = fy * pt_cam[:, 1] * inv_z + cy - 0.5
    uv = torch.stack([u, v], dim=-1)
    near_mask = (z <= nearest) if nearest > 0 else torch.zeros_like(z, dtype=torch.bool)
    if extent > 0:
        culled = _culled(uv, near_mask, W, H, extent)
    else:
        culled = near_mask
    uv = torch.where(culled[:, None], 0.0, uv)
    depth = torch.where(culled, 0.0, z)
    return uv, depth


def max_radius_for_tile_cap(max_tiles: int, block) -> float:
    """Largest pixel radius whose tile rect is guaranteed <= max_tiles."""
    bx, by = _block_xy(block)
    span = int(max(max_tiles, 9) ** 0.5)
    return max((span - 2) * min(bx, by) / 2.0, float(min(bx, by)))


def _finish_cov2d(
    cov2d_00, cov2d_01, cov2d_11, uv, W: int, H: int, visible, block,
    max_radius=None, rect_mode: str = "tight", opacity=None,
):
    """Blur, conic, radius and tile rect, shared by both EWA paths.

    +0.3 px low-pass on the diagonal, eigenvalue discriminant floored at
    0.1, radius = ceil(3 sqrt(lambda_max)). `rect_mode` "disc" is the
    reference's square rect of half-size `radius`; "tight" is the AABB of
    the blurred ellipse at t = min(3, sqrt(2 ln(255 op))) sigma (opacity-
    aware when `opacity` is given). `max_radius` clamps both symmetrically;
    rects are clamped to the tile grid. Returns (conic [N,3], radius [N]
    i32, tiles [N] i32, tile_min [N,2] i32, tile_max [N,2] i32).
    """
    a = cov2d_00 + 0.3
    b = cov2d_01
    c = cov2d_11 + 0.3
    det = a * c - b * b
    det_mask = det != 0.0
    det_safe = torch.where(det_mask, det, 1.0)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam_max = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))
    if max_radius is not None:
        radius = torch.clamp_max(radius, max_radius)

    if rect_mode == "tight":
        t_fac = 3.0
        if opacity is not None:
            t_fac = torch.clamp_max(
                torch.sqrt(torch.clamp_min(2.0 * torch.log(255.0 * opacity), 0.0)), 3.0
            )
        rx = torch.ceil(t_fac * torch.sqrt(torch.clamp_min(a, 0.0)))
        ry = torch.ceil(t_fac * torch.sqrt(torch.clamp_min(c, 0.0)))
        if max_radius is not None:
            rx = torch.clamp_max(rx, max_radius)
            ry = torch.clamp_max(ry, max_radius)
        r2 = torch.stack([rx, ry], dim=-1)
    elif rect_mode == "disc":
        r2 = radius[:, None]
    else:
        raise ValueError(f"rect_mode must be 'tight' or 'disc', got {rect_mode!r}")

    bx, by = _block_xy(block)
    tgx, tgy = tile_grid(W, H, block)
    tb = blocking_to([tgx, tgy], uv.device, torch.int32)
    bvec = blocking_to([bx, by], uv.device, uv.dtype)
    zero = torch.zeros_like(tb)
    tile_min = torch.clamp(torch.floor((uv - r2) / bvec).to(torch.int32), zero, tb)
    tile_max = torch.clamp(torch.floor((uv + r2 + (bvec - 1)) / bvec).to(torch.int32), zero, tb)
    span = tile_max - tile_min
    tiles = span[:, 0] * span[:, 1]

    mask = (tiles != 0) & det_mask & visible
    conic = torch.nan_to_num(conic) * mask[:, None]
    radius = (torch.nan_to_num(radius) * mask).to(torch.int32)
    tiles = (tiles * mask).to(torch.int32)
    tile_min = tile_min * mask[:, None]
    tile_max = tile_max * mask[:, None]
    return conic, radius, tiles, tile_min, tile_max


def _quad(u, v, cov3d):
    """u^T Sigma v for the 6-vector Sigma; u, v index as [..., 3]."""
    return (
        u[..., 0] * v[..., 0] * cov3d[:, 0]
        + (u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0]) * cov3d[:, 1]
        + (u[..., 0] * v[..., 2] + u[..., 2] * v[..., 0]) * cov3d[:, 2]
        + u[..., 1] * v[..., 1] * cov3d[:, 3]
        + (u[..., 1] * v[..., 2] + u[..., 2] * v[..., 1]) * cov3d[:, 4]
        + u[..., 2] * v[..., 2] * cov3d[:, 5]
    )


def ewa_ortho(
    cov3d, extr, uv, W: int, H: int, visible, block=BLOCK,
    max_radius=None, rect_mode: str = "tight", opacity=None,
):
    """Orthographic EWA: cov2d = (J R) Sigma (J R)^T with J = diag(W/2, H/2)."""
    R = extr[:3, :3]
    t0 = (W / 2.0) * R[0]
    t1 = (H / 2.0) * R[1]
    c00 = _quad(t0, t0, cov3d)
    c01 = _quad(t0, t1, cov3d)
    c11 = _quad(t1, t1, cov3d)
    return _finish_cov2d(c00, c01, c11, uv, W, H, visible, block, max_radius, rect_mode, opacity)


def ewa_persp(
    xyz, cov3d, intr, extr, uv, W: int, H: int, visible, block=BLOCK,
    max_radius=None, rect_mode: str = "tight", opacity=None,
):
    """Perspective EWA: J = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]] at
    the camera-space point, no FoV clamping."""
    R = extr[:3, :3]
    t = extr[:3, 3]
    p = xyz @ R.T + t
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z = torch.where(z == 0, 1e-7, z)
    fx, fy = intr[0], intr[1]
    rz = 1.0 / z
    rz2 = rz * rz
    t0 = fx * rz[:, None] * R[0][None, :] - (fx * x * rz2)[:, None] * R[2][None, :]
    t1 = fy * rz[:, None] * R[1][None, :] - (fy * y * rz2)[:, None] * R[2][None, :]
    c00 = _quad(t0, t0, cov3d)
    c01 = _quad(t0, t1, cov3d)
    c11 = _quad(t1, t1, cov3d)
    return _finish_cov2d(c00, c01, c11, uv, W, H, visible, block, max_radius, rect_mode, opacity)
