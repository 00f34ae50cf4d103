"""Cameras (a copy of `splatter_a_video_tpu/models/camera.py`'s numpy
cameras; the port keeps its own so it imports nothing of the JAX package).

OpenCV camera axes (x right, y down, z forward); extrinsic = world->camera
[R|t]; intrinsic = (fx, fy, cx, cy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclass(frozen=True)
class Camera:
    """Minimal pinhole/ortho camera. R: [3,3] world->cam rotation; t: [3]."""

    width: int
    height: int
    R: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    t: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    fovx: float = math.pi / 2.0
    fovy: Optional[float] = None

    @property
    def extrinsic(self) -> np.ndarray:
        """[3, 4] world->camera matrix."""
        return np.concatenate(
            [self.R.astype(np.float32), self.t.reshape(3, 1).astype(np.float32)], axis=1
        )

    @property
    def focal_x(self) -> float:
        return fov2focal(self.fovx, self.width)

    @property
    def focal_y(self) -> float:
        fovy = self.fovy if self.fovy is not None else focal2fov(self.focal_x, self.height)
        return fov2focal(fovy, self.height)

    @property
    def intrinsic(self) -> np.ndarray:
        """(fx, fy, cx, cy)."""
        return np.array(
            [self.focal_x, self.focal_y, self.width / 2.0, self.height / 2.0],
            dtype=np.float32,
        )

    @property
    def camera_center(self) -> np.ndarray:
        return (-self.R.T @ self.t).astype(np.float32)

    def with_pose(self, R: np.ndarray, t: np.ndarray) -> "Camera":
        return Camera(self.width, self.height, np.asarray(R, np.float32),
                      np.asarray(t, np.float32), self.fovx, self.fovy)


def canonical_camera(width: int, height: int) -> Camera:
    """Identity-pose, fovx = pi/2 canonical camera."""
    return Camera(width=width, height=height)


def look_at_rotation(
    camera_position: np.ndarray,
    at: np.ndarray = np.zeros(3),
    up: np.ndarray = np.array([0.0, -1.0, 0.0]),
) -> np.ndarray:
    """World->camera rotation looking from `camera_position` toward `at`;
    rows are the camera axes in world coordinates."""
    z = at - camera_position
    z = z / (np.linalg.norm(z) + 1e-9)
    x = np.cross(up, z)
    n = np.linalg.norm(x)
    if n < 1e-6:  # looking along up: pick an arbitrary right vector
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / n
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0).astype(np.float32)


def orbit_cameras(
    base: Camera,
    num_views: int,
    radius: float = 0.15,
    at: Tuple[float, float, float] = (0.0, 0.0, 1.0),
) -> Tuple[Camera, ...]:
    """Small circular orbit around the canonical axis for novel views."""
    at = np.asarray(at, np.float32)
    cams = []
    for i in range(num_views):
        ang = 2.0 * math.pi * i / max(num_views, 1)
        pos = np.array([radius * math.cos(ang), radius * math.sin(ang), 0.0], np.float32)
        R = look_at_rotation(pos, at)
        cams.append(base.with_pose(R, -R @ pos))
    return tuple(cams)


def spiral_path(
    base: Camera, num: int, radius: float = 0.1, zrad: float = 0.05,
    at: Tuple[float, float, float] = (0.0, 0.0, 1.0),
) -> Tuple[Camera, ...]:
    """Spiral orbit: an xy circle with a z oscillation, looking at `at`."""
    at = np.asarray(at, np.float32)
    cams = []
    for i in range(num):
        ang = 2 * math.pi * i / max(num, 1)
        pos = np.array([radius * math.cos(ang), radius * math.sin(ang), zrad * math.sin(2 * ang)], np.float32)
        R = look_at_rotation(pos, at)
        cams.append(base.with_pose(R, -R @ pos))
    return tuple(cams)


def stereo_cameras(base: Camera, baseline: float = 0.06,
                   at: Tuple[float, float, float] = (0.0, 0.0, 1.0)) -> Tuple[Camera, Camera]:
    """Left/right eye pair for anaglyph stereo."""
    at = np.asarray(at, np.float32)
    cams = []
    for sx in (-0.5, 0.5):
        pos = np.array([sx * baseline, 0.0, 0.0], np.float32)
        R = look_at_rotation(pos, at)
        cams.append(base.with_pose(R, -R @ pos))
    return cams[0], cams[1]
