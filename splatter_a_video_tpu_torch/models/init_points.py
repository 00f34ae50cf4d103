"""Point-cloud initialisation (counterpart of
`splatter_a_video_tpu/models/init_points.py`): host-side numpy, copied so
the port needs nothing of the JAX package."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def positive_z_random(num_points: int, radius: float = 1.0, z_shift: float = 1.0,
                      rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """[N, 3] uniform points, x, y in [-r, r] and z in [z_shift - r/2,
    z_shift + r/2]: inside the canonical ortho frustum."""
    rng = rng or np.random.RandomState(0)
    xy = rng.uniform(-radius, radius, (num_points, 2))
    z = rng.uniform(z_shift - radius / 2, z_shift + radius / 2, (num_points, 1))
    return np.concatenate([xy, z], axis=1).astype(np.float32)


def depth_to_points(depth: np.ndarray, image: Optional[np.ndarray] = None,
                    mask: Optional[np.ndarray] = None, stride: int = 5, shift: float = 0.1,
                    noise: float = 0.0, rng: Optional[np.random.RandomState] = None,
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Unproject a depth map on the pixel grid to canonical-frustum points,
    keeping every `stride`-th masked pixel: (points [N, 3], colours or None)."""
    rng = rng or np.random.RandomState(0)
    h, w = depth.shape
    d = depth.astype(np.float32) + shift
    if noise > 0:
        d = d + rng.randn(h, w).astype(np.float32) * noise
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = (j - w * 0.5) / (0.5 * w)
    y = (i - h * 0.5) / (0.5 * h)
    pcd = np.stack([x, y, d], axis=-1).astype(np.float32)
    keep = np.ones((h, w), bool) if mask is None else mask.astype(bool)
    pts = pcd[keep][::stride]
    cols = None if image is None else image[keep][::stride].astype(np.float32)
    return pts, cols
