"""Visualization helpers: depth colorization, flow coloring, track drawing
(counterpart of `splatter_a_video_tpu/utils/vis.py`). Pure numpy: these
feed logging and video export, not the compute path. `write_video` imports
`imageio` only when called.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def colorize_depth(
    depth: np.ndarray,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    invert: bool = True,
) -> np.ndarray:
    """Depth [H, W] -> turbo-ish RGB [H, W, 3] in [0, 1]."""
    d = np.asarray(depth, np.float32)
    vmin = float(np.nanmin(d)) if vmin is None else vmin
    vmax = float(np.nanmax(d)) if vmax is None else vmax
    x = np.clip((d - vmin) / max(vmax - vmin, 1e-8), 0, 1)
    if invert:
        x = 1.0 - x
    # compact turbo approximation
    r = np.clip(1.6 * x - 0.2, 0, 1)
    g = np.clip(1.8 - np.abs(2.4 * x - 1.2), 0, 1)
    b = np.clip(1.4 - 1.6 * x, 0, 1)
    return np.stack([r, g, b], axis=-1)


def flow_to_image(flow: np.ndarray, max_mag: Optional[float] = None) -> np.ndarray:
    """Optical flow [H, W, 2] -> HSV-wheel RGB [H, W, 3] in [0, 1]."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx**2 + fy**2)
    ang = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)  # [0,1)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    val = np.clip(mag / max_mag, 0, 1)
    # hsv -> rgb with s=1
    h6 = ang * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = np.zeros_like(val)
    q = val * (1 - f)
    t = val * f
    lut = [
        (val, t, p), (q, val, p), (p, val, t),
        (p, q, val), (t, p, val), (val, p, q),
    ]
    r = np.choose(i, [c[0] for c in lut])
    g = np.choose(i, [c[1] for c in lut])
    b = np.choose(i, [c[2] for c in lut])
    return np.stack([r, g, b], axis=-1)


def draw_tracks_2d(
    img: np.ndarray,
    tracks: np.ndarray,
    radius: int = 1,
    tail: int = 8,
) -> np.ndarray:
    """Overlay point tracks on an image.

    Args:
      img: [H, W, 3] in [0, 1].
      tracks: [N, T, 2] pixel trajectories; the last time step is "now".
    Returns the composited image.
    """
    out = np.asarray(img, np.float32).copy()
    H, W = out.shape[:2]
    N, T, _ = tracks.shape
    colors = _track_colors(N)
    t0 = max(0, T - tail)
    for n in range(N):
        for t in range(t0, T):
            x, y = tracks[n, t]
            if not (0 <= x < W and 0 <= y < H):
                continue
            fade = 0.3 + 0.7 * (t - t0 + 1) / (T - t0)
            _dot(out, int(round(x)), int(round(y)), radius, colors[n] * fade)
    return out


def _track_colors(n: int) -> np.ndarray:
    h = (np.arange(n) * 0.61803398875) % 1.0
    return flow_to_image(
        np.stack([np.cos(2 * np.pi * h), np.sin(2 * np.pi * h)], -1)[None]
    )[0]


def _dot(img: np.ndarray, x: int, y: int, r: int, color: np.ndarray) -> None:
    H, W = img.shape[:2]
    y0, y1 = max(0, y - r), min(H, y + r + 1)
    x0, x1 = max(0, x - r), min(W, x + r + 1)
    img[y0:y1, x0:x1] = color


def draw_matches(
    img1: np.ndarray,
    img2: np.ndarray,
    px1: np.ndarray,
    px2: np.ndarray,
    num: int = 40,
) -> np.ndarray:
    """Side-by-side correspondence visualization: img pair stacked
    horizontally with lines px1[i] -> px2[i] (+W offset)."""
    H = max(img1.shape[0], img2.shape[0])
    W1, W2 = img1.shape[1], img2.shape[1]
    canvas = np.zeros((H, W1 + W2, 3), np.float32)
    canvas[: img1.shape[0], :W1] = img1
    canvas[: img2.shape[0], W1:] = img2
    n = min(num, len(px1))
    idx = np.linspace(0, len(px1) - 1, n).astype(int)
    colors = _track_colors(n)
    for c, i in enumerate(idx):
        x1, y1 = px1[i]
        x2, y2 = px2[i]
        _line(canvas, float(x1), float(y1), float(x2) + W1, float(y2), colors[c])
        _dot(canvas, int(round(x1)), int(round(y1)), 1, colors[c])
        _dot(canvas, int(round(x2)) + W1, int(round(y2)), 1, colors[c])
    return canvas


def _line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float, color) -> None:
    H, W = img.shape[:2]
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    for s in range(steps + 1):
        t = s / steps
        x = int(round(x0 + (x1 - x0) * t))
        y = int(round(y0 + (y1 - y0) * t))
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = color


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 8) -> None:
    """uint8-ify and write a video; frames in [0, 1]. Falls back to GIF then
    per-frame PNGs when no mp4 backend (ffmpeg) is available."""
    import imageio.v2 as imageio

    arr = [np.clip(np.asarray(f) * 255, 0, 255).astype(np.uint8) for f in frames]
    try:
        imageio.mimwrite(path, arr, fps=fps)
        return
    except Exception:
        pass
    try:
        gif = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimwrite(gif, arr, duration=int(1000 / max(fps, 1)))
        return
    except Exception:
        pass
    import os

    d = path.rsplit(".", 1)[0] + "_frames"
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(arr):
        imageio.imwrite(os.path.join(d, f"{i:05d}.png"), f)
