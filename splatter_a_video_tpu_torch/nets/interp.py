"""Image resizing with torch `F.interpolate` semantics as dense matmuls
(counterpart of `splatter_a_video_tpu/nets/interp.py`).

Bilinear (both align_corners modes) and bicubic (Keys a = -0.75) resizes
are separable: each axis is one [out, in] weight matrix, built in numpy
(border-replicate, as `F.interpolate`) and applied as a matmul, the JAX
package's formulation, so both packages resize with the same weights.
`jax_bilinear_matrix` is the weight matrix of `jax.image.resize(...,
"bilinear")`, antialiased (a triangle kernel widened by the scale) when it
shrinks, which `F.interpolate` is not.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _source_coords(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    o = np.arange(n_out, dtype=np.float64)
    if align_corners:
        if n_out == 1:
            return np.zeros(1)
        return o * (n_in - 1) / (n_out - 1)
    return (o + 0.5) * (n_in / n_out) - 0.5


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution weights (torch uses Keys a = -0.75)."""
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
        np.where(at < 2.0, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


@lru_cache(maxsize=256)
def resize_matrix(n_in: int, n_out: int, mode: str = "bilinear", align_corners: bool = False) -> np.ndarray:
    """[n_out, n_in] float32 interpolation matrix (border-replicate)."""
    x = _source_coords(n_in, n_out, align_corners)
    if mode == "bilinear":
        if not align_corners:
            x = np.maximum(x, 0.0)   # torch clamps the source index at 0 for linear modes
        i0 = np.floor(x).astype(np.int64)
        f = x - i0
        idx = np.stack([i0, i0 + 1], axis=1)
        wts = np.stack([1.0 - f, f], axis=1)
    elif mode == "bicubic":
        i0 = np.floor(x).astype(np.int64)
        f = x - i0
        offs = np.array([-1, 0, 1, 2])
        idx = i0[:, None] + offs[None, :]
        wts = _cubic_kernel(f[:, None] - offs[None, :])
    else:
        raise ValueError(f"unknown mode {mode}")
    idx = np.clip(idx, 0, n_in - 1)
    M = np.zeros((n_out, n_in), np.float64)
    np.add.at(M, (np.repeat(np.arange(n_out), idx.shape[1]), idx.ravel()), wts.ravel())
    return M.astype(np.float32)


@lru_cache(maxsize=64)
def jax_bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of `jax.image.resize(..., "bilinear")`
    along one axis (antialias on): a triangle kernel, widened by
    n_in / n_out when shrinking, normalised per output sample."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return w.T.astype(np.float32)


@lru_cache(maxsize=256)
def _matrix(build, device: torch.device, *key) -> torch.Tensor:
    """`build(*key)` as a tensor on `device`, made once per device."""
    return torch.from_numpy(build(*key)).to(device)


def resize_hw(x: torch.Tensor, out_h: int, out_w: int, mode: str = "bilinear",
              align_corners: bool = False) -> torch.Tensor:
    """Resize [..., H, W] (the last two axes, NCHW) to [..., out_h, out_w]."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    Mh = _matrix(resize_matrix, x.device, h, out_h, mode, align_corners)
    Mw = _matrix(resize_matrix, x.device, w, out_w, mode, align_corners)
    return torch.matmul(torch.matmul(Mh, x), Mw.T)


def interp2d(x: torch.Tensor, out_h: int, out_w: int, mode: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize [..., H, W, C] (channels last, the JAX layout) to
    [..., out_h, out_w, C], torch semantics."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    return resize_hw(x.movedim(-1, -3), out_h, out_w, mode, align_corners).movedim(-3, -1)


def jax_resize_bilinear(m: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """`jax.image.resize(m, (out_h, out_w), "bilinear")` of a [H, W] map."""
    Mh = _matrix(jax_bilinear_matrix, m.device, m.shape[0], out_h)
    Mw = _matrix(jax_bilinear_matrix, m.device, m.shape[1], out_w)
    return Mh @ m @ Mw.T
