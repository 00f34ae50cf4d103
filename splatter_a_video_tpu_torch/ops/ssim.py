"""SSIM / D-SSIM (counterpart of `splatter_a_video_tpu/ops/ssim.py`).

11x11 Gaussian window (sigma 1.5), zero padding, C1 = 0.01^2, C2 = 0.03^2,
channel-last images. The separable window is applied as two banded-matrix
products (B_H @ img @ B_W^T), the JAX package's form, so both packages sum
the same terms.

Precision is load-bearing: SSIM's variance terms blur(x^2) - mu^2 cancel
O(1) values down to O(1e-3), and reduced-precision products (bf16 on the
TPU, TF32 on Hopper) turn its gradient into noise (the JAX package
measured training PSNR 30 -> 18 before pinning full precision). The port
turns TF32 off at import (`splatter_a_video_tpu_torch/__init__.py`); keep
it off.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """[n, n] banded blur matrix on `device` (built once: at 854x480 the two
    matrices are 3.8 MB, too much to copy to the card at every call): row i
    holds the 1-D Gaussian centred at i, truncated at the borders (a
    zero-padded same convolution)."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    b = np.zeros((n, n), np.float32)
    half = window_size // 2
    for off, w in zip(range(-half, half + 1), g):
        b += np.diag(np.full(n - abs(off), w, np.float32), k=off)
    return torch.from_numpy(b).to(device)


def _blur(img: torch.Tensor, window_size: int, sigma: float = 1.5) -> torch.Tensor:
    """[N, H, W, C] separable same-padded Gaussian blur via two matmuls."""
    _, H, W, _ = img.shape
    bh = _band_matrix(H, window_size, sigma, img.device)
    bw = _band_matrix(W, window_size, sigma, img.device)
    out = torch.einsum("hH,nHwc->nhwc", bh, img)
    return torch.einsum("wW,nhWc->nhwc", bw, out)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity of channel-last images [H,W,C] or [N,H,W,C]:
    the scalar mean (or per-batch [N] when size_average is False)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    C1 = 0.01**2
    C2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def d_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """1 - SSIM, the structural dissimilarity loss term."""
    return 1.0 - ssim(img1, img2)
