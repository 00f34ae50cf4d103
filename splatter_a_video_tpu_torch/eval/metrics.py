"""Image-quality metrics: PSNR, SSIM, MS-SSIM (counterpart of
`splatter_a_video_tpu/eval/metrics.py`).

numpy images in, Python floats out; computed on the CPU with the port's
`train/losses.psnr` and `ops/ssim.ssim`. LPIPS and the VGG perceptual loss
need the preprocessing networks and come with them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ssim import ssim as _ssim
from ..train.losses import psnr as _psnr


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))   # float32, as JAX takes numpy


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(_psnr(_t(pred), _t(gt)))


def ssim(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(_ssim(_t(pred), _t(gt)))


def ms_ssim(pred: np.ndarray, gt: np.ndarray, levels: int = 3) -> float:
    """Multi-scale SSIM: a downsample-by-2 pyramid with uniform level weights."""
    p, g = _t(pred), _t(gt)
    vals = []
    for _ in range(levels):
        vals.append(float(_ssim(p, g)))
        if min(p.shape[0], p.shape[1]) < 22:
            break
        p = (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]) / 4.0
        g = (g[0::2, 0::2] + g[1::2, 0::2] + g[0::2, 1::2] + g[1::2, 1::2]) / 4.0
    return float(np.mean(vals))
