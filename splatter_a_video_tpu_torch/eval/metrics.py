"""Image-quality metrics: PSNR, SSIM, MS-SSIM (counterpart of
`splatter_a_video_tpu/eval/metrics.py`).

numpy images in, Python floats out; PSNR and the SSIMs computed on the CPU
with the port's `train/losses.psnr` and `ops/ssim.ssim`, LPIPS and the VGG
perceptual loss on `device` (the GPU unless told otherwise) with the VGG16
trunk of `eval/lpips.py`.
"""

from __future__ import annotations

from typing import Optional

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


def lpips(pred: np.ndarray, gt: np.ndarray, device="cuda") -> float:
    """LPIPS (VGG16 trunk and linear heads, `eval/lpips.py`). Pretrained
    weights when an `.npz` is present, else the deterministic random trunk:
    a relative distance, not comparable to published numbers; check
    `lpips_is_pretrained()` before quoting it against the paper's 0.2283."""
    from . import lpips as _lpips

    return _lpips.lpips_distance(pred, gt, device=device)


def lpips_is_pretrained(device="cuda") -> bool:
    from . import lpips as _lpips

    return _lpips.lpips_is_pretrained(device=device)


def vgg_perceptual_loss(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None,
                        device="cuda") -> float:
    """VGG16 perceptual loss as the reference's `VGGLoss` (the GAN-editing
    path): masked L1 on the ImageNet-normalised inputs plus masked L1 on the
    relu1_2 / relu2_2 / relu3_3 / relu4_3 taps, weighted 1/16, 1/8, 1/4, 1.
    The JAX docstring's "None without pretrained weights" is not what its
    code does: it always returns the value (random trunk included), and so
    does this one. The mask is resized to each tap as `jax.image.resize(...,
    "bilinear")` resizes it (antialiased when it shrinks).

    pred / gt: [H, W, 3] in [0, 1]; mask: optional [H, W] weights.
    """
    from ..nets.interp import jax_resize_bilinear
    from . import lpips as _lpips

    model = _lpips.get_model(device=device)
    dev = model.device
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    xa = torch.as_tensor((np.asarray(pred, np.float32) - mean) / std, device=dev)[None].permute(0, 3, 1, 2)
    xb = torch.as_tensor((np.asarray(gt, np.float32) - mean) / std, device=dev)[None].permute(0, 3, 1, 2)
    m = None if mask is None else torch.as_tensor(np.asarray(mask, np.float32), device=dev)

    def masked_l1(a, b):   # NCHW
        d = torch.abs(a - b)
        if m is None:
            return torch.mean(d)
        m_r = jax_resize_bilinear(m, d.shape[2], d.shape[3])[None, None]
        return torch.sum(d * m_r) / (torch.sum(m_r) * d.shape[1] + 1e-8)

    weights = [1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0]   # relu5_3 unused by the reference's vgg16 path
    fa = _lpips.vgg_raw_taps(model, xa.permute(0, 2, 3, 1))
    fb = _lpips.vgg_raw_taps(model, xb.permute(0, 2, 3, 1))
    loss = float(masked_l1(xa, xb))
    for wgt, a, b in zip(weights, fa[:4], fb[:4]):
        loss += wgt * float(masked_l1(a, b))
    return loss
