"""LPIPS (Learned Perceptual Image Patch Similarity), counterpart of
`splatter_a_video_tpu/eval/lpips.py`.

The reference's vendored `lpips_pytorch`: a VGG16 conv trunk tapped after
relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, channel-unit-normalised
activations, squared differences through per-stage 1x1 linear heads,
spatially averaged and summed. Inputs are in the LPIPS [-1, 1] range,
z-scored with shift [-.030, -.088, -.188] and scale [.458, .448, .450].
Convolutions are `F.conv2d` in float32 (cuDNN TF32 off).

Weights, in this order:
  1. an `.npz` at `$SPLAT_LPIPS_WEIGHTS` or
     `splatter_a_video_tpu_torch/weights/lpips_vgg.npz` (the JAX package's
     `save_params` format: one file serves both packages);
  2. torch weights converted by `load_torch_params` (a torchvision
     `vgg16().features` state_dict and the LPIPS `vgg.pth` heads);
  3. `random_params(seed)`: the JAX package's deterministic He-initialised
     trunk. Random-feature LPIPS is a relative perceptual distance, not
     comparable to published LPIPS numbers; `Lpips.pretrained` says which
     one a caller got.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..nets.convert_util import ParamModule

# VGG16 `features` (torchvision indexing): conv channels per stage, "M" a
# 2x2 / 2 maxpool; the taps follow the relu closing each stage
VGG16_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
TAP_CHANNELS: Tuple[int, ...] = (64, 128, 256, 512, 512)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_STAGE_LAST = {1, 3, 6, 9, 12}   # the conv index closing each stage


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's deterministic He-initialised VGG16 trunk and
    |N(0, 1)| / sqrt(C) heads (numpy, same draws)."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}
    cin, i = 3, 0
    for c in VGG16_CFG:
        if c == "M":
            continue
        params[f"conv{i}_w"] = (rng.randn(3, 3, cin, c) * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((c,), np.float32)
        cin = c
        i += 1
    for s, c in enumerate(TAP_CHANNELS):
        params[f"lin{s}_w"] = (np.abs(rng.randn(c)) / np.sqrt(c)).astype(np.float32)
    return params


def load_torch_params(vgg_features_sd, lin_sd=None) -> Dict[str, np.ndarray]:
    """Torch weights in the JAX package's layout (HWIO kernels).

    vgg_features_sd: the state_dict of `torchvision.models.vgg16().features`
      (`{idx}.weight` [Cout, Cin, 3, 3] / `{idx}.bias`, the indices counting
      conv, relu and pool modules).
    lin_sd: the LPIPS v0.1 heads (`{s}.1.weight` [1, C, 1, 1]); None gives
      uniform 1 / C heads.
    """
    params: Dict[str, np.ndarray] = {}
    conv_i = torch_layer = 0
    for c in VGG16_CFG:
        if c == "M":
            torch_layer += 1
            continue
        w = np.asarray(vgg_features_sd[f"{torch_layer}.weight"], np.float32)
        b = np.asarray(vgg_features_sd[f"{torch_layer}.bias"], np.float32)
        if w.shape[0] != c or w.shape[2:] != (3, 3):
            raise ValueError(f"unexpected shape {w.shape} for conv{conv_i}")
        params[f"conv{conv_i}_w"] = np.transpose(w, (2, 3, 1, 0))   # OIHW -> HWIO
        params[f"conv{conv_i}_b"] = b
        conv_i += 1
        torch_layer += 2   # conv + relu
    for s, c in enumerate(TAP_CHANNELS):
        if lin_sd is not None:
            lw = np.asarray(lin_sd[f"{s}.1.weight"], np.float32).reshape(c)
            params[f"lin{s}_w"] = np.maximum(lw, 0.0)   # LPIPS heads are >= 0
        else:
            params[f"lin{s}_w"] = np.full((c,), 1.0 / c, np.float32)
    return params


def save_params(path: str, params: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def _vgg_forward(p, x: torch.Tensor, normalize: bool) -> List[torch.Tensor]:
    """x [N, H, W, 3] -> the 5 stage taps (NCHW), channel-unit-normalised
    when `normalize` (`BaseNet.forward`)."""
    x = x.permute(0, 3, 1, 2)
    taps, conv_i = [], 0
    for c in VGG16_CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.relu(F.conv2d(x, p[f"conv{conv_i}_w"].permute(3, 2, 0, 1), p[f"conv{conv_i}_b"], padding=1))
        if conv_i in _STAGE_LAST:
            taps.append(x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + 1e-10) if normalize else x)
        conv_i += 1
    return taps


class Lpips(ParamModule):
    """LPIPS as a module: `Lpips(params)(x, y)` -> [N] distances of x, y
    [N, H, W, 3] in [-1, 1]."""

    def __init__(self, params: Dict[str, np.ndarray], pretrained: bool = False):
        super().__init__(params)
        self.pretrained = pretrained

    @torch.no_grad()
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        p = self.params
        shift, scale = torch.from_numpy(_SHIFT).to(x.device), torch.from_numpy(_SCALE).to(x.device)
        fx = _vgg_forward(p, (x - shift) / scale, normalize=True)
        fy = _vgg_forward(p, (y - shift) / scale, normalize=True)
        total = 0.0
        for s, (a, b) in enumerate(zip(fx, fy)):
            d = (a - b) ** 2                                          # [N, C, h, w]
            total = total + torch.mean(torch.sum(d * p[f"lin{s}_w"][:, None, None], dim=1), dim=(1, 2))
        return total


@torch.no_grad()
def vgg_raw_taps(model: Lpips, x: torch.Tensor) -> List[torch.Tensor]:
    """The raw stage activations (NCHW) of an already preprocessed input [N,
    H, W, 3]: the `VGGLoss` feature extractor."""
    return _vgg_forward(model.params, x, normalize=False)


def _default_weight_paths() -> List[str]:
    cands = []
    env = os.environ.get("SPLAT_LPIPS_WEIGHTS")
    if env:
        cands.append(env)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cands.append(os.path.join(pkg_root, "weights", "lpips_vgg.npz"))
    return cands


_MODELS: Dict[str, Lpips] = {}   # one per device, as the JAX package keeps one per process


def get_model(seed: int = 0, device="cuda") -> Lpips:
    """The pretrained weights if present, else the deterministic random
    trunk, on `device`; cached per device."""
    dev = resolve_device(device)
    if str(dev) not in _MODELS:
        for path in _default_weight_paths():
            if os.path.exists(path):
                with np.load(path) as z:
                    _MODELS[str(dev)] = Lpips({k: z[k] for k in z.files}, pretrained=True).to(dev)
                break
        else:
            _MODELS[str(dev)] = Lpips(random_params(seed), pretrained=False).to(dev)
    return _MODELS[str(dev)]


def lpips_distance(pred: np.ndarray, gt: np.ndarray, model: Optional[Lpips] = None, device="cuda") -> float:
    """LPIPS between two [H, W, 3] images in [0, 1] (taken to [-1, 1])."""
    model = model or get_model(device=device)
    to = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=model.device)[None] * 2.0 - 1.0
    return float(model(to(pred), to(gt))[0])


def lpips_is_pretrained(device="cuda") -> bool:
    return get_model(device=device).pretrained
