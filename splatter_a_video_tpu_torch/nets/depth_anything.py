"""Depth-Anything (V1/V2) relative depth, inference path (counterpart of
`splatter_a_video_tpu/nets/depth_anything.py`).

DINOv2 trunk (`nets/vit.py`) -> DPT neck (reassemble, feature fusion) ->
depth head, layer for layer as
`transformers.models.depth_anything.modeling_depth_anything`, so converted
checkpoints reproduce the torch outputs. Every `F.interpolate` of the
reference is a dense-matmul resize (`nets/interp.py`, the JAX package's
weights); convolutions are `F.conv2d` in float32 (cuDNN TF32 off, as the
package pins it), channels first inside, the JAX layout (channels last)
at the public functions. Params are the JAX package's dict (convs HWIO,
the reassemble deconvs [k, k, out, in]).

Weights: the converted `.npz` at `$SPLAT_DEPTH_ANYTHING_WEIGHTS` or
`splatter_a_video_tpu_torch/weights/depth_anything.npz`
(`scripts/torch_convert_depth_anything.py` writes it from a local
checkpoint through `save_params`; the JAX package reads the same file);
without one `get_model` returns None and the preprocessing stage stays
gated.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import vit as _vit
from .convert_util import ParamModule, to_numpy
from .interp import interp2d, resize_hw

# ImageNet normalisation of the DPT image processor
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class DepthAnythingConfig:
    """Defaults: the HF small config (`configuration_depth_anything.py`)."""

    backbone: _vit.ViTConfig = field(default_factory=_vit.ViTConfig)
    out_indices: Tuple[int, ...] = (9, 10, 11, 12)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    neck_hidden_sizes: Tuple[int, ...] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    patch_size: int = 14


def _conv(x, w, b=None, stride: int = 1):
    """NCHW conv of an HWIO kernel, padding k // 2 as torch's."""
    k = w.shape[0]
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride, padding=k // 2)


def _deconv_factor(x, w, b, factor: int):
    """ConvTranspose2d with kernel = stride = factor: each input pixel emits
    a factor x factor block (w: [k, k, out, in])."""
    return F.conv_transpose2d(x, w.permute(3, 2, 0, 1), b, stride=factor)


def random_params(cfg: DepthAnythingConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's deterministic random init (numpy, same draws)."""
    rng = np.random.RandomState(seed)
    C = cfg.backbone.hidden_size
    Fh = cfg.fusion_hidden_size

    def conv(k, cin, cout, bias=True):
        w = (rng.randn(k, k, cin, cout) / math.sqrt(k * k * cin)).astype(np.float32)
        return (w, np.zeros(cout, np.float32)) if bias else (w,)

    p = dict(_vit.random_params(cfg.backbone, seed))
    for i, (ch, f) in enumerate(zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)):
        p[f"re{i}.proj_w"], p[f"re{i}.proj_b"] = conv(1, C, ch)
        if f > 1:
            k = int(f)
            p[f"re{i}.resize_w"] = (rng.randn(k, k, ch, ch) / math.sqrt(k * k * ch)).astype(np.float32)
            p[f"re{i}.resize_b"] = np.zeros(ch, np.float32)
        elif f < 1:
            p[f"re{i}.resize_w"], p[f"re{i}.resize_b"] = conv(3, ch, ch)
        (p[f"neckconv{i}_w"],) = conv(3, ch, Fh, bias=False)
    for i in range(len(cfg.neck_hidden_sizes)):
        p[f"fu{i}.proj_w"], p[f"fu{i}.proj_b"] = conv(1, Fh, Fh)
        for r in (1, 2):
            for c in (1, 2):
                p[f"fu{i}.res{r}.conv{c}_w"], p[f"fu{i}.res{r}.conv{c}_b"] = conv(3, Fh, Fh)
    p["head.conv1_w"], p["head.conv1_b"] = conv(3, Fh, Fh // 2)
    p["head.conv2_w"], p["head.conv2_b"] = conv(3, Fh // 2, cfg.head_hidden_size)
    p["head.conv3_w"], p["head.conv3_b"] = conv(1, cfg.head_hidden_size, 1)
    return p


def params_from_torch(sd, strict: bool = False) -> Dict[str, np.ndarray]:
    """Convert a `DepthAnythingForDepthEstimation` torch state_dict to the
    JAX package's numpy dict. strict=True errors on any unconsumed key
    (DINOv2's `mask_token` is the one key unused at inference)."""
    from .convert_util import RecordingStateDict, check_consumed

    orig_sd = sd
    sd = RecordingStateDict(sd)

    def g(name):
        return to_numpy(sd[name])

    def cw(name):  # conv OIHW -> HWIO
        return g(name).transpose(2, 3, 1, 0)

    p = dict(_vit.params_from_torch(sd, prefix="backbone."))
    i = 0
    while f"neck.reassemble_stage.layers.{i}.projection.weight" in sd:
        base = f"neck.reassemble_stage.layers.{i}."
        p[f"re{i}.proj_w"] = cw(base + "projection.weight")
        p[f"re{i}.proj_b"] = g(base + "projection.bias")
        if base + "resize.weight" in sd:
            # one permutation serves both: ConvTranspose2d [in, out, k, k] ->
            # [k, k, out, in] and Conv2d [out, in, k, k] -> [k, k, in, out]
            p[f"re{i}.resize_w"] = g(base + "resize.weight").transpose(2, 3, 1, 0)
            p[f"re{i}.resize_b"] = g(base + "resize.bias")
        p[f"neckconv{i}_w"] = cw(f"neck.convs.{i}.weight")
        i += 1
    j = 0
    while f"neck.fusion_stage.layers.{j}.projection.weight" in sd:
        base = f"neck.fusion_stage.layers.{j}."
        p[f"fu{j}.proj_w"] = cw(base + "projection.weight")
        p[f"fu{j}.proj_b"] = g(base + "projection.bias")
        for r in (1, 2):
            for c in (1, 2):
                p[f"fu{j}.res{r}.conv{c}_w"] = cw(base + f"residual_layer{r}.convolution{c}.weight")
                p[f"fu{j}.res{r}.conv{c}_b"] = g(base + f"residual_layer{r}.convolution{c}.bias")
        j += 1
    for name in ("conv1", "conv2", "conv3"):
        p[f"head.{name}_w"] = cw(f"head.{name}.weight")
        p[f"head.{name}_b"] = g(f"head.{name}.bias")
    if strict:
        check_consumed(orig_sd, sd.used, ignore=(r"embeddings\.mask_token$",))
    return p


def _residual_unit(p, pre, x):
    h = _conv(F.relu(x), p[pre + ".conv1_w"], p[pre + ".conv1_b"])
    h = _conv(F.relu(h), p[pre + ".conv2_w"], p[pre + ".conv2_b"])
    return h + x


def forward(cfg: DepthAnythingConfig, p: Dict[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] normalised images (H, W multiples of the patch) -> [B, H,
    W] relative inverse depth (disparity)."""
    B, H, W, _ = images.shape
    P = cfg.patch_size
    ph, pw = H // P, W // P
    taps = _vit.forward(cfg.backbone, p, images, cfg.out_indices)

    # reassemble: drop cls, to a grid, project, resize by the stage's factor
    feats: List[torch.Tensor] = []
    for i, (t, f) in enumerate(zip(taps, cfg.reassemble_factors)):
        x = t[:, 1:].reshape(B, ph, pw, -1).permute(0, 3, 1, 2)
        x = _conv(x, p[f"re{i}.proj_w"], p[f"re{i}.proj_b"])
        if f > 1:
            x = _deconv_factor(x, p[f"re{i}.resize_w"], p[f"re{i}.resize_b"], int(f))
        elif f < 1:
            x = _conv(x, p[f"re{i}.resize_w"], p[f"re{i}.resize_b"], stride=int(round(1.0 / f)))
        feats.append(_conv(x, p[f"neckconv{i}_w"]))

    # fusion, deepest first: each step upsamples to the next shallower grid
    rev = feats[::-1]
    fused = None
    for idx, x in enumerate(rev):
        if fused is None:
            h = x
        else:
            x = resize_hw(x, fused.shape[2], fused.shape[3], "bilinear", align_corners=False)
            h = fused + _residual_unit(p, f"fu{idx}.res1", x)
        h = _residual_unit(p, f"fu{idx}.res2", h)
        size = rev[idx + 1].shape[2:4] if idx != len(rev) - 1 else (h.shape[2] * 2, h.shape[3] * 2)
        h = resize_hw(h, size[0], size[1], "bilinear", align_corners=True)
        fused = _conv(h, p[f"fu{idx}.proj_w"], p[f"fu{idx}.proj_b"])

    # head
    h = _conv(fused, p["head.conv1_w"], p["head.conv1_b"])
    h = resize_hw(h, ph * P, pw * P, "bilinear", align_corners=True)
    h = F.relu(_conv(h, p["head.conv2_w"], p["head.conv2_b"]))
    h = F.relu(_conv(h, p["head.conv3_w"], p["head.conv3_b"]))
    return h[:, 0]


class DepthAnything(ParamModule):
    """The network as a module: `DepthAnything(cfg, params)(images)`;
    `pretrained` says whether the weights came from a checkpoint."""

    def __init__(self, cfg: DepthAnythingConfig, params: Dict[str, np.ndarray], pretrained: bool = False):
        super().__init__(params)
        self.cfg = cfg
        self.pretrained = pretrained

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params, images)


def _fit_size(h: int, w: int, target: int = 518, multiple: int = 14) -> Tuple[int, int]:
    """DPT processor sizing (`get_resize_output_image_size` with
    keep_aspect_ratio=True): the scale closer to 1, both sides rounded to a
    multiple of the patch."""
    scale_h, scale_w = target / h, target / w
    scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h

    def rnd(v):
        return max(multiple, int(round(v / multiple)) * multiple)

    return rnd(h * scale), rnd(w * scale)


def prepare_image(img: np.ndarray, target: int = 518, device="cuda") -> torch.Tensor:
    """[H, W, 3] uint8 or float in [0, 1] -> normalised [1, H', W', 3] on `device`."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    if img.dtype == np.uint8:
        x = x / 255.0
    nh, nw = _fit_size(x.shape[0], x.shape[1], target)
    x = torch.clamp(interp2d(x[None], nh, nw, "bicubic", align_corners=False), 0.0, 1.0)
    return (x - torch.from_numpy(_MEAN).to(dev)) / torch.from_numpy(_STD).to(dev)


def infer_disparity(model: DepthAnything, img: np.ndarray) -> np.ndarray:
    """Relative disparity at the input resolution, on the model's device:
    `get_depth_anything_disp` of the reference without the uint16
    quantisation (the pipeline's bicubic resize back to the source size)."""
    x = prepare_image(img, device=model.device)
    d = model(x)
    return interp2d(d[..., None], img.shape[0], img.shape[1], "bicubic", False)[0, ..., 0].cpu().numpy()


def save_params(path: str, params: Dict[str, np.ndarray], num_heads: int = 6,
                out_indices: Sequence[int] = (9, 10, 11, 12)) -> None:
    """Save a converted checkpoint (the JAX package's format): the
    architecture follows from the shapes, `num_heads` and `out_indices`
    are stored as metadata arrays."""
    np.savez(path, _meta_num_heads=np.asarray(num_heads), _meta_out_indices=np.asarray(list(out_indices)),
             **{k: np.asarray(v) for k, v in params.items()})


def config_from_params(params: Dict[str, np.ndarray], num_heads: int,
                       out_indices: Sequence[int]) -> DepthAnythingConfig:
    """The architecture from the parameter shapes (small / base / large)."""
    hidden = int(np.asarray(params["cls_token"]).shape[-1])
    patch = int(np.asarray(params["patch_w"]).shape[0])
    n_layers = 0
    while f"l{n_layers}.ln1_w" in params:
        n_layers += 1
    n_pos = int(np.asarray(params["pos_embed"]).shape[1]) - 1
    image_size = int(round(math.sqrt(n_pos))) * patch
    mlp_ratio = int(np.asarray(params["l0.fc1_w"]).shape[1]) // hidden
    neck_sizes, factors = [], []
    i = 0
    while f"re{i}.proj_w" in params:
        neck_sizes.append(int(np.asarray(params[f"re{i}.proj_w"]).shape[-1]))
        if f"re{i}.resize_w" not in params:
            factors.append(1)
        else:
            k = int(np.asarray(params[f"re{i}.resize_w"]).shape[0])
            factors.append(0.5 if k == 3 else k)   # k = 3: a conv down; else a deconv up
        i += 1
    return DepthAnythingConfig(
        backbone=_vit.ViTConfig(hidden_size=hidden, num_layers=n_layers, num_heads=num_heads,
                                mlp_ratio=mlp_ratio, patch_size=patch, image_size=image_size),
        out_indices=tuple(int(v) for v in out_indices),
        reassemble_factors=tuple(factors),
        neck_hidden_sizes=tuple(neck_sizes),
        fusion_hidden_size=int(np.asarray(params["fu0.proj_w"]).shape[-1]),
        head_hidden_size=int(np.asarray(params["head.conv2_w"]).shape[-1]),
        patch_size=patch,
    )


def _default_weight_paths() -> List[str]:
    paths = []
    env = os.environ.get("SPLAT_DEPTH_ANYTHING_WEIGHTS")
    if env:
        paths.append(env)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths.append(os.path.join(pkg, "weights", "depth_anything.npz"))
    return paths


def get_model(cfg: Optional[DepthAnythingConfig] = None, device="cuda") -> Optional[DepthAnything]:
    """The converted checkpoint on `device` if one is present, else None
    (the preprocessing stage then stays gated: weights cannot be
    downloaded offline). The architecture comes from the checkpoint unless
    `cfg` is given."""
    dev = resolve_device(device)
    for path in _default_weight_paths():
        if os.path.exists(path):
            with np.load(path) as z:
                raw = {k: z[k] for k in z.files}
            num_heads = int(raw.pop("_meta_num_heads", 6))
            out_indices = raw.pop("_meta_out_indices", np.array([9, 10, 11, 12]))
            if cfg is None:
                cfg = config_from_params(raw, num_heads, out_indices.tolist())
            return DepthAnything(cfg, raw, pretrained=True).to(dev)
    return None
