"""TAPIR / BootsTAPIR point tracking, inference path (counterpart of
`splatter_a_video_tpu/nets/tapir.py`).

ResNet-v2 (instance-norm) features, a cost-volume initialisation with a
soft argmax, and the PIPs depthwise-conv MLP-mixer refinement, layer for
layer as the JAX package (and the reference's torch port), in float32.
Convolutions are `F.conv2d` / `F.conv1d` after an explicit `F.pad` of the
JAX padding pairs, some uneven (conv2d's own padding is symmetric). The
samplers are gathers at `coord - 0.5` written out (not `grid_sample`, which
normalises coordinates otherwise), with int corners clamped and weighted to
zero out of range unless `border`. The feature extractor runs
`frame_chunk` frames at a time to bound its memory. The grids depend on the
video alone: `track_points` computes them once a call and every chunk of
the call reuses them (`_grids_once`). Params are the JAX
package's dict (convs HWIO, linears [in, out], depthwise kernels [k, 1,
out]); feature grids are channels last.

Weights: the converted `.npz` at `$SPLAT_TAPIR_WEIGHTS` or
`splatter_a_video_tpu_torch/weights/tapir.npz` (`scripts/torch_convert_tapir.py`
writes it from the torch checkpoint; the JAX package reads the same file);
without one `get_model` returns None and `data/preprocess.compute_tracks`
stays gated.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils import spans as _spans
from .convert_util import ParamModule, to_numpy
from .interp import interp2d

_EPS = 1e-12


@dataclass(frozen=True)
class TapirConfig:
    num_pips_iter: int = 4
    pyramid_level: int = 1
    softmax_temperature: float = 20.0
    initial_resolution: Tuple[int, int] = (256, 256)
    highres_dim: int = 128
    lowres_dim: int = 256
    blocks_per_group: Tuple[int, ...] = (2, 2, 2, 2)
    channels_per_group: Tuple[int, ...] = (64, 128, 256, 256)
    strides: Tuple[int, ...] = (1, 2, 2, 1)
    mixer_hidden_dim: int = 512
    num_mixer_blocks: int = 12
    extra_convs: int = 5            # ExtraConvs layers (0 = off)
    frame_chunk: int = 8            # frames per feature-extractor pass

    @property
    def feat_dim(self) -> int:
        return self.highres_dim + self.lowres_dim   # 384

    @property
    def mixer_out_dim(self) -> int:
        return 4 + self.feat_dim                     # 388

    @property
    def mixer_in_dim(self) -> int:
        # pos 2 + occ 1 + expd 1 + feats 384 + 49 correlations a level
        return self.mixer_out_dim + (self.pyramid_level + 2) * 49


# ---- parameters ------------------------------------------------------------


def random_params(cfg: TapirConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's deterministic random init (numpy, same draws)."""
    rng = np.random.RandomState(seed)

    def conv(k, cin, cout):
        return (rng.randn(k, k, cin, cout) / math.sqrt(k * k * cin)).astype(np.float32)

    def lin(cin, cout):
        return (rng.randn(cin, cout) / math.sqrt(cin)).astype(np.float32)

    def zeros(c):
        return np.zeros(c, np.float32)

    def ones(c):
        return np.ones(c, np.float32)

    p: Dict[str, np.ndarray] = {"initial_conv_w": conv(7, 3, cfg.channels_per_group[0])}
    cin = cfg.channels_per_group[0]
    for g, (nb, cout) in enumerate(zip(cfg.blocks_per_group, cfg.channels_per_group)):
        for b in range(nb):
            pre = f"r{g}.{b}."
            c_in_b = cin if b == 0 else cout
            p[pre + "bn0_w"], p[pre + "bn0_b"] = ones(c_in_b), zeros(c_in_b)
            p[pre + "conv0_w"] = conv(3, c_in_b, cout)
            p[pre + "bn1_w"], p[pre + "bn1_b"] = ones(cout), zeros(cout)
            p[pre + "conv1_w"] = conv(3, cout, cout)
            if b == 0:
                p[pre + "proj_w"] = conv(1, c_in_b, cout)
        cin = cout
    C = cfg.lowres_dim
    for i in range(cfg.extra_convs):
        pre = f"ec{i}."
        p[pre + "ln_w"], p[pre + "ln_b"] = ones(C), zeros(C)
        p[pre + "conv0_w"], p[pre + "conv0_b"] = conv(3, C, C * 4), zeros(C * 4)
        p[pre + "conv1_w"], p[pre + "conv1_b"] = conv(3, C * 4, C), zeros(C)
    p.update({
        "cv.hid1_w": conv(3, 1, 16), "cv.hid1_b": zeros(16),
        "cv.hid2_w": conv(3, 16, 1), "cv.hid2_b": zeros(1),
        "cv.hid3_w": conv(3, 16, 32), "cv.hid3_b": zeros(32),
        "cv.hid4_w": lin(32, 16), "cv.hid4_b": zeros(16),
        "cv.occ_w": lin(16, 2), "cv.occ_b": zeros(2),
    })
    H = cfg.mixer_hidden_dim
    p["mx.in_w"], p["mx.in_b"] = lin(cfg.mixer_in_dim, H), zeros(H)
    for i in range(cfg.num_mixer_blocks):
        pre = f"mx{i}."
        p[pre + "ln_w"] = ones(H)
        p[pre + "up1_w"] = (rng.randn(3, 1, H * 4) / math.sqrt(3)).astype(np.float32)
        p[pre + "up1_b"] = zeros(H * 4)
        p[pre + "up2_w"] = (rng.randn(3, 1, H * 4) / math.sqrt(3)).astype(np.float32)
        p[pre + "up2_b"] = zeros(H * 4)
        p[pre + "ln1_w"] = ones(H)
        p[pre + "mlp_up_w"], p[pre + "mlp_up_b"] = lin(H, H * 4), zeros(H * 4)
        p[pre + "mlp_down_w"], p[pre + "mlp_down_b"] = lin(H * 4, H), zeros(H)
    p["mx.ln_w"] = ones(H)
    p["mx.out_w"], p["mx.out_b"] = lin(H, cfg.mixer_out_dim), zeros(cfg.mixer_out_dim)
    return p


def random_state_dict(cfg: TapirConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A torch TAPIR state dict in the reference's `tapnet_torch` names and
    layouts (what `params_from_torch` reads) of random weights scaled by
    their fan-in: a stand-in checkpoint for the converter where the
    published one cannot be had."""
    rng = np.random.RandomState(seed)

    def w(*shape):  # [out, in, ...]
        return (rng.randn(*shape) / math.sqrt(int(np.prod(shape[1:])))).astype(np.float32)

    def b(n):
        return (0.1 * rng.randn(n)).astype(np.float32)

    def scale(n):
        return (1.0 + 0.1 * rng.randn(n)).astype(np.float32)

    sd = {"resnet_torch.initial_conv.weight": w(cfg.channels_per_group[0], 3, 7, 7)}
    cin = cfg.channels_per_group[0]
    for g, (nb, cout) in enumerate(zip(cfg.blocks_per_group, cfg.channels_per_group)):
        for i in range(nb):
            src = f"resnet_torch.block_groups.{g}.blocks.{i}."
            c_in_b = cin if i == 0 else cout
            sd.update({src + "bn_0.weight": scale(c_in_b), src + "bn_0.bias": b(c_in_b),
                       src + "conv_0.weight": w(cout, c_in_b, 3, 3), src + "bn_1.weight": scale(cout),
                       src + "bn_1.bias": b(cout), src + "conv_1.weight": w(cout, cout, 3, 3)})
            if i == 0:
                sd[src + "proj_conv.weight"] = w(cout, c_in_b, 1, 1)
        cin = cout
    C = cfg.lowres_dim
    for i in range(cfg.extra_convs):
        src = f"extra_convs.blocks.{i}."
        sd.update({src + "layer_norm.weight": scale(C), src + "layer_norm.bias": b(C),
                   src + "conv.weight": w(4 * C, C, 3, 3), src + "conv.bias": b(4 * C),
                   src + "conv_1.weight": w(C, 4 * C, 3, 3), src + "conv_1.bias": b(C)})
    cv = "torch_cost_volume_track_mods."
    sd.update({cv + "hid1.weight": w(16, 1, 3, 3), cv + "hid1.bias": b(16), cv + "hid2.weight": w(1, 16, 3, 3),
               cv + "hid2.bias": b(1), cv + "hid3.weight": w(32, 16, 3, 3), cv + "hid3.bias": b(32),
               cv + "hid4.weight": w(16, 32), cv + "hid4.bias": b(16), cv + "occ_out.weight": w(2, 16),
               cv + "occ_out.bias": b(2)})
    H = cfg.mixer_hidden_dim
    mx = "torch_pips_mixer."
    sd.update({mx + "linear.weight": w(H, cfg.mixer_in_dim), mx + "linear.bias": b(H),
               mx + "layer_norm.weight": scale(H), mx + "linear_1.weight": w(cfg.mixer_out_dim, H),
               mx + "linear_1.bias": b(cfg.mixer_out_dim)})
    for i in range(cfg.num_mixer_blocks):
        src = mx + f"blocks.{i}."
        sd.update({src + "layer_norm.weight": scale(H), src + "mlp1_up.weight": w(4 * H, 1, 3),
                   src + "mlp1_up.bias": b(4 * H), src + "mlp1_up_1.weight": w(4 * H, 1, 3),
                   src + "mlp1_up_1.bias": b(4 * H), src + "layer_norm_1.weight": scale(H),
                   src + "conv_channels_mixer.mlp2_up.weight": w(4 * H, H),
                   src + "conv_channels_mixer.mlp2_up.bias": b(4 * H),
                   src + "conv_channels_mixer.mlp2_down.weight": w(H, 4 * H),
                   src + "conv_channels_mixer.mlp2_down.bias": b(H)})
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def params_from_torch(sd, strict: bool = False) -> Dict[str, np.ndarray]:
    """Convert the torch TAPIR state_dict (the reference's `tapnet_torch`
    naming) to the JAX package's numpy dict; strict=True also errors on
    any key the converter did not consume."""
    from .convert_util import RecordingStateDict, check_consumed

    orig_sd = sd
    sd = RecordingStateDict(sd)

    def g(name):
        return to_numpy(sd[name])

    def cw(name):  # conv OIHW -> HWIO
        return g(name).transpose(2, 3, 1, 0)

    p: Dict[str, np.ndarray] = {"initial_conv_w": cw("resnet_torch.initial_conv.weight")}
    gi = 0
    while f"resnet_torch.block_groups.{gi}.blocks.0.conv_0.weight" in sd:
        bi = 0
        while f"resnet_torch.block_groups.{gi}.blocks.{bi}.conv_0.weight" in sd:
            src = f"resnet_torch.block_groups.{gi}.blocks.{bi}."
            dst = f"r{gi}.{bi}."
            p[dst + "bn0_w"] = g(src + "bn_0.weight")
            p[dst + "bn0_b"] = g(src + "bn_0.bias")
            p[dst + "conv0_w"] = cw(src + "conv_0.weight")
            p[dst + "bn1_w"] = g(src + "bn_1.weight")
            p[dst + "bn1_b"] = g(src + "bn_1.bias")
            p[dst + "conv1_w"] = cw(src + "conv_1.weight")
            if src + "proj_conv.weight" in sd:
                p[dst + "proj_w"] = cw(src + "proj_conv.weight")
            bi += 1
        gi += 1
    i = 0
    while f"extra_convs.blocks.{i}.conv.weight" in sd:
        src = f"extra_convs.blocks.{i}."
        p[f"ec{i}.ln_w"] = g(src + "layer_norm.weight")
        p[f"ec{i}.ln_b"] = g(src + "layer_norm.bias")
        p[f"ec{i}.conv0_w"] = cw(src + "conv.weight")
        p[f"ec{i}.conv0_b"] = g(src + "conv.bias")
        p[f"ec{i}.conv1_w"] = cw(src + "conv_1.weight")
        p[f"ec{i}.conv1_b"] = g(src + "conv_1.bias")
        i += 1
    cv = "torch_cost_volume_track_mods."
    p.update({
        "cv.hid1_w": cw(cv + "hid1.weight"), "cv.hid1_b": g(cv + "hid1.bias"),
        "cv.hid2_w": cw(cv + "hid2.weight"), "cv.hid2_b": g(cv + "hid2.bias"),
        "cv.hid3_w": cw(cv + "hid3.weight"), "cv.hid3_b": g(cv + "hid3.bias"),
        "cv.hid4_w": g(cv + "hid4.weight").T, "cv.hid4_b": g(cv + "hid4.bias"),
        "cv.occ_w": g(cv + "occ_out.weight").T, "cv.occ_b": g(cv + "occ_out.bias"),
    })
    mx = "torch_pips_mixer."
    p["mx.in_w"], p["mx.in_b"] = g(mx + "linear.weight").T, g(mx + "linear.bias")
    p["mx.ln_w"] = g(mx + "layer_norm.weight")
    p["mx.out_w"], p["mx.out_b"] = g(mx + "linear_1.weight").T, g(mx + "linear_1.bias")
    i = 0
    while mx + f"blocks.{i}.mlp1_up.weight" in sd:
        src = mx + f"blocks.{i}."
        dst = f"mx{i}."
        p[dst + "ln_w"] = g(src + "layer_norm.weight")
        # torch depthwise Conv1d [out, 1, k] -> [k, 1, out]
        p[dst + "up1_w"] = g(src + "mlp1_up.weight").transpose(2, 1, 0)
        p[dst + "up1_b"] = g(src + "mlp1_up.bias")
        p[dst + "up2_w"] = g(src + "mlp1_up_1.weight").transpose(2, 1, 0)
        p[dst + "up2_b"] = g(src + "mlp1_up_1.bias")
        p[dst + "ln1_w"] = g(src + "layer_norm_1.weight")
        p[dst + "mlp_up_w"] = g(src + "conv_channels_mixer.mlp2_up.weight").T
        p[dst + "mlp_up_b"] = g(src + "conv_channels_mixer.mlp2_up.bias")
        p[dst + "mlp_down_w"] = g(src + "conv_channels_mixer.mlp2_down.weight").T
        p[dst + "mlp_down_b"] = g(src + "conv_channels_mixer.mlp2_down.bias")
        i += 1
    if strict:
        check_consumed(orig_sd, sd.used)
    return p


# ---- primitives (NCHW inside; pads as the JAX pairs ((top, bottom), (left, right)))


def _conv(x, w, b=None, stride=1, padding=((1, 1), (1, 1))):
    (t, bt), (l, r) = padding
    if t or bt or l or r:
        x = F.pad(x, (l, r, t, bt))
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride)


def _instance_norm(x, w, b, eps=1e-5):
    """Per-sample per-channel spatial normalisation (affine InstanceNorm2d), NCHW."""
    mu = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)   # jnp.var
    return (x - mu) * torch.rsqrt(var + eps) * w[:, None, None] + b[:, None, None]


def _layernorm(x, w, b=None, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)        # jnp.var
    y = (x - mu) * torch.rsqrt(var + eps) * w
    return y if b is None else y + b


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _sample_frames_bilinear(feats: torch.Tensor, xy: torch.Tensor, border: bool) -> torch.Tensor:
    """Bilinear samples of per-frame maps feats [T, H, W, C] at xy [..., T,
    S, 2] (y, x) in grid units, pixel centres at +0.5 (`grid_sample`,
    align_corners=False): [..., T, S, C]. Out-of-range corners weigh 0
    unless `border` (clamped)."""
    T, H, W, C = feats.shape
    y = xy[..., 0] - 0.5
    x = xy[..., 1] - 0.5
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0, x0 = y0.to(torch.int32), x0.to(torch.int32)
    t = torch.arange(T, device=feats.device).reshape((1,) * (y.ndim - 2) + (T, 1)).expand(y.shape)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            wgt = ((1 - fy) if dy == 0 else fy) * ((1 - fx) if dx == 0 else fx)
            if not border:
                wgt = wgt * ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(feats.dtype)
            vals = feats[t, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
            out = out + vals * wgt[..., None]
    return out


def _sample_trilinear(feats: torch.Tensor, tyx: torch.Tensor) -> torch.Tensor:
    """`map_coordinates_3d`: trilinear samples of feats [T, H, W, C] at
    tyx [N, 3] (t, y, x); t at frame centres, y / x at coord - 0.5, border
    clamped. [N, C]."""
    T, H, W, C = feats.shape
    t = tyx[:, 0]
    t0 = torch.floor(t)
    ft = t - t0
    y = tyx[:, 1] - 0.5
    x = tyx[:, 2] - 0.5
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0

    def at_frame(dt):
        ti = (t0.to(torch.int32) + dt).clamp(0, T - 1).long()
        out = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                yi = (y0.to(torch.int32) + dy).clamp(0, H - 1).long()
                xi = (x0.to(torch.int32) + dx).clamp(0, W - 1).long()
                wgt = ((1 - fy) if dy == 0 else fy) * ((1 - fx) if dx == 0 else fx)
                out = out + feats[ti, yi, xi] * wgt[:, None]
        return out

    return at_frame(0) * (1 - ft)[:, None] + at_frame(1) * ft[:, None]


# ---- feature extractor -----------------------------------------------------------


def _resnet_block(p, pre, x, stride, has_proj):
    h = F.relu(_instance_norm(x, p[pre + "bn0_w"], p[pre + "bn0_b"]))
    shortcut = x
    if has_proj:
        shortcut = _conv(h, p[pre + "proj_w"], stride=stride, padding=((0, 0), (0, 0)))
    # the JAX SAME padding of the reference's BlockV2: stride 1 (1, 1), stride 2 (0, 2)
    pad = ((1, 1), (1, 1)) if stride == 1 else ((0, 2), (0, 2))
    h = _conv(h, p[pre + "conv0_w"], stride=stride, padding=pad)
    h = F.relu(_instance_norm(h, p[pre + "bn1_w"], p[pre + "bn1_b"]))
    h = _conv(h, p[pre + "conv1_w"], stride=1, padding=((1, 1), (1, 1)))
    return h + shortcut


def resnet_forward(cfg: TapirConfig, p, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B, H, W, 3] -> {'unit0'.. 'unit3'}, channels last ('unit1': stride 4,
    128 channels; 'unit3': stride 8, 256 channels)."""
    out = _conv(x.permute(0, 3, 1, 2), p["initial_conv_w"], stride=2, padding=((2, 4), (2, 4)))
    res = {}
    for g, (nb, stride) in enumerate(zip(cfg.blocks_per_group, cfg.strides)):
        for b in range(nb):
            out = _resnet_block(p, f"r{g}.{b}.", out, stride=(stride if b == 0 else 1), has_proj=(b == 0))
        res[f"unit{g}"] = out.permute(0, 2, 3, 1)
    return res


def extra_convs_forward(cfg: TapirConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The ExtraConvs stack on [B, h, w, C] (channels last)."""
    for i in range(cfg.extra_convs):
        pre = f"ec{i}."
        h = _layernorm(x, p[pre + "ln_w"], p[pre + "ln_b"])
        r = _gelu_tanh(_conv(h.permute(0, 3, 1, 2), p[pre + "conv0_w"], p[pre + "conv0_b"]))
        x = h + _conv(r, p[pre + "conv1_w"], p[pre + "conv1_b"]).permute(0, 2, 3, 1)
    return x


def _l2_normalize(x):
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), _EPS))


def get_feature_grids(cfg: TapirConfig, p, video: torch.Tensor):
    """[T, H, W, 3] in [-1, 1] -> (lowres [T, h8, w8, 256], hires [T, h4,
    w4, 128]) at the initial resolution, `frame_chunk` frames a pass. (The
    JAX package pads the last chunk with zero frames and drops their
    outputs; instance norm is per frame, so running it short is the same.)"""
    ih, iw = cfg.initial_resolution
    video = interp2d(video, ih, iw, "bilinear", align_corners=False)
    chunk = max(1, cfg.frame_chunk)
    lo, hi = [], []
    for s in range(0, video.shape[0], chunk):
        r = resnet_forward(cfg, p, video[s:s + chunk])
        lo.append(r["unit3"])
        hi.append(r["unit1"])
    lo, hi = torch.cat(lo), torch.cat(hi)
    if cfg.extra_convs:
        lo = extra_convs_forward(cfg, p, lo)
    return _l2_normalize(lo), _l2_normalize(hi)


# ---- track initialisation from the cost volume -------------------------------------


def _soft_argmax_heatmap(softmaxed: torch.Tensor, threshold: float = 5.0):
    """[..., h, w] -> [..., 2] (x + 0.5, y + 0.5): the weighted mean within
    `threshold` px of the (first) argmax."""
    h, w = softmaxed.shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(h, device=softmaxed.device), torch.arange(w, device=softmaxed.device),
                            indexing="ij")
    coords = torch.stack([xx + 0.5, yy + 0.5], dim=-1).to(softmaxed.dtype)
    am = torch.argmax(softmaxed.reshape(softmaxed.shape[:-2] + (h * w,)), dim=-1)
    pos = coords.reshape(h * w, 2)[am]
    d2 = torch.sum((coords - pos[..., None, None, :]) ** 2, dim=-1)
    valid = (d2 < threshold ** 2).to(softmaxed.dtype)
    wsum = torch.sum(coords * (valid * softmaxed)[..., None], dim=(-3, -2))
    den = torch.clamp_min(torch.sum(valid * softmaxed, dim=(-2, -1)), _EPS)
    return wsum / den[..., None]


def tracks_from_cost_volume(cfg: TapirConfig, p, query_feats: torch.Tensor, feature_grid: torch.Tensor,
                            query_points: Optional[torch.Tensor]):
    """TAP-Net initialisation: query_feats [N, 256], feature_grid [T, h, w,
    256], query_points [N, 3] (t, y, x) at the initial resolution ->
    (points [N, T, 2] (x, y), occlusion [N, T], expected_dist [N, T])."""
    T, h, w, _ = feature_grid.shape
    N = query_feats.shape[0]
    cost = torch.einsum("nc,thwc->tnhw", query_feats, feature_grid)
    x = cost.reshape(T * N, 1, h, w)
    occ = F.relu(_conv(x, p["cv.hid1_w"], p["cv.hid1_b"]))
    pos = _conv(occ, p["cv.hid2_w"], p["cv.hid2_b"])                 # [T*N, 1, h, w]

    pos = pos.reshape(T, N, h, w).transpose(0, 1)                     # [N, T, h, w]
    sm = torch.softmax(pos.reshape(N, T, -1) * cfg.softmax_temperature, dim=-1).reshape(N, T, h, w)
    points = _soft_argmax_heatmap(sm)                                 # [N, T, 2] (x, y)
    ih, iw = cfg.initial_resolution
    points = points * torch.tensor([iw / w, ih / h], dtype=points.dtype, device=points.device)
    if query_points is not None:
        # the query frame snaps to the exact query position
        qf = torch.round(query_points[:, 0])
        is_q = (qf[:, None] == torch.arange(T, device=qf.device)[None, :])[..., None]
        q_xy = query_points.flip(-1)[:, :2][:, None, :]               # (x, y)
        points = torch.where(is_q, q_xy, points)

    # occlusion / uncertainty head: pad (0, 2), (0, 2), a VALID stride-2
    # conv, the spatial mean, two linears
    o = F.relu(_conv(F.pad(occ, (0, 2, 0, 2)), p["cv.hid3_w"], p["cv.hid3_b"], stride=2,
                     padding=((0, 0), (0, 0))))
    o = torch.mean(o, dim=(2, 3))
    o = F.relu(o @ p["cv.hid4_w"] + p["cv.hid4_b"])
    o = (o @ p["cv.occ_w"] + p["cv.occ_b"]).reshape(T, N, 2).transpose(0, 1)
    return points, o[..., 0], o[..., 1]


# ---- PIPs mixer refinement -------------------------------------------------------------


def _depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, C_in] * [k, 1, C_out] -> [B, T, C_out], padding 1, grouped by
    feature."""
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=1, groups=groups).transpose(1, 2)


def mixer_forward(cfg: TapirConfig, p, x: torch.Tensor) -> torch.Tensor:
    """PIPSMLPMixer: [B, T, in_dim] -> [B, T, out_dim]."""
    H = cfg.mixer_hidden_dim
    x = x @ p["mx.in_w"] + p["mx.in_b"]
    for i in range(cfg.num_mixer_blocks):
        pre = f"mx{i}."
        skip = x
        h = _layernorm(x, p[pre + "ln_w"])
        h = _gelu_tanh(_depthwise_conv1d(h, p[pre + "up1_w"], p[pre + "up1_b"], groups=H))
        h = _depthwise_conv1d(h, p[pre + "up2_w"], p[pre + "up2_b"], groups=H * 4)
        h = h.reshape(h.shape[:-1] + (H, 4)).sum(-1)     # each group of 4 back to H channels
        x = h + skip
        skip = x
        h = _gelu_tanh(_layernorm(x, p[pre + "ln1_w"]) @ p[pre + "mlp_up_w"] + p[pre + "mlp_up_b"])
        x = h @ p[pre + "mlp_down_w"] + p[pre + "mlp_down_b"] + skip
    x = _layernorm(x, p["mx.ln_w"])
    return x @ p["mx.out_w"] + p["mx.out_b"]


_CTX = np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4), indexing="ij"), -1).reshape(-1, 2)  # (dy, dx)


def refine_pips(cfg: TapirConfig, p, queries: Sequence[torch.Tensor], pyramid: Sequence[torch.Tensor],
                points: torch.Tensor, occ: torch.Tensor, expd: torch.Tensor, last_iter: Optional[torch.Tensor]):
    """One PIPs iteration: (points, occ, expd, mixer features)."""
    ih, iw = cfg.initial_resolution
    ctx = torch.as_tensor(_CTX, dtype=points.dtype, device=points.device)
    corrs = []
    for lvl, (query, grid) in enumerate(zip(queries, pyramid)):
        T, h, w, C = grid.shape
        coords = points * torch.tensor([w / iw, h / ih], dtype=points.dtype, device=points.device)
        coords = coords.flip(-1)                                       # (y, x)
        neighborhood = _sample_frames_bilinear(grid, coords[:, :, None, :] + ctx[None, None], border=False)
        if last_iter is None:
            patches = torch.einsum("ntsc,nc->nts", neighborhood, query)
        else:
            lq = last_iter[..., : cfg.highres_dim] if lvl == 0 else last_iter[..., cfg.highres_dim:]
            patches = torch.einsum("ntsc,ntc->nts", neighborhood, lq)
        corrs.append(patches)
    corrs = torch.cat(corrs, dim=-1)                                   # [N, T, 49 L]

    T = corrs.shape[1]
    if last_iter is None:
        both = torch.cat([queries[0], queries[1]], dim=-1)             # [N, 384]
        feats_in = both[:, None].expand(both.shape[0], T, both.shape[1])
    else:
        feats_in = last_iter
    # the position input is zeroed, as in the reference
    mlp_input = torch.cat([torch.zeros_like(points), occ[..., None], expd[..., None], feats_in, corrs], dim=-1)
    res = mixer_forward(cfg, p, mlp_input)                             # [N, T, 388]
    return points + res[..., :2], occ + res[..., 2], expd + res[..., 3], res[..., 4:] + feats_in


# ---- the whole pass -------------------------------------------------------------------


def _avg_pool_hw(x: torch.Tensor) -> torch.Tensor:
    T, h, w, C = x.shape
    return x[:, : h // 2 * 2, : w // 2 * 2].reshape(T, h // 2, 2, w // 2, 2, C).mean(dim=(2, 4))


# the grids kept by an open `_grids_once` scope: [cfg, video, grids], [] before the first pass
_memo = threading.local()


@contextlib.contextmanager
def _grids_once():
    """Within the scope, the first `forward` on a video computes its grids
    and later ones on the same tensor (and config) reuse them; they are
    dropped when the scope exits. Counts `tapir.grids` and
    `tapir.grids_reused` while spans record."""
    prev = getattr(_memo, "kept", None)
    _memo.kept = []
    try:
        yield
    finally:
        _memo.kept = prev


def _feature_grids(cfg: TapirConfig, p, video: torch.Tensor):
    kept = getattr(_memo, "kept", None)
    if kept and kept[0] is cfg and kept[1] is video:
        _spans.count("tapir.grids_reused")
        return kept[2]
    grids = get_feature_grids(cfg, p, video)
    _spans.count("tapir.grids")
    if kept is not None:
        kept[:] = [cfg, video, grids]
    return grids


def forward(cfg: TapirConfig, p, video: torch.Tensor, query_points: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Track query points [N, 3] (t, y, x, video raster) through video [T,
    H, W, 3] in [-1, 1]: `TAPIR.forward` for the production configuration
    (square inference resolution, one feature grid for the initialisation
    and the PIPs iterations). Inside `_grids_once` the video's grids are
    computed once for every call on it."""
    T, H, W, _ = video.shape
    ih, iw = cfg.initial_resolution
    lowres, hires = _feature_grids(cfg, p, video)
    lh, lw = lowres.shape[1:3]
    hh, hw = hires.shape[1:3]
    scale = lambda *s: torch.tensor(s, dtype=query_points.dtype, device=query_points.device)

    q_lo = _sample_trilinear(lowres, query_points * scale(1.0, lh / H, lw / W))
    q_hi = _sample_trilinear(hires, query_points * scale(1.0, hh / H, hw / W))
    points, occ, expd = tracks_from_cost_volume(cfg, p, q_lo, lowres, query_points * scale(1.0, ih / H, iw / W))

    queries = [q_hi, q_lo] + [q_lo] * cfg.pyramid_level
    pyramid = [hires, lowres]
    for _ in range(cfg.pyramid_level):
        pyramid.append(_avg_pool_hw(pyramid[-1]))
    mixer_feats = None
    for _ in range(cfg.num_pips_iter):
        points, occ, expd, mixer_feats = refine_pips(cfg, p, queries, pyramid, points, occ, expd, mixer_feats)
    return {
        "tracks": points * scale(W / iw, H / ih),   # [N, T, 2] (x, y), video raster
        "occlusion": occ,                            # [N, T] logits (higher = occluded)
        "expected_dist": expd,                       # [N, T] uncertainty logits
    }


# ---- the model and its driver ---------------------------------------------------------


class Tapir(ParamModule):
    """The network as a module: `Tapir(cfg, params)(video, query_points)`;
    `pretrained` says whether the weights came from a checkpoint."""

    def __init__(self, cfg: TapirConfig, params: Dict[str, np.ndarray], pretrained: bool = False):
        super().__init__(params)
        self.cfg = cfg
        self.pretrained = pretrained

    @torch.no_grad()
    def forward(self, video: torch.Tensor, query_points: torch.Tensor) -> Dict[str, torch.Tensor]:
        return forward(self.cfg, self.params, video, query_points)


def save_params(path: str, params: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def _default_weight_paths() -> List[str]:
    paths = []
    env = os.environ.get("SPLAT_TAPIR_WEIGHTS")
    if env:
        paths.append(env)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths.append(os.path.join(pkg, "weights", "tapir.npz"))
    return paths


def get_model(cfg: Optional[TapirConfig] = None, device="cuda") -> Optional[Tapir]:
    """The converted checkpoint on `device` if one is present, else None."""
    dev = resolve_device(device)
    cfg = cfg or TapirConfig()
    for path in _default_weight_paths():
        if os.path.exists(path):
            with np.load(path) as z:
                raw = {k: z[k] for k in z.files}
            return Tapir(cfg, raw, pretrained=True).to(dev)
    return None


def track_points(model: Tapir, video_u8: np.ndarray, query_points: np.ndarray,
                 chunk: int = 128) -> Dict[str, np.ndarray]:
    """uint8 video [T, H, W, 3] and (t, y, x) queries -> tracks in the
    original video raster, on the model's device. Queries go in chunks of
    `chunk`, the last padded to the chunk and its pad dropped (the JAX
    package's fixed shapes, kept so both packages run the same batches);
    the video's feature grids are computed for the first chunk and reused
    by the others."""
    dev = model.device
    video = torch.as_tensor(np.asarray(video_u8, np.float32), device=dev) / 255.0 * 2.0 - 1.0
    n = query_points.shape[0]
    outs: Dict[str, List[np.ndarray]] = {"tracks": [], "occlusion": [], "expected_dist": []}
    with _grids_once():
        for s in range(0, n, chunk):
            q = query_points[s:s + chunk].astype(np.float32)
            pad = chunk - q.shape[0]
            if pad:
                q = np.concatenate([q, np.zeros((pad, 3), np.float32)])
            res = model(video, torch.from_numpy(q).to(dev))
            for k in outs:
                outs[k].append(res[k][: chunk - pad].cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}
