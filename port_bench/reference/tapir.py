"""BootsTAPIR's inference, plain: the reference that `correct` holds the
program's dense tracking to (the tracks entry, `entries/tracks.py`).

Written from the published description (TAPIR, arXiv 2306.08637, with
BootsTAPIR's additions, arXiv 2402.00847; the tapnet repository's layer
definitions) in float32 PyTorch with TF32 off, and from nothing of the
program. Its parts:

  * the feature grids: a ResNet-v2 trunk (pre-activation blocks with
    instance norm, a 1x1 projection on each group's first block, TensorFlow
    "SAME" padding) whose stride-4 output gives the 128-channel high-res grid
    and whose stride-8 output, through BootsTAPIR's ExtraConvs (layer norm,
    3x3 up to 4x the width, tanh-GELU, 3x3 back, added to the normed input),
    the 256-channel low-res grid, both L2-normalised per position;
  * the query features: trilinear samples of both grids at the query's
    frame and position (border clamped);
  * the initialisation: the cost volume of the low-res query feature
    against every frame's low-res grid, two 3x3 convolutions to a heatmap, a
    softmax at temperature 20 and a soft argmax within 5 cells of the
    argmax; an occlusion head (a stride-2 3x3 convolution, the spatial mean,
    two linears) for the occlusion and expected-distance logits;
  * the PIPs refinement, 4 iterations: 7x7 bilinear neighbourhoods at three
    levels (high-res, low-res, low-res pooled 2x2), correlated with the
    query features (later iterations: with the last iteration's features),
    fed with the features and the logits to a 12-block MLP-mixer (layer norm
    without bias; depthwise temporal convolutions 1 -> 4 channels, tanh-GELU,
    4 -> 4, the four summed; a channel MLP of 4x the width), whose output
    adds to the points, the logits and the features.

Samplers read a coordinate c at the continuous index c - 0.5 (pixel centres
at +0.5), through `F.grid_sample` with `align_corners=False`, each axis
normalised by its own size; the neighbourhoods pad with zeros.

Where it follows the program's documented choices rather than a detail the
description leaves open: each axis of a sampler normalised by its own size
(the tapnet torch port normalises both by the height, the same on the square
grids here); the position input of the mixer zeroed; the query frame's
initial point snapped to the query; frames at the inference resolution
already (the benchmark resizes them as `compute_tracks` does).

Weights are the benchmark's own draw (`draw_params`), under the names and
layouts of the JAX package's TAPIR (convolutions HWIO, linears [in, out],
depthwise kernels [k, 1, out]), which the program takes as loaded weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RADIUS = 3                      # a 7x7 neighbourhood
ARGMAX_RADIUS = 5.0             # the soft argmax's window, in grid cells
LN_EPS = 1e-5
NORM_EPS = 1e-12


# ---- the weights' names, shapes and draw --------------------------------------------------


def param_shapes(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight of the model `m` (the
    configuration's `model`); kind is `w` (a kernel or a linear, drawn with
    fan-in scaling), `dw` (a depthwise kernel, fan-in 3), `scale` (a norm's
    scale) or `bias`."""
    out: List[Tuple[str, Tuple[int, ...], str]] = []
    ch, nb = m["channels_per_group"], m["blocks_per_group"]
    out.append(("initial_conv_w", (7, 7, 3, ch[0]), "w"))
    cin = ch[0]
    for g, (n, cout) in enumerate(zip(nb, ch)):
        for b in range(n):
            pre, c = f"r{g}.{b}.", (cin if b == 0 else cout)
            out += [(pre + "bn0_w", (c,), "scale"), (pre + "bn0_b", (c,), "bias"),
                    (pre + "conv0_w", (3, 3, c, cout), "w"),
                    (pre + "bn1_w", (cout,), "scale"), (pre + "bn1_b", (cout,), "bias"),
                    (pre + "conv1_w", (3, 3, cout, cout), "w")]
            if b == 0:
                out.append((pre + "proj_w", (1, 1, c, cout), "w"))
        cin = cout
    C = m["lowres_dim"]
    for i in range(m["extra_convs"]):
        pre = f"ec{i}."
        out += [(pre + "ln_w", (C,), "scale"), (pre + "ln_b", (C,), "bias"),
                (pre + "conv0_w", (3, 3, C, 4 * C), "w"), (pre + "conv0_b", (4 * C,), "bias"),
                (pre + "conv1_w", (3, 3, 4 * C, C), "w"), (pre + "conv1_b", (C,), "bias")]
    out += [("cv.hid1_w", (3, 3, 1, 16), "w"), ("cv.hid1_b", (16,), "bias"),
            ("cv.hid2_w", (3, 3, 16, 1), "w"), ("cv.hid2_b", (1,), "bias"),
            ("cv.hid3_w", (3, 3, 16, 32), "w"), ("cv.hid3_b", (32,), "bias"),
            ("cv.hid4_w", (32, 16), "w"), ("cv.hid4_b", (16,), "bias"),
            ("cv.occ_w", (16, 2), "w"), ("cv.occ_b", (2,), "bias")]
    H = m["mixer_hidden_dim"]
    feat = m["highres_dim"] + m["lowres_dim"]
    mix_out = 4 + feat
    mix_in = mix_out + (m["pyramid_level"] + 2) * (2 * RADIUS + 1) ** 2
    out += [("mx.in_w", (mix_in, H), "w"), ("mx.in_b", (H,), "bias")]
    for i in range(m["num_mixer_blocks"]):
        pre = f"mx{i}."
        out += [(pre + "ln_w", (H,), "scale"),
                (pre + "up1_w", (3, 1, 4 * H), "dw"), (pre + "up1_b", (4 * H,), "bias"),
                (pre + "up2_w", (3, 1, 4 * H), "dw"), (pre + "up2_b", (4 * H,), "bias"),
                (pre + "ln1_w", (H,), "scale"),
                (pre + "mlp_up_w", (H, 4 * H), "w"), (pre + "mlp_up_b", (4 * H,), "bias"),
                (pre + "mlp_down_w", (4 * H, H), "w"), (pre + "mlp_down_b", (H,), "bias")]
    out += [("mx.ln_w", (H,), "scale"), ("mx.out_w", (H, mix_out), "w"), ("mx.out_b", (mix_out,), "bias")]
    return out


def _fan_in(name: str, shape: Tuple[int, ...], kind: str) -> int:
    if kind == "dw":
        return shape[0]
    return math.prod(shape[:-1])


@torch.no_grad()
def draw_params(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random weights from `seed` on `device`: one normal draw for all of
    them, each kernel and linear scaled by its fan-in, norm scales 1 + 0.1 z,
    biases 0.1 z (views into the one block)."""
    shapes = param_shapes(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if kind == "scale":
            v.mul_(0.1).add_(1.0)
        elif kind == "bias":
            v.mul_(0.1)
        else:
            v.mul_(1.0 / math.sqrt(_fan_in(name, shape, kind)))
        out[name] = v
    return out


# ---- layers ----------------------------------------------------------------------------


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w_hwio: torch.Tensor, b: Optional[torch.Tensor] = None,
              stride: int = 1) -> torch.Tensor:
    """A convolution with TensorFlow's "SAME" padding, NCHW, of an HWIO kernel."""
    k = w_hwio.shape[0]
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, stride=stride)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _l2n(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(dim, keepdim=True), NORM_EPS))


def _block(p, pre: str, x: torch.Tensor, stride: int, proj: bool) -> torch.Tensor:
    """A pre-activation ResNet-v2 block with instance norm."""
    h = F.relu(F.instance_norm(x, weight=p[pre + "bn0_w"], bias=p[pre + "bn0_b"], eps=LN_EPS))
    short = conv_same(h, p[pre + "proj_w"], stride=stride) if proj else x
    h = conv_same(h, p[pre + "conv0_w"], stride=stride)
    h = F.relu(F.instance_norm(h, weight=p[pre + "bn1_w"], bias=p[pre + "bn1_b"], eps=LN_EPS))
    return conv_same(h, p[pre + "conv1_w"]) + short


def trunk(m: dict, p, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames [B, 3, H, W] in [-1, 1] -> (stride-4 map of group 1, stride-8
    map of the last group), NCHW."""
    x = conv_same(frames, p["initial_conv_w"], stride=2)
    units = []
    for g, (n, s) in enumerate(zip(m["blocks_per_group"], m["strides"])):
        for b in range(n):
            x = _block(p, f"r{g}.{b}.", x, s if b == 0 else 1, b == 0)
        units.append(x)
    return units[1], units[-1]


def extra_convs(m: dict, p, x: torch.Tensor) -> torch.Tensor:
    """BootsTAPIR's ExtraConvs on [B, C, h, w]."""
    for i in range(m["extra_convs"]):
        pre = f"ec{i}."
        h = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), p[pre + "ln_w"], p[pre + "ln_b"], LN_EPS)
        h = h.permute(0, 3, 1, 2)
        x = h + conv_same(_gelu(conv_same(h, p[pre + "conv0_w"], p[pre + "conv0_b"])),
                          p[pre + "conv1_w"], p[pre + "conv1_b"])
    return x


def feature_grids(m: dict, p, video_u8: torch.Tensor, frames_per_pass: int = 8, skip_extra: bool = False,
                  dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 video [T, H, W, 3] at the inference resolution -> (high-res
    [T, 128, H/4, W/4], low-res [T, 256, H/8, W/8]), L2-normalised, NCHW.
    `skip_extra` and `dtype` (the grids rounded to it) plant faults."""
    ih, iw = m["initial_resolution"]
    if tuple(video_u8.shape[1:3]) != (ih, iw):
        raise ValueError(f"frames of {tuple(video_u8.shape[1:3])}, the model reads {ih}x{iw}")
    his, los = [], []
    for s in range(0, video_u8.shape[0], frames_per_pass):
        v = video_u8[s:s + frames_per_pass].permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
        hi, lo = trunk(m, p, v)
        his.append(hi)
        los.append(lo)
    hi, lo = torch.cat(his), torch.cat(los)
    if not skip_extra:
        lo = extra_convs(m, p, lo)
    hi, lo = _l2n(hi, 1), _l2n(lo, 1)
    if dtype is not None:
        hi, lo = hi.to(dtype).float(), lo.to(dtype).float()
    return hi, lo


# ---- samplers --------------------------------------------------------------------------


def _norm(c: torch.Tensor, size: int) -> torch.Tensor:
    """A coordinate c (index c - 0.5) as `grid_sample`'s [-1, 1], align_corners=False."""
    return 2.0 * c / size - 1.0


def query_features(grid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of grid [T, C, h, w] at q [N, 3] (t, y, x) in grid
    units (t at frame centres), border clamped: [N, C]."""
    T, C, h, w = grid.shape
    vol = grid.permute(1, 0, 2, 3)[None]                                   # [1, C, T, h, w]
    g = torch.stack([_norm(q[:, 2], w), _norm(q[:, 1], h), _norm(q[:, 0] + 0.5, T)], -1)
    out = F.grid_sample(vol, g[None, None, None], mode="bilinear", padding_mode="border", align_corners=False)
    return out[0, :, 0, 0].T


def neighbourhoods(grid: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of grid [T, C, h, w] around xy [N, T, 2] (x, y) in
    grid units, a (2R+1)^2 window of unit steps, zeros outside: [N, T, S, C]."""
    T, C, h, w = grid.shape
    r = torch.arange(-RADIUS, RADIUS + 1, device=xy.device, dtype=xy.dtype)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    off = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)                # [S, 2] (x, y), y-major
    pts = xy[:, :, None, :] + off                                          # [N, T, S, 2]
    g = torch.stack([_norm(pts[..., 0], w), _norm(pts[..., 1], h)], -1).permute(1, 0, 2, 3)  # [T, N, S, 2]
    out = F.grid_sample(grid, g, mode="bilinear", padding_mode="zeros", align_corners=False)  # [T, C, N, S]
    return out.permute(2, 0, 3, 1)


# ---- the initialisation ------------------------------------------------------------------


def soft_argmax(heat: torch.Tensor) -> torch.Tensor:
    """heat [..., h, w] (a softmax) -> the weighted mean position (x, y) of
    the cells within `ARGMAX_RADIUS` of the argmax, cell centres at +0.5."""
    h, w = heat.shape[-2:]
    flat = heat.reshape(heat.shape[:-2] + (h * w,))
    am = flat.argmax(-1)
    ay, ax = (am // w).to(heat.dtype), (am % w).to(heat.dtype)
    ys = torch.arange(h, device=heat.device, dtype=heat.dtype)
    xs = torch.arange(w, device=heat.device, dtype=heat.dtype)
    d2 = (ys[:, None] - ay[..., None, None]) ** 2 + (xs[None, :] - ax[..., None, None]) ** 2
    wgt = heat * (d2 < ARGMAX_RADIUS ** 2).to(heat.dtype)
    den = torch.clamp_min(wgt.sum((-2, -1)), NORM_EPS)
    x = (wgt * (xs + 0.5)).sum((-2, -1)) / den
    y = (wgt * (ys + 0.5)[:, None]).sum((-2, -1)) / den
    return torch.stack([x, y], -1)


def initialise(m: dict, p, q_lo: torch.Tensor, lo: torch.Tensor, q_frames: torch.Tensor,
               q_yx: torch.Tensor):
    """The cost-volume initialisation of N queries: (points [N, T, 2] (x, y)
    in the inference raster, occlusion [N, T], expected distance [N, T])."""
    T, C, h, w = lo.shape
    N = q_lo.shape[0]
    ih, iw = m["initial_resolution"]
    cost = torch.einsum("nc,tchw->nthw", q_lo, lo).reshape(N * T, 1, h, w)
    hid = F.relu(conv_same(cost, p["cv.hid1_w"], p["cv.hid1_b"]))
    heat = conv_same(hid, p["cv.hid2_w"], p["cv.hid2_b"]).reshape(N, T, h * w)
    heat = torch.softmax(heat * m["softmax_temperature"], -1).reshape(N, T, h, w)
    pts = soft_argmax(heat) * torch.tensor([iw / w, ih / h], device=lo.device)
    at_query = (torch.arange(T, device=lo.device)[None, :] == torch.round(q_frames)[:, None])[..., None]
    pts = torch.where(at_query, q_yx.flip(-1)[:, None, :], pts)
    o = F.relu(conv_same(hid, p["cv.hid3_w"], p["cv.hid3_b"], stride=2)).mean((2, 3))
    o = F.relu(o @ p["cv.hid4_w"] + p["cv.hid4_b"]) @ p["cv.occ_w"] + p["cv.occ_b"]
    o = o.reshape(N, T, 2)
    return pts, o[..., 0], o[..., 1]


# ---- the refinement ----------------------------------------------------------------------


def mixer(m: dict, p, x: torch.Tensor) -> torch.Tensor:
    """The PIPs MLP-mixer over [N, T, in] -> [N, T, out]."""
    H = m["mixer_hidden_dim"]
    x = x @ p["mx.in_w"] + p["mx.in_b"]
    for i in range(m["num_mixer_blocks"]):
        pre = f"mx{i}."
        h = F.layer_norm(x, (H,), p[pre + "ln_w"], None, LN_EPS).transpose(1, 2)      # [N, H, T]
        h = _gelu(F.conv1d(h, p[pre + "up1_w"].permute(2, 1, 0), p[pre + "up1_b"], padding=1, groups=H))
        h = F.conv1d(h, p[pre + "up2_w"].permute(2, 1, 0), p[pre + "up2_b"], padding=1, groups=4 * H)
        h = h.reshape(h.shape[0], H, 4, h.shape[-1]).sum(2).transpose(1, 2)           # the four summed
        x = x + h
        h = F.layer_norm(x, (H,), p[pre + "ln1_w"], None, LN_EPS)
        x = x + _gelu(h @ p[pre + "mlp_up_w"] + p[pre + "mlp_up_b"]) @ p[pre + "mlp_down_w"] + p[pre + "mlp_down_b"]
    x = F.layer_norm(x, (H,), p["mx.ln_w"], None, LN_EPS)
    return x @ p["mx.out_w"] + p["mx.out_b"]


def track(m: dict, p, grids: Tuple[torch.Tensor, torch.Tensor], queries: torch.Tensor,
          pips_iters: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Queries [N, 3] (t, y, x) in the inference raster -> tracks [N, T, 2]
    (x, y) in that raster, occlusion and expected-distance logits [N, T].
    `pips_iters` below the model's plants a fault."""
    hi, lo = grids
    T = lo.shape[0]
    ih, iw = m["initial_resolution"]
    D = m["highres_dim"]

    def in_grid(g):
        return queries * torch.tensor([1.0, g.shape[2] / ih, g.shape[3] / iw], device=queries.device)

    q_hi, q_lo = query_features(hi, in_grid(hi)), query_features(lo, in_grid(lo))
    pts, occ, expd = initialise(m, p, q_lo, lo, queries[:, 0], queries[:, 1:])
    levels = [hi, lo]
    for _ in range(m["pyramid_level"]):
        levels.append(F.avg_pool2d(levels[-1], 2))
    feats = torch.cat([q_hi, q_lo], -1)[:, None].expand(-1, T, -1)
    first = True
    for _ in range(m["num_pips_iter"] if pips_iters is None else pips_iters):
        corr = []
        for lvl, g in enumerate(levels):
            xy = pts * torch.tensor([g.shape[3] / iw, g.shape[2] / ih], device=pts.device)
            nb = neighbourhoods(g, xy)                                        # [N, T, S, C]
            if first:
                qf = q_hi if lvl == 0 else q_lo
                corr.append(torch.einsum("ntsc,nc->nts", nb, qf))
            else:
                qf = feats[..., :D] if lvl == 0 else feats[..., D:]
                corr.append(torch.einsum("ntsc,ntc->nts", nb, qf))
        x = torch.cat([torch.zeros_like(pts), occ[..., None], expd[..., None], feats] + corr, -1)
        res = mixer(m, p, x)
        pts, occ, expd = pts + res[..., :2], occ + res[..., 2], expd + res[..., 3]
        feats = res[..., 4:] + feats
        first = False
    return {"tracks": pts, "occlusion": occ, "expected_dist": expd}


@torch.no_grad()
def run(m: dict, p, video_u8: torch.Tensor, queries: torch.Tensor, block: int = 128, **fault) -> Dict[str, torch.Tensor]:
    """The reference over all `queries`, `block` at a time, the grids once."""
    grids = feature_grids(m, p, video_u8, skip_extra=fault.get("skip_extra", False), dtype=fault.get("dtype"))
    outs = [track(m, p, grids, queries[s:s + block], fault.get("pips_iters")) for s in range(0, len(queries), block)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
