"""Binning and blend kernels for the GPU (counterpart of
`splatter_a_video_tpu/ops/rasterize_tpu.py`).

Holds the ctypes bindings of the two hand-written CUDA kernels, their
plain PyTorch versions, their launch counters and `splat_scene`:

  K1 `blend_forward` (csrc/blend_forward.cu) replaces `_fwd_kernel`;
  K2 `expand_intersections` (csrc/expand_intersections.cu) replaces
     `binning._monotone_expand_pallas`.

Each wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back. Kernels run
on the current stream, do not synchronise and allocate nothing: the
wrappers allocate the outputs.

Forward only: `splat_scene` goes through an autograd Function whose
backward raises, so no gradient can come silently out of the plain path
before the backward kernel exists.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from . import binning as _binning
from .projection import tile_grid

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
MAX_CHANNELS = 32   # MAX_C of csrc/blend_forward.cu
INT64_MAX = (1 << 63) - 1

# launches of each kernel since the counts were last set to 0
LAUNCHES = {"blend_forward": 0, "expand_intersections": 0}

_ARGTYPES = {
    "blend_forward": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5,
    "expand_intersections": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
}


def _kernel(name: str):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> int:
    """Validate a kernel argument; returns its device pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _launch(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported (CPU or CUDA only)")


# --------------------------------------------------------------------------
# K2: expand_intersections
# --------------------------------------------------------------------------


def expand_intersections_plain(offs, tiles, rect_min, rect_max, depth, M: int, tgx: int):
    """Plain version of K2: the same (key, gid) slots by repeat_interleave."""
    dev = offs.device
    N = tiles.shape[0]
    keys = torch.full((M,), INT64_MAX, dtype=torch.int64, device=dev)
    gid = torch.full((M,), -1, dtype=torch.int32, device=dev)
    owner = torch.repeat_interleave(torch.arange(N, device=dev), tiles.clamp_min(0).long())[:M]
    n = owner.shape[0]
    j = torch.arange(n, device=dev) - offs.long()[owner]
    rmx = rect_min[owner, 0].long()
    rmy = rect_min[owner, 1].long()
    rw = (rect_max[owner, 0].long() - rmx).clamp_min(1)
    tile = (rmy + j // rw) * tgx + (rmx + j % rw)
    bits = torch.where(depth > 0, depth, 0.0).view(torch.int32).long()
    keys[:n] = (tile << 32) | bits[owner]
    gid[:n] = owner.to(torch.int32)
    return keys, gid


def expand_intersections(offs, tiles, rect_min, rect_max, depth, M: int, tgx: int):
    """Slot keys and owners of the ragged expansion (see csrc/expand_intersections.cu).

    offs/tiles: [N] int32 exclusive prefix and clamped counts; rect_min,
    rect_max: [N, 2] int32; depth: [N] f32. Returns (keys [M] int64,
    gid [M] int32); slots beyond the expansion hold INT64_MAX and -1.
    """
    if offs.device.type == "cpu":
        return expand_intersections_plain(offs, tiles, rect_min, rect_max, depth, M, tgx)
    _require_cuda(offs, "expand_intersections")
    dev = offs.device
    N = tiles.shape[0]
    ptrs = [
        _check(offs, "offs", torch.int32, (N,), dev),
        _check(tiles, "tiles", torch.int32, (N,), dev),
        _check(rect_min, "rect_min", torch.int32, (N, 2), dev),
        _check(rect_max, "rect_max", torch.int32, (N, 2), dev),
        _check(depth, "depth", torch.float32, (N,), dev),
    ]
    keys = torch.empty((M,), dtype=torch.int64, device=dev)
    gid = torch.empty((M,), dtype=torch.int32, device=dev)
    _launch(
        "expand_intersections", *ptrs, N, M, tgx, keys.data_ptr(), gid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return keys, gid


# --------------------------------------------------------------------------
# K1: blend_forward
# --------------------------------------------------------------------------


def _untile(x: torch.Tensor, tgx: int, tgy: int, tw: int, th: int, W: int, H: int):
    """[T, tw*th, c] tile-major pixels -> [H, W, c] image."""
    c = x.shape[-1]
    x = x.reshape(tgy, tgx, th, tw, c).permute(0, 2, 1, 3, 4)
    return x.reshape(tgy * th, tgx * tw, c)[:H, :W]


def blend_forward_plain(
    gid, edges, uv, conic, opacity, features, bg, W: int, H: int,
    tile: Tuple[int, int] = (16, 16), K_idx: int = 0, opacity_bias=None,
):
    """Plain version of K1 with the same arithmetic, step by step.

    Loops over depth rank k = 0 .. longest tile range - 1, vectorised over
    all tiles x pixels: step k gathers the k-th Gaussian of every tile
    (masked where k is past the tile's range) and applies the sequential
    rule of the oracle.
    """
    dev = uv.device
    tw, th = tile
    tgx, tgy = tile_grid(W, H, tile)
    T, P, C = tgx * tgy, tw * th, features.shape[1]
    t = torch.arange(T, device=dev)[:, None]
    p = torch.arange(P, device=dev)[None, :]
    pxf = ((t % tgx) * tw + p % tw).to(torch.float32)
    pyf = ((t // tgx) * th + p // tw).to(torch.float32)
    start = edges[:-1].long()
    count = (edges[1:] - edges[:-1]).long()

    Tr = torch.ones((T, P), dtype=torch.float32, device=dev)
    F = torch.zeros((T, P, C), dtype=torch.float32, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    cnt = torch.zeros((T, P), dtype=torch.int32, device=dev)
    gs = torch.full((T, P, K_idx), -1, dtype=torch.int32, device=dev)
    k_iota = torch.arange(K_idx, device=dev)
    steps = int(count.max()) if T > 0 else 0
    for k in range(steps):
        has = k < count
        g = torch.where(has, gid[(start + k).clamp_max(gid.shape[0] - 1)].long(), 0)
        vx = uv[g, 0][:, None] - pxf
        vy = uv[g, 1][:, None] - pyf
        power = -0.5 * (conic[g, 0][:, None] * (vx * vx) + conic[g, 2][:, None] * (vy * vy)) - (
            conic[g, 1][:, None] * vx * vy
        )
        raw = opacity[g][:, None] * torch.exp(power)
        if opacity_bias is not None:
            raw = raw + opacity_bias[g][:, None]
        alpha = torch.clamp_max(raw, ALPHA_MAX)
        valid = has[:, None] & (power <= 0) & (alpha >= ALPHA_MIN) & ~done
        next_T = Tr * (1.0 - alpha)
        term = valid & (next_T < T_EPS)
        applied = valid & ~term
        w = torch.where(applied, alpha * Tr, 0.0)
        F = F + w[..., None] * features[g][:, None, :]
        Tr = torch.where(applied, next_T, Tr)
        done = done | term
        if K_idx:
            sel = (applied & (cnt < K_idx))[..., None] & (k_iota == cnt[..., None])
            gs = torch.where(sel, g.to(torch.int32)[:, None, None], gs)
        cnt = cnt + applied.to(torch.int32)

    image = F + Tr[..., None] * bg
    return (
        _untile(image, tgx, tgy, tw, th, W, H),
        _untile(Tr[..., None], tgx, tgy, tw, th, W, H)[..., 0],
        _untile(cnt[..., None], tgx, tgy, tw, th, W, H)[..., 0],
        _untile(gs, tgx, tgy, tw, th, W, H),
    )


def blend_forward(
    gid, edges, uv, conic, opacity, features, bg, W: int, H: int,
    tile: Tuple[int, int] = (16, 16), K_idx: int = 0, opacity_bias=None,
):
    """Blend the binned Gaussians (see csrc/blend_forward.cu).

    gid [M] int32 tile-sorted ids and edges [T+1] int32 from binning;
    uv [N,2], conic [N,3], opacity [N], features [N,C], opacity_bias [N]
    or None, bg [C], all f32. Returns (image [H,W,C], final_T [H,W],
    ncontrib [H,W] int32, gs_idx [H,W,K_idx] int32).
    """
    if uv.device.type == "cpu":
        return blend_forward_plain(
            gid, edges, uv, conic, opacity, features, bg, W, H, tile, K_idx, opacity_bias
        )
    _require_cuda(uv, "blend_forward")
    dev = uv.device
    tw, th = tile
    tgx, tgy = tile_grid(W, H, tile)
    N, C = features.shape
    if not 0 < tw * th <= 1024:
        raise ValueError(f"tile {tile}: tw*th must be in 1..1024")
    if C > MAX_CHANNELS:
        raise ValueError(f"{C} channels > {MAX_CHANNELS}, the most blend_forward takes")
    ptrs = [
        _check(gid, "gid", torch.int32, gid.shape[:1], dev),
        _check(edges, "edges", torch.int32, (tgx * tgy + 1,), dev),
        _check(uv, "uv", torch.float32, (N, 2), dev),
        _check(conic, "conic", torch.float32, (N, 3), dev),
        _check(opacity, "opacity", torch.float32, (N,), dev),
        _check(features, "features", torch.float32, (N, C), dev),
        None if opacity_bias is None else _check(opacity_bias, "opacity_bias", torch.float32, (N,), dev),
        _check(bg, "bg", torch.float32, (C,), dev),
    ]
    image = torch.empty((H, W, C), dtype=torch.float32, device=dev)
    final_T = torch.empty((H, W), dtype=torch.float32, device=dev)
    ncontrib = torch.empty((H, W), dtype=torch.int32, device=dev)
    gs_idx = torch.empty((H, W, K_idx), dtype=torch.int32, device=dev)
    _launch(
        "blend_forward", *ptrs, C, W, H, tw, th, K_idx,
        image.data_ptr(), final_T.data_ptr(), ncontrib.data_ptr(),
        gs_idx.data_ptr() if K_idx else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return image, final_T, ncontrib, gs_idx


# --------------------------------------------------------------------------
# bin + blend
# --------------------------------------------------------------------------


class _Splat(torch.autograd.Function):
    """Forward-only blend; the backward kernel comes with the training slice."""

    @staticmethod
    def forward(ctx, gid, edges, uv, conic, opacity, features, opacity_bias, bg, W, H, tile, K_idx):
        image, final_T, ncontrib, gs_idx = blend_forward(
            gid, edges, uv, conic, opacity, features, bg, W, H, tile, K_idx, opacity_bias
        )
        ctx.mark_non_differentiable(ncontrib, gs_idx)
        return image, final_T, ncontrib, gs_idx

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("training slice")


def splat_scene(
    uv: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    features: torch.Tensor,
    depth: torch.Tensor,
    tiles: torch.Tensor,
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    *,
    W: int,
    H: int,
    bg,
    K_idx: int = 0,
    max_intersections: int = 1 << 19,
    max_tiles_per_gaussian: int = 64,
    block: Tuple[int, int] = (16, 16),
    opacity_bias: Optional[torch.Tensor] = None,
):
    """Bin, sort and blend pre-projected Gaussians (forward only).

    Returns (image [H,W,C], final_T [H,W], ncontrib [H,W] int32,
    gs_idx [H,W,K] int32 | None, num_intersections [] int32). `bg` is
    per-channel; `opacity_bias` [N] engages alpha = min(.99, op*G + bias).

    Rects must respect `max_tiles_per_gaussian` (clamp the EWA radius with
    `projection.max_radius_for_tile_cap`, as `rasterize.render_gaussians`
    does): an oversized rect keeps only its first tiles in row-major order.
    Budget overflow is reported, not hidden: `num_intersections` is the
    true count and may exceed `max_intersections`.
    """
    b = _binning.bin_intersections(
        depth.detach(), tiles, rect_min, rect_max, W, H,
        max_intersections=max_intersections,
        max_tiles_per_gaussian=max_tiles_per_gaussian, block=block,
    )
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=uv.device).reshape(-1)
    bias = None if opacity_bias is None else opacity_bias.contiguous()
    image, final_T, ncontrib, gs_idx = _Splat.apply(
        b.gid, b.edges, uv.contiguous(), conic.contiguous(), opacity.contiguous(),
        features.contiguous(), bias, bg_t, W, H, tuple(block), K_idx,
    )
    return image, final_T, ncontrib, (gs_idx if K_idx else None), b.num_intersections
