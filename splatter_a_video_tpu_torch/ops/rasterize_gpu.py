"""Binning and blend kernels for the GPU (counterpart of
`splatter_a_video_tpu/ops/rasterize_tpu.py`).

Holds the ctypes bindings of the four hand-written CUDA kernels, their
plain PyTorch versions, their launch counters and `splat_scene`:

  K1 `blend_forward` (csrc/blend_forward.cu) replaces `_fwd_kernel`;
  K2 `expand_intersections` (csrc/expand_intersections.cu) replaces
     `binning._monotone_expand_pallas`;
  K3 `blend_backward` (csrc/blend_backward.cu) replaces `_bwd_kernel`;
  K4 `reduce_gaussians` (csrc/reduce_gaussians.cu) replaces the XLA
     `reduce_to_gaussians` that `_bwd_kernel` feeds.

Each wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back. Kernels run
on the current stream, do not synchronise and allocate nothing: the
wrappers allocate the outputs. K1 and K3 read each Gaussian's uv, conic,
opacity and bias as one 32-byte record that their wrappers pack
(`pack_records`). `kernel_attributes` reports the registers, spills and
shared memory of the kernel instance a launch would run.

`splat_scene` is differentiable: its autograd Function runs K1 forward
and K3 + K4 backward, with no float atomics (the same gradients from run
to run).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..device import blocking_to
from ..utils import spans as _spans
from . import _build
from . import binning as _binning
from .projection import tile_grid

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
INT64_MAX = (1 << 63) - 1

# launches of each kernel since the counts were last set to 0
LAUNCHES = {"blend_forward": 0, "expand_intersections": 0, "blend_backward": 0, "reduce_gaussians": 0}

_ARGTYPES = {
    "blend_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5,
    "expand_intersections": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
    "blend_backward": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3,
    "reduce_gaussians": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
}
# <name>_attributes(C, tw, th, int out[3]) of every kernel library
_ATTR_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _kernel(name: str, symbol: Optional[str] = None):
    fn = getattr(_build.load(name), symbol or name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES.get(symbol or name, _ATTR_ARGTYPES)
        fn.restype = ctypes.c_int
    return fn


def kernel_attributes(name: str, C: int = 0, tile: Tuple[int, int] = (16, 16)) -> dict:
    """Registers per thread, local (spill) bytes per thread and shared bytes
    per block (static + dynamic) of the instance of kernel `name` that a
    launch with C channels and `tile` runs (`cudaFuncGetAttributes`). K2
    has one instance and ignores C and tile; K4 reads C as its row count R
    and ignores tile."""
    out = (ctypes.c_int * 3)()
    rc = _kernel(name, f"{name}_attributes")(C, tile[0], tile[1], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{name}_attributes failed with CUDA error {rc}")
    return {"regs": out[0], "local_bytes": out[1], "shared_bytes": out[2]}


def pack_records(uv, conic, opacity, opacity_bias=None) -> torch.Tensor:
    """[N, 8] f32 records of K1 and K3, one 32-byte row per Gaussian:
    ux, uy, conic a, b, c, opacity, bias (0 without one), 0."""
    N = uv.shape[0]
    cols = [uv, conic, opacity.reshape(N, 1)]
    if opacity_bias is None:
        cols.append(uv.new_zeros((N, 2)))
    else:
        cols += [opacity_bias.reshape(N, 1), uv.new_zeros((N, 1))]
    return torch.cat(cols, dim=1)


def _check(t: torch.Tensor, name: str, dtype, shape, device, contiguous: bool = True) -> int:
    """Validate a kernel argument; returns its device pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _checked_records(uv, conic, opacity, opacity_bias, N: int, device) -> torch.Tensor:
    """Validate the per-Gaussian arguments of K1 / K3 and pack them; the
    kernels read only the records, so any layout will do. The records are
    freed when the wrapper returns; the caching allocator reuses them only
    for work queued after the launch on the same stream.

    A train step packs twice, in K1's wrapper and again in K3's: one
    [N, 8] copy each (4 MB at 131,000 Gaussians), which keeps the public
    wrappers taking the separate arrays and holds no records between the
    forward and the backward."""
    _check(uv, "uv", torch.float32, (N, 2), device, contiguous=False)
    _check(conic, "conic", torch.float32, (N, 3), device, contiguous=False)
    _check(opacity, "opacity", torch.float32, (N,), device, contiguous=False)
    if opacity_bias is not None:
        _check(opacity_bias, "opacity_bias", torch.float32, (N,), device, contiguous=False)
    return pack_records(uv, conic, opacity, opacity_bias)


def _launch(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_tile(tile: Tuple[int, int]) -> None:
    """K1 and K3 take a tile of any size (a large one in several blocks or
    passes of at most 256 pixels), but not an empty one."""
    if min(tile) < 1:
        raise ValueError(f"tile {tile}: both sides must be at least 1")


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
    _check_tile(tile)
    rec = _checked_records(uv, conic, opacity, opacity_bias, N, dev)
    ptrs = [
        _check(gid, "gid", torch.int32, gid.shape[:1], dev),
        _check(edges, "edges", torch.int32, (tgx * tgy + 1,), dev),
        rec.data_ptr(),
        _check(features, "features", torch.float32, (N, C), dev),
        _check(bg, "bg", torch.float32, (C,), dev),
    ]
    image = torch.empty((H, W, C), dtype=torch.float32, device=dev)
    final_T = torch.empty((H, W), dtype=torch.float32, device=dev)
    ncontrib = torch.empty((H, W), dtype=torch.int32, device=dev)
    gs_idx = torch.empty((H, W, K_idx), dtype=torch.int32, device=dev)
    _launch(
        "blend_forward", *ptrs, int(opacity_bias is not None), C, W, H, tw, th, K_idx,
        image.data_ptr(), final_T.data_ptr(), ncontrib.data_ptr(),
        gs_idx.data_ptr() if K_idx else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return image, final_T, ncontrib, gs_idx


# --------------------------------------------------------------------------
# K3: blend_backward
# --------------------------------------------------------------------------


def _to_tiles(x: torch.Tensor, tgx: int, tgy: int, tw: int, th: int, W: int, H: int):
    """[H, W, c] image -> [T, tw*th, c] tile-major pixels, zero past the edge."""
    c = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, 0, 0, tgx * tw - W, 0, tgy * th - H))
    return x.reshape(tgy, th, tgx, tw, c).permute(0, 2, 1, 3, 4).reshape(tgx * tgy, tw * th, c)


def _tile_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum [T, P, R] over the P pixels of each tile in K3's order: within each
    warp of 32 pixels lane i takes lane i + 16, 8, 4, 2, 1; then the warps'
    sums are added in warp order. When P is not a multiple of 32 the last
    warp is partial: its absent lanes hold +0.0, as K3's idle threads do."""
    T, P, R = x.shape
    pad = -P % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    x = x.reshape(T, (P + pad) // 32, 32, R)
    for off in (16, 8, 4, 2, 1):
        x = x[:, :, :off] + x[:, :, off : 2 * off]
    acc = torch.zeros((T, R), dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k, 0]
    return acc


def blend_backward_plain(
    gid, edges, uv, conic, opacity, features, bg, mask, image, final_T, grad,
    W: int, H: int, tile: Tuple[int, int] = (16, 16), opacity_bias=None,
    return_ncontrib: bool = False,
):
    """Plain version of K3 with the same arithmetic and the same sums.

    Replays `blend_forward_plain` step by step (depth rank k, vectorised
    over tiles x pixels) and sums each step's per-pixel gradient terms over
    the tile with K3's tree (`_tile_tree_sum`). Rows past edges[T] are 0.
    """
    dev = uv.device
    tw, th = tile
    tgx, tgy = tile_grid(W, H, tile)
    T, P, C = tgx * tgy, tw * th, features.shape[1]
    M = gid.shape[0]
    R = 8 + C + (opacity_bias is not None)
    t = torch.arange(T, device=dev)[:, None]
    p = torch.arange(P, device=dev)[None, :]
    px = (t % tgx) * tw + p % tw
    py = (t // tgx) * th + p // tw
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    inside = (px < W) & (py < H)
    start = edges[:-1].long()
    count = (edges[1:] - edges[:-1]).long()

    g = _to_tiles(grad, tgx, tgy, tw, th, W, H)
    out = _to_tiles(image, tgx, tgy, tw, th, W, H)
    Tfin = _to_tiles(final_T[..., None], tgx, tgy, tw, th, W, H)[..., 0]
    gm = g * mask
    zero = torch.zeros((T, P), dtype=torch.float32, device=dev)
    B_all, B_op, tot_all, tot_op = zero, zero, zero, zero
    for c in range(C):
        B_all = B_all + g[..., c] * bg[c]
        B_op = B_op + gm[..., c] * bg[c]
        tot_all = tot_all + g[..., c] * out[..., c]
        tot_op = tot_op + gm[..., c] * out[..., c]
    tot_all = tot_all - Tfin * B_all
    tot_op = tot_op - Tfin * B_op

    Tr = torch.ones((T, P), dtype=torch.float32, device=dev)
    pre_all, pre_op = zero, zero
    done = ~inside
    cnt = torch.zeros((T, P), dtype=torch.int32, device=dev)
    dgrad = torch.zeros((M, R), dtype=torch.float32, device=dev)
    steps = int(count.max()) if T > 0 else 0
    for k in range(steps):
        has = k < count
        gk = torch.where(has, gid[(start + k).clamp_max(M - 1)].long(), 0)
        ca, cb, cc = (conic[gk, i][:, None] for i in range(3))
        op = opacity[gk][:, None]
        vx = uv[gk, 0][:, None] - pxf
        vy = uv[gk, 1][:, None] - pyf
        power = -0.5 * (ca * (vx * vx) + cc * (vy * vy)) - (cb * vx * vy)
        gexp = torch.exp(power)
        raw = op * gexp
        if opacity_bias is not None:
            raw = raw + opacity_bias[gk][:, None]
        alpha = torch.clamp_max(raw, ALPHA_MAX)
        valid = has[:, None] & (power <= 0) & (alpha >= ALPHA_MIN) & ~done
        next_T = Tr * (1.0 - alpha)
        term = valid & (next_T < T_EPS)
        app = valid & ~term
        w = torch.where(app, alpha * Tr, 0.0)

        f = features[gk]
        G_all, G_op = zero, zero
        for c in range(C):
            G_all = G_all + g[..., c] * f[:, None, c]
            G_op = G_op + gm[..., c] * f[:, None, c]
        pre_all = torch.where(app, pre_all + G_all * w, pre_all)
        pre_op = torch.where(app, pre_op + G_op * w, pre_op)
        one_m = 1.0 - alpha
        dal_all = G_all * Tr - ((tot_all - pre_all) + Tfin * B_all) / one_m
        dal_op = G_op * Tr - ((tot_op - pre_op) + Tfin * B_op) / one_m
        dpow = op * gexp * dal_all
        duvx = dpow * (-(ca * vx + cb * vy))
        duvy = dpow * (-(cc * vy + cb * vx))
        rows = [duvx, duvy, dpow * (-0.5 * vx * vx), dpow * (-vx * vy), dpow * (-0.5 * vy * vy),
                gexp * dal_op]
        rows += [g[..., c] * w for c in range(C)]
        rows += [torch.abs(duvx), torch.abs(duvy)]
        if opacity_bias is not None:
            rows.append(dal_op)
        rows = torch.where(app[..., None], torch.stack(rows, dim=-1), 0.0)
        dgrad[start[has] + k] = _tile_tree_sum(rows)[has]

        Tr = torch.where(app, next_T, Tr)
        done = done | term
        cnt = cnt + app.to(torch.int32)
    if return_ncontrib:
        return dgrad, _untile(cnt[..., None], tgx, tgy, tw, th, W, H)[..., 0]
    return dgrad


def blend_backward(
    gid, edges, uv, conic, opacity, features, bg, mask, image, final_T, grad,
    W: int, H: int, tile: Tuple[int, int] = (16, 16), opacity_bias=None,
    return_ncontrib: bool = False,
):
    """Per-slot gradients of the blend (see csrc/blend_backward.cu).

    gid, edges, uv, conic, opacity, features, bg and opacity_bias as for
    `blend_forward`; mask [C] alpha_grad_mask; image [H,W,C] and final_T
    [H,W] the forward's outputs; grad [H,W,C] = dL/dimage. Returns dgrad
    [M, 8+C(+1)] f32, rows in sorted-slot order (duv 2, dconic 3, dop 1,
    dfeat C, |duv| 2, [dbias 1]); rows past edges[T] are unspecified on
    the GPU. With `return_ncontrib`, also the replay's applied count [H,W].
    """
    if uv.device.type == "cpu":
        return blend_backward_plain(
            gid, edges, uv, conic, opacity, features, bg, mask, image, final_T, grad,
            W, H, tile, opacity_bias, return_ncontrib,
        )
    _require_cuda(uv, "blend_backward")
    dev = uv.device
    tw, th = tile
    tgx, tgy = tile_grid(W, H, tile)
    N, C = features.shape
    _check_tile(tile)
    M = gid.shape[0]
    rec = _checked_records(uv, conic, opacity, opacity_bias, N, dev)
    ptrs = [
        _check(gid, "gid", torch.int32, (M,), dev),
        _check(edges, "edges", torch.int32, (tgx * tgy + 1,), dev),
        rec.data_ptr(),
        _check(features, "features", torch.float32, (N, C), dev),
        _check(bg, "bg", torch.float32, (C,), dev),
        _check(mask, "mask", torch.float32, (C,), dev),
        _check(image, "image", torch.float32, (H, W, C), dev),
        _check(final_T, "final_T", torch.float32, (H, W), dev),
        _check(grad, "grad", torch.float32, (H, W, C), dev),
    ]
    R = 8 + C + (opacity_bias is not None)
    dgrad = torch.empty((M, R), dtype=torch.float32, device=dev)
    ncontrib = torch.empty((H, W), dtype=torch.int32, device=dev) if return_ncontrib else None
    _launch(
        "blend_backward", *ptrs, int(opacity_bias is not None), C, W, H, tw, th, dgrad.data_ptr(),
        None if ncontrib is None else ncontrib.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return (dgrad, ncontrib) if return_ncontrib else dgrad


# --------------------------------------------------------------------------
# K4: reduce_gaussians
# --------------------------------------------------------------------------


def reduce_gaussians_plain(dgrad, order, offs, tiles):
    """Plain version of K4: the same run sums, slot by slot in run order."""
    dev = dgrad.device
    M, R = dgrad.shape
    N = offs.shape[0]
    inv = torch.empty((M,), dtype=torch.int64, device=dev)
    inv[order] = torch.arange(M, device=dev)
    offs = offs.long()
    n = torch.clamp_min(torch.minimum(tiles.long(), M - offs), 0)
    acc = torch.zeros((N, R), dtype=torch.float32, device=dev)
    for j in range(int(n.max()) if N else 0):
        take = (j < n)[:, None]
        acc = acc + torch.where(take, dgrad[inv[(offs + j).clamp(0, M - 1)]], 0.0)
    return acc


def reduce_gaussians(dgrad, order, offs, tiles):
    """Per-Gaussian sums of the per-slot rows (see csrc/reduce_gaussians.cu).

    dgrad [M, R] f32 from `blend_backward`; order [M] int64 the binning
    sort's permutation (sorted position -> pre-sort slot); offs, tiles [N]
    int32 from binning. Gaussian g sums the rows of its pre-sort slots
    offs[g] .. offs[g] + tiles[g] - 1 below M, in that order. Returns [N, R].
    The kernel inverts `order` only at the sorted positions below
    used = min(offs[-1] + tiles[-1], M), so on the card `order` must map
    every sorted position >= used to a pre-sort slot >= used (the plain
    version has no such precondition). `Binning.order` does: K2's sentinel
    keys sort after every real key. For another permutation the result is
    undefined.
    """
    if dgrad.device.type == "cpu":
        return reduce_gaussians_plain(dgrad, order, offs, tiles)
    _require_cuda(dgrad, "reduce_gaussians")
    dev = dgrad.device
    M, R = dgrad.shape
    N = offs.shape[0]
    ptrs = [
        _check(dgrad, "dgrad", torch.float32, (M, R), dev),
        _check(order, "order", torch.int64, (M,), dev),
        _check(offs, "offs", torch.int32, (N,), dev),
        _check(tiles, "tiles", torch.int32, (N,), dev),
    ]
    inv = torch.empty((M,), dtype=torch.int32, device=dev)
    out = torch.empty((N, R), dtype=torch.float32, device=dev)
    _launch(
        "reduce_gaussians", *ptrs, N, M, R, inv.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


# --------------------------------------------------------------------------
# bin + blend
# --------------------------------------------------------------------------


class _Splat(torch.autograd.Function):
    """K1 forward; K3 + K4 backward (the custom VJP of the JAX `splat`)."""

    @staticmethod
    def forward(ctx, uv, conic, opacity, features, abs_sink, opacity_bias, b, bg, mask,
                W, H, tile, K_idx):
        del abs_sink  # a gradient sink only: its gradient is the |duv| rows
        image, final_T, ncontrib, gs_idx = blend_forward(
            b.gid, b.edges, uv, conic, opacity, features, bg, W, H, tile, K_idx, opacity_bias
        )
        ctx.mark_non_differentiable(ncontrib, gs_idx)
        ctx.save_for_backward(uv, conic, opacity, features, opacity_bias, bg, mask, image, final_T)
        ctx.binning = b
        ctx.shape = (W, H, tile)
        return image, final_T, ncontrib, gs_idx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_image, g_final_T, g_ncontrib, g_gs_idx):
        # Only the image's cotangent reaches the inputs: the JAX `splat_bwd`
        # reads cts[0] alone, so a loss on final_T sends no gradient back
        # through the blend. A known quirk of the reference, kept.
        del g_final_T, g_ncontrib, g_gs_idx
        uv, conic, opacity, features, bias, bg, mask, image, final_T = ctx.saved_tensors
        b, (W, H, tile) = ctx.binning, ctx.shape
        C = features.shape[1]
        if g_image is None:
            g_image = torch.zeros_like(image)
        dgrad = blend_backward(
            b.gid, b.edges, uv, conic, opacity, features, bg, mask, image, final_T,
            g_image.contiguous(), W, H, tile, bias,
        )
        red = reduce_gaussians(dgrad, b.order, b.offs, b.tiles)
        grads = (red[:, 0:2], red[:, 2:5], red[:, 5], red[:, 6 : 6 + C], red[:, 6 + C : 8 + C],
                 None if bias is None else red[:, 8 + C])
        need = ctx.needs_input_grad
        return tuple(gr if need[i] else None for i, gr in enumerate(grads)) + (None,) * 7


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
    alpha_grad_mask=None,
    abs_sink: Optional[torch.Tensor] = None,
    K_idx: int = 0,
    max_intersections: int = 1 << 19,
    max_tiles_per_gaussian: int = 64,
    block: Tuple[int, int] = (16, 16),
    opacity_bias: Optional[torch.Tensor] = None,
):
    """Differentiable bin + sort + blend of pre-projected Gaussians.

    Returns (image [H,W,C], final_T [H,W], ncontrib [H,W] int32,
    gs_idx [H,W,K] int32 | None, num_intersections [] int32). `bg` is
    per-channel; `alpha_grad_mask` [C] marks the channels whose gradient
    reaches opacity (0 = the reference's `opacity.detach()` channels);
    `abs_sink` [N,2] is an all-zero gradient sink that collects the
    per-pixel sum of |d uv|; `opacity_bias` [N] engages
    alpha = min(.99, op*G + bias) with its own gradient.

    Gradients reach uv, conic, opacity, features, abs_sink and
    opacity_bias; depth and the rects are the sort key and the footprint
    (no gradient, as in the JAX package).

    Rects must respect `max_tiles_per_gaussian` (clamp the EWA radius with
    `projection.max_radius_for_tile_cap`, as `rasterize.render_gaussians`
    does): an oversized rect keeps only its first tiles in row-major order.
    Budget overflow is reported, not hidden: `num_intersections` is the
    true count and may exceed `max_intersections`.
    """
    dev = uv.device
    C = features.shape[1]
    with _spans.span("step.binning"):
        b = _binning.bin_intersections(
            depth.detach(), tiles, rect_min, rect_max, W, H,
            max_intersections=max_intersections,
            max_tiles_per_gaussian=max_tiles_per_gaussian, block=block,
        )
    with _spans.span("step.blend"):
        bg_t = blocking_to(bg, dev, torch.float32).reshape(-1)
        mask = (1.0,) * C if alpha_grad_mask is None else alpha_grad_mask
        mask_t = blocking_to(mask, dev, torch.float32).reshape(-1)
        image, final_T, ncontrib, gs_idx = _Splat.apply(
            uv, conic, opacity, features.contiguous(),
            abs_sink, opacity_bias, b, bg_t, mask_t, W, H, tuple(block), K_idx,
        )
    return image, final_T, ncontrib, (gs_idx if K_idx else None), b.num_intersections
