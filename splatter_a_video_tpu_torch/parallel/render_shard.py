"""Depth-slab (model-parallel) rendering over a process group (counterpart
of `splatter_a_video_tpu/parallel/render_shard.py`).

  1. the Gaussians are depth-sorted for the target frame (one global
     stable argsort, the same on every rank);
  2. rank r of n takes the r-th contiguous DEPTH SLAB of the sorted order;
  3. each rank runs the single-GPU pipeline (K2 binning, K1 blend) on its
     slab over bg = 0: a partial image and its slab transmittance;
  4. the partials combine front to back with the associative operator
         (o1, T1) (+) (o2, T2) = (o1 + T1 * o2, T1 * T2),
     which is exact because the slabs partition depth; the background is
     applied once after the fold (rgb `bg_color`, depth 1).

`render_slab` and `fold_partials` are the two halves, so one GPU can
render every slab in turn and fold them; `render_gaussians_sharded` is the
collective version: each rank renders its slab, the partials are
all-gathered and every rank folds them.

Exactness caveat (as in the JAX package): the single-GPU blend stops before
the Gaussian that would push T below 1e-4, dropping a tail at residual
transmittance up to 1e-4 / (1 - 0.99), about 1e-2. A rear slab cannot see
the global T, so it blends that tail: the sharded render is closer to exact
compositing, and its pixels differ from the single render by at most that
residual (about 8e-3 on an opaque wall, 3e-4 on typical scenes).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from ..ops import projection as _projection
from ..ops import quaternion as _quaternion
from ..ops import rasterize as _raster
from ..ops import rasterize_gpu as _rgpu
from ..ops import sh as _sh
from . import mesh as _mesh


def render_slab(position, scaling, rotation, opacity, shs, extr, cfg: _raster.RasterizeConfig, r: int,
                n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab r of n: (partial [H, W, 4] rgb + depth over bg 0, slab
    transmittance [H, W, 1]). Inputs are the activated [N, ...] arrays, N
    divisible by n."""
    N = position.shape[0]
    if N % n:
        raise ValueError(f"N={N} not divisible by the {n} slabs")
    extr = torch.as_tensor(extr, dtype=position.dtype, device=position.device)
    _, depth = _projection.project_ortho(position, extr, cfg.width, cfg.height, cfg.nearest, cfg.extent)
    # culled Gaussians (depth 0) sort to the front of slab 0 and the blend
    # skips them; stable, as jnp.argsort is
    order = torch.argsort(depth, stable=True)
    idx = order[r * (N // n):(r + 1) * (N // n)]
    lpos, lscl, lrot, lop, lsh = position[idx], scaling[idx], rotation[idx], opacity[idx], shs[idx]
    luv, ldepth = _projection.project_ortho(lpos, extr, cfg.width, cfg.height, cfg.nearest, cfg.extent)
    lvis = ldepth != 0
    cov6 = _quaternion.build_cov3d(lscl, _quaternion.quat_normalize(lrot), lvis)
    max_r = _projection.max_radius_for_tile_cap(cfg.max_tiles_per_gaussian, cfg.block)
    conic, _, tiles, rmin, rmax = _projection.ewa_ortho(cov6, extr, luv, cfg.width, cfg.height, lvis, cfg.block,
                                                        max_r)
    dirs = torch.cat([torch.zeros_like(lpos[:, :2]), torch.ones_like(lpos[:, :1])], dim=1)
    rgb = _sh.eval_sh(cfg.sh_degree, lsh, dirs, lvis)
    feats = torch.cat([rgb, ldepth[:, None]], dim=1)
    img, final_T, _, _, _ = _rgpu.splat_scene(
        luv, conic, lop * lvis.to(lop.dtype), feats, ldepth, tiles, rmin, rmax,
        W=cfg.width, H=cfg.height,
        bg=(0.0, 0.0, 0.0, 0.0),            # slabs blend over nothing
        # the FULL budget per slab: intersections do not split evenly over
        # depth slabs (one slab can hold all the big Gaussians); dividing it
        # by n truncated splats in the JAX package (0.39 max pixel error)
        max_intersections=cfg.max_intersections,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        block=cfg.block,
    )
    return img, final_T[..., None]


def fold_partials(imgs: List[torch.Tensor], Ts: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back fold of the slabs' (partial, T), slab 0 nearest."""
    out, Tout = torch.zeros_like(imgs[0]), torch.ones_like(Ts[0])
    for im, t in zip(imgs, Ts):
        out, Tout = out + Tout * im, Tout * t
    return out, Tout


def composite(out: torch.Tensor, Tout: torch.Tensor, bg_color: float = 1.0):
    """The folded partials over the background: rgb `bg_color`, depth 1."""
    return {"rgb": out[..., :3] + Tout * bg_color, "depth": out[..., 3:4] + Tout * 1.0, "final_T": Tout}


def render_gaussians_sharded(position, scaling, rotation, opacity, shs, extr, cfg: _raster.RasterizeConfig,
                             group=None, bg_color: float = 1.0):
    """Depth-slab render over the ranks of `group` (default: the world):
    every rank passes the same replicated [N, ...] arrays (N divisible by
    the group's size) and gets {"rgb" [H,W,3], "depth" [H,W,1], "final_T"
    [H,W,1]}, the same on every rank."""
    n, r = _mesh.world_size(group), _mesh.rank(group)
    img, T = render_slab(position, scaling, rotation, opacity, shs, extr, cfg, r, n)
    if _mesh.is_initialized():
        imgs, Ts = [torch.empty_like(img) for _ in range(n)], [torch.empty_like(T) for _ in range(n)]
        dist.all_gather(imgs, img.contiguous(), group=group)
        dist.all_gather(Ts, T.contiguous(), group=group)
    else:
        imgs, Ts = [img], [T]
    return composite(*fold_partials(imgs, Ts), bg_color)


def make_render_mesh(n_devices=None, backend=None):
    """The group of the first `n_devices` ranks for the slab render (see
    `mesh.make_mesh`)."""
    return _mesh.make_mesh(n_devices, backend)
