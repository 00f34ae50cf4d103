"""Public differentiable rasterization API (counterpart of
`splatter_a_video_tpu/ops/rasterize.py`).

    SH eval -> projection -> cov3d -> EWA -> binning -> multi-channel
    alpha blend (one launch for every channel group).

Gradients come from autograd for the point-wise stages and from the blend's
autograd Function (K3 + K4) for the blend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import projection as _projection
from . import quaternion as _quaternion
from . import rasterize_gpu as _rgpu
from . import sh as _sh


@dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer configuration.

    The JAX config's `chunk`, `sort_mode`, `scan_impl`, `edges_mode`,
    `expand_mode` and `interpret` are dropped: they choose between TPU
    implementations of the same result, and the port has one (exact sort,
    searchsorted edges, CUDA kernels).
    """

    width: int
    height: int
    max_intersections: int = 1 << 20
    max_tiles_per_gaussian: int = 64
    block_x: int = 16               # pixel tile width
    block_y: int = 16               # pixel tile height
    nearest: float = 0.01           # ortho near-cull
    extent: float = 1.3             # frustum-extent cull factor
    ortho: bool = True              # production path is orthographic
    sh_degree: int = 3
    K_idx: int = 0                  # per-pixel first-K id capture (0 = off)
    rect_mode: str = "tight"        # "tight" ellipse AABB | "disc" (reference rect)

    @property
    def block(self) -> Tuple[int, int]:
        return (self.block_x, self.block_y)


class RenderOutput(NamedTuple):
    features: Dict[str, torch.Tensor]   # name -> [H, W, c] rendered channels
    final_T: torch.Tensor               # [H, W]
    ncontrib: torch.Tensor              # [H, W] int32
    gs_idx: Optional[torch.Tensor]      # [H, W, K] int32 or None
    uv: torch.Tensor                    # [N, 2] screen positions
    depth: torch.Tensor                 # [N] camera depths
    radius: torch.Tensor                # [N] int32 (visibility = radius > 0)
    num_intersections: torch.Tensor     # [] int32 (saturation diagnostic)


def rasterize(
    uv, depth, conic, radius, tiles, rect_min, rect_max, opacity,
    feature_groups: Dict[str, Tuple[torch.Tensor, float, bool]],
    cfg: RasterizeConfig,
    abs_sink: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Bin, sort and blend pre-projected Gaussians.

    feature_groups: ordered name -> (values [N, c], bg, opacity_grad) with
    a per-group background scalar; `opacity_grad=False` reproduces the
    reference's `opacity.detach()` blend for extra attributes (their
    gradient reaches uv and conic but not opacity). abs_sink: optional
    [N, 2] zeros whose gradient collects the per-pixel sum of |d uv|.
    """
    names = list(feature_groups.keys())
    feats = torch.cat([feature_groups[k][0] for k in names], dim=1)
    bg: list = []
    mask: list = []
    for k in names:
        vals, b, og = feature_groups[k]
        bg.extend([float(b)] * vals.shape[1])
        mask.extend([1.0 if og else 0.0] * vals.shape[1])

    img, final_T, ncontrib, gs_idx, nint = _rgpu.splat_scene(
        uv, conic, opacity, feats, depth, tiles, rect_min, rect_max,
        W=cfg.width,
        H=cfg.height,
        bg=bg,
        alpha_grad_mask=mask,
        abs_sink=abs_sink,
        K_idx=cfg.K_idx,
        max_intersections=cfg.max_intersections,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        block=cfg.block,
    )
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k in names:
        c = feature_groups[k][0].shape[1]
        out[k] = img[..., off : off + c]
        off += c
    return RenderOutput(
        features=out,
        final_T=final_T,
        ncontrib=ncontrib,
        gs_idx=gs_idx,
        uv=uv,
        depth=depth,
        radius=radius,
        num_intersections=nint,
    )


class Projected(NamedTuple):
    """The inputs `rasterize` takes, as `project_gaussians` makes them."""

    uv: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    radius: torch.Tensor
    tiles: torch.Tensor
    rect_min: torch.Tensor
    rect_max: torch.Tensor
    opacity: torch.Tensor
    feature_groups: Dict[str, Tuple[torch.Tensor, float, bool]]


def render_gaussians(
    position, scaling, rotation, opacity, shs, extr, cfg: RasterizeConfig,
    intr=None, extra_features: Optional[Dict[str, torch.Tensor]] = None,
    bg_color: float = 1.0, abs_sink: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render activated 3D Gaussians.

    position [N,3], scaling [N,3] (activated), rotation [N,4], opacity [N]
    (activated), shs [N,K,3]; extr [3,4] world->camera; intr (fx,fy,cx,cy)
    for the perspective path. `extra_features` blend with bg 0 and detached
    opacity; a "depth" channel (bg 1) is always rendered. SH uses the fixed
    +z view direction (the JAX package's default); the EWA rect is
    opacity-aware. `abs_sink` as for `rasterize`.
    """
    return rasterize(*project_gaussians(
        position, scaling, rotation, opacity, shs, extr, cfg, intr,
        extra_features, bg_color,
    ), cfg, abs_sink=abs_sink)


def project_gaussians(
    position, scaling, rotation, opacity, shs, extr, cfg: RasterizeConfig,
    intr=None, extra_features: Optional[Dict[str, torch.Tensor]] = None,
    bg_color: float = 1.0,
) -> Projected:
    """Everything `render_gaussians` does before binning and blending."""
    N = position.shape[0]
    dirs = torch.cat([position.new_zeros((N, 2)), position.new_ones((N, 1))], dim=1)

    if cfg.ortho:
        uv, depth = _projection.project_ortho(
            position, extr, cfg.width, cfg.height, cfg.nearest, cfg.extent
        )
    else:
        uv, depth = _projection.project_persp(
            position, intr, extr, cfg.width, cfg.height, cfg.nearest, cfg.extent
        )
    visible = depth != 0

    rgb = _sh.eval_sh(cfg.sh_degree, shs, dirs, visible)
    cov3d = _quaternion.build_cov3d(scaling, rotation, visible)

    max_r = _projection.max_radius_for_tile_cap(cfg.max_tiles_per_gaussian, cfg.block)
    if cfg.ortho:
        conic, radius, tiles, rect_min, rect_max = _projection.ewa_ortho(
            cov3d, extr, uv, cfg.width, cfg.height, visible, cfg.block, max_r,
            cfg.rect_mode, opacity.detach(),
        )
    else:
        conic, radius, tiles, rect_min, rect_max = _projection.ewa_persp(
            position, cov3d, intr, extr, uv, cfg.width, cfg.height, visible,
            cfg.block, max_r, cfg.rect_mode, opacity.detach(),
        )

    groups: Dict[str, Tuple[torch.Tensor, float, bool]] = {
        "rgb": (rgb, float(bg_color), True),
        "depth": (depth[:, None], 1.0, True),
    }
    if extra_features:
        for k, v in extra_features.items():
            groups[k] = (v, 0.0, False)

    return Projected(uv, depth, conic, radius, tiles, rect_min, rect_max, opacity, groups)
