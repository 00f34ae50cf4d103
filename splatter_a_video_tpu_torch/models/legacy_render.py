"""Legacy Gaussian-splatting renderer surface (counterpart of
`splatter_a_video_tpu/models/legacy_render.py`): the fov-driven
perspective camera parameterisation of the classic renderer
(`render_iter(FovX, FovY, world_view_transform, ...)` returning
{rgb, depth, viewspace_points, visibility, radii}) on the port's one
render path (`ops/rasterize.render_gaussians` with `ortho=False`, K2 and
K1).

Legacy conventions kept:
  * `world_view_transform` is stored transposed (row vectors):
    extrinsic = world_view_transform.T[:3];
  * focal lengths come from the fovs: fx = W / (2 tan(FovX / 2));
  * `scaling_modifier` multiplies the activated scales;
  * `update_sh_degree` raises the active degree every `update_sh_iter`
    steps;
  * SH view directions point from the camera centre to each Gaussian.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from ..ops import rasterize as _rasterize


@dataclass
class LegacySplattingConfig:
    update_sh_iter: int = 1000
    max_sh_degree: int = 3
    white_bg: bool = True


class GaussianSplattingRender:
    """The legacy renderer class."""

    def __init__(self, cfg: LegacySplattingConfig = LegacySplattingConfig()):
        self.cfg = cfg
        self.active_sh_degree = 0

    def update_sh_degree(self, step: int) -> None:
        """Raise the active SH degree every `update_sh_iter` steps."""
        if step % self.cfg.update_sh_iter == 0 and self.active_sh_degree < self.cfg.max_sh_degree:
            self.active_sh_degree += 1

    def render_iter(
        self,
        FovX: float,
        FovY: float,
        height: int,
        width: int,
        world_view_transform,
        full_proj_transform,    # unused: the projection is rebuilt from the fovs
        camera_center,
        position: torch.Tensor,
        opacity: torch.Tensor,
        scaling: torch.Tensor,
        rotation: torch.Tensor,
        shs: torch.Tensor,
        scaling_modifier: float = 1.0,
        **kwargs,
    ) -> Dict[str, torch.Tensor]:
        """One perspective render: {"rgb", "depth", "viewspace_points" (uv),
        "visibility", "radii"} on the device of `position`."""
        dev = position.device
        W, H = int(width), int(height)
        fx = W / (2.0 * math.tan(float(FovX) / 2.0))
        fy = H / (2.0 * math.tan(float(FovY) / 2.0))
        intr = torch.tensor([fx, fy, W / 2.0, H / 2.0], dtype=torch.float32, device=dev)
        extr = torch.as_tensor(world_view_transform, dtype=torch.float32, device=dev).T[:3, :4]
        rcfg = _rasterize.RasterizeConfig(width=W, height=H, ortho=False, sh_degree=self.active_sh_degree)
        out = _rasterize.render_gaussians(
            position, scaling * scaling_modifier, rotation, opacity, shs, extr, rcfg, intr=intr,
            bg_color=1.0 if self.cfg.white_bg else 0.0, view_dir_z=False,
        )
        return {
            "rgb": out.features["rgb"],
            "depth": out.features["depth"],
            "viewspace_points": out.uv,
            "visibility": out.radius > 0,
            "radii": out.radius,
        }

    def render_batch(self, render_dict: Dict, batch: list) -> Dict:
        """Render each camera of `batch`; images and depths stacked,
        visibility any() and radii max() over the cameras."""
        outs = [self.render_iter(**render_dict, **b) for b in batch]
        return {
            "images": torch.stack([r["rgb"] for r in outs]),
            "depths": torch.stack([r["depth"] for r in outs]),
            "visibility": torch.any(torch.stack([r["visibility"] for r in outs]), dim=0),
            "radii": torch.amax(torch.stack([r["radii"] for r in outs]), dim=0),
        }
