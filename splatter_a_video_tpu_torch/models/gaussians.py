"""Dynamic Gaussian scene (counterpart of
`splatter_a_video_tpu/models/gaussians.py`): a fixed-capacity bag of
attribute tensors with an `alive` mask. Dead slots carry zero opacity and
are parked behind the near plane, so they produce no tiles.

`create_scene` (training set-up with its kNN scale init) comes with the
training slice; trained scenes enter through `convert.scene_from_numpy`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from . import trajectory as _traj


@dataclass(frozen=True)
class SceneConfig:
    """Static scene configuration (shapes + semantics)."""

    capacity: int
    num_frames: int
    max_sh_degree: int = 3
    traj: str = "poly_fourier"  # or "cubic_spline" / "lbs" / "static"
    poly_dim: int = _traj.POLY_DIM
    fourier_dim: int = _traj.FOURIER_DIM
    frames_per_knot: int = 5
    num_bones: int = 16         # traj="lbs": shared translation bones
    # name -> channel count of extra blended attributes
    render_attributes: Tuple[Tuple[str, int], ...] = ()
    start_frame_id: int = 0

    @property
    def num_knots(self) -> int:
        return -(-self.num_frames // self.frames_per_knot) + 1

    def t_norm(self, t, device=None) -> torch.Tensor:
        """Frame index -> normalised time in [0, 1]."""
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        return (t - self.start_frame_id) / max(self.num_frames - 1, 1)


@dataclass
class GaussianScene:
    """params: attribute tensors [capacity, ...]; aux: alive mask, spline knots."""

    params: Dict[str, torch.Tensor]
    aux: Dict[str, torch.Tensor]
    cfg: SceneConfig

    @property
    def device(self) -> torch.device:
        return self.params["position"].device

    def to(self, device) -> "GaussianScene":
        return GaussianScene(
            params={k: v.to(device) for k, v in self.params.items()},
            aux={k: v.to(device) for k, v in self.aux.items()},
            cfg=self.cfg,
        )

    @property
    def alive(self) -> torch.Tensor:
        return self.aux["alive"]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.to(torch.int32).sum()

    def get_opacity(self) -> torch.Tensor:
        """[capacity] sigmoid opacity, zeroed for dead slots."""
        return torch.sigmoid(self.params["opacity"][:, 0]) * self.alive

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.params["scaling"])

    def get_shs(self) -> torch.Tensor:
        """[capacity, (deg+1)^2, 3]: DC + rest."""
        return torch.cat([self.params["features_dc"], self.params["features_rest"]], dim=1)

    def get_position(self, t, detach_pos: bool = False) -> torch.Tensor:
        p = self.params
        if self.cfg.traj == "static":
            return p["position"]
        tn = self.cfg.t_norm(t, self.device)
        if self.cfg.traj == "lbs":
            return _traj.position_lbs(
                p["position"], p["pos_lbs_logits"], p["lbs_bone_poly"],
                p["lbs_bone_fourier"], tn, detach_pos=detach_pos,
            )
        if self.cfg.traj == "cubic_spline":
            # the spline's time ignores start_frame_id, as in the JAX package
            ts = torch.as_tensor(t, dtype=torch.float32, device=self.device)
            return _traj.position_cubic_spline(
                p["position"], p["pos_cubic_coeff"], self.aux["spline_knots"],
                ts / max(self.cfg.num_frames - 1, 1), detach_pos=detach_pos,
            )
        return _traj.position_poly_fourier(
            p["position"], p["pos_poly_feat"], p["pos_fourier_feat"], tn,
            detach_pos=detach_pos,
        )

    def get_rotation(self, t) -> torch.Tensor:
        """Unnormalised quaternion at time t (the renderer normalises)."""
        p = self.params
        if self.cfg.traj == "static":
            return p["rotation"]
        return _traj.rotation_poly_fourier(
            p["rotation"], p["rot_poly_feat"], p["rot_fourier_feat"],
            self.cfg.t_norm(t, self.device),
        )

    def get_render_attribute(self, name: str) -> torch.Tensor:
        """Sigmoid-activated extra attribute (mask / dino)."""
        return torch.sigmoid(self.params[name])
