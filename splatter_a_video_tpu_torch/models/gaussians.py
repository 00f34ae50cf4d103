"""Dynamic Gaussian scene (counterpart of
`splatter_a_video_tpu/models/gaussians.py`): a fixed-capacity bag of
attribute tensors with an `alive` mask. Dead slots carry zero opacity and
are parked behind the near plane, so they produce no tiles.

A training run starts from `create_scene` (points, colours, kNN scale
init); a trained scene enters through `convert.scene_from_numpy`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import knn as _knn
from ..ops import sh as _sh
from ..ops.quaternion import inverse_sigmoid
from . import trajectory as _traj

_MOTION = ("pos_poly_feat", "pos_fourier_feat", "rot_poly_feat", "rot_fourier_feat")


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


def create_scene(
    cfg: SceneConfig,
    positions: np.ndarray,
    colors: Optional[np.ndarray] = None,
    init_opacity: float = 0.01,
    track_seq: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> GaussianScene:
    """A scene from N <= capacity points: scale log(sqrt(mean 3-NN squared
    distance)), identity quaternions, opacity inverse_sigmoid(init_opacity),
    zero SH rest, motion coefficients and attributes; the rest of the
    capacity is dead and parked at z = -10.

    colors: [N, 3] RGB in [0, 1]; None draws uniform(0.25, 0.75) from
    `generator` (on the CPU). track_seq: [T, N, 3] for traj="cubic_spline".
    traj="lbs" draws its skinning logits 0.01 N(0, 1) from `generator`.
    """
    dev = resolve_device(device)
    N = positions.shape[0]
    cap = cfg.capacity
    if N > cap:
        raise ValueError(f"{N} init points > capacity {cap}")
    positions = np.asarray(positions, np.float32)
    pos_full = np.zeros((cap, 3), np.float32)
    pos_full[:N] = positions
    pos_full[N:] = np.array([0.0, 0.0, -10.0], np.float32)

    d2 = _knn.mean_knn3_sq_dist(torch.from_numpy(positions).to(dev)).cpu().numpy()
    scaling = np.full((cap, 3), np.log(1e-3), np.float32)
    scaling[:N] = np.log(np.sqrt(np.maximum(d2, 1e-7)))[:, None].repeat(3, 1)
    rotation = np.zeros((cap, 4), np.float32)
    rotation[:, 0] = 1.0
    opacity = np.full(
        (cap, 1), inverse_sigmoid(torch.tensor(init_opacity, dtype=torch.float32)).item(), np.float32)

    if colors is None:
        colors = torch.rand((N, 3), generator=generator).numpy() * 0.5 + 0.25
    fdc = np.zeros((cap, 1, 3), np.float32)
    fdc[:N] = _sh.rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32))).numpy()[:, None, :]
    params = {
        "position": pos_full,
        "features_dc": fdc,
        "features_rest": np.zeros((cap, (cfg.max_sh_degree + 1) ** 2 - 1, 3), np.float32),
        "scaling": scaling,
        "rotation": rotation,
        "opacity": opacity,
    }
    if cfg.traj != "static":
        params.update(
            pos_poly_feat=np.zeros((cap, cfg.poly_dim, 3), np.float32),
            pos_fourier_feat=np.zeros((cap, cfg.fourier_dim, 3), np.float32),
            rot_poly_feat=np.zeros((cap, cfg.poly_dim, 4), np.float32),
            rot_fourier_feat=np.zeros((cap, cfg.fourier_dim, 4), np.float32),
        )
    if cfg.traj == "lbs":
        params.update(
            pos_lbs_logits=0.01 * torch.randn((cap, cfg.num_bones), generator=generator).numpy(),
            lbs_bone_poly=np.zeros((cfg.num_bones, cfg.poly_dim, 3), np.float32),
            lbs_bone_fourier=np.zeros((cfg.num_bones, cfg.fourier_dim, 3), np.float32),
        )
    for name, dim in cfg.render_attributes:
        if name not in _MOTION:   # motion coefficients double as attributes
            params[name] = np.zeros((cap, dim), np.float32)
    aux = {"alive": np.arange(cap) < N}
    if cfg.traj == "cubic_spline":
        if track_seq is None:
            raise ValueError("cubic_spline trajectory needs track_seq [T,N,3]")
        coeff, knots = _traj.fit_cubic_spline(np.asarray(track_seq, np.float32), cfg.frames_per_knot)
        coeff_full = np.zeros((cap,) + coeff.shape[1:], np.float32)
        coeff_full[:N] = coeff
        params["pos_cubic_coeff"] = coeff_full
        aux["spline_knots"] = knots
    return GaussianScene(
        params={k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in params.items()},
        aux={k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in aux.items()},
        cfg=cfg,
    )
