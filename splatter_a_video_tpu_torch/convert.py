"""Carry a trained scene into the port as numpy arrays, and back.

The JAX package stores scenes with orbax, which the port cannot read
without JAX; a caller that has the JAX scene passes
`{k: np.asarray(v)}` of its `params` and `aux` and its `SceneConfig`
fields (a dict, e.g. `dataclasses.asdict(cfg)`, or the port's
`SceneConfig`). Names, shapes and dtypes are checked against the config.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models.gaussians import GaussianScene, SceneConfig

_MOTION = ("pos_poly_feat", "pos_fourier_feat", "rot_poly_feat", "rot_fourier_feat")


def _scene_config(cfg: Union[dict, SceneConfig]) -> SceneConfig:
    if isinstance(cfg, SceneConfig):
        return cfg
    cfg = dict(cfg)
    cfg["render_attributes"] = tuple(
        (str(n), int(d)) for n, d in cfg.get("render_attributes", ())
    )
    return SceneConfig(**cfg)


def expected_layout(cfg: SceneConfig) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """name -> (shape, numpy dtype) of the params and aux a scene holds."""
    cap, f32 = cfg.capacity, np.dtype(np.float32)
    params = {
        "position": ((cap, 3), f32),
        "features_dc": ((cap, 1, 3), f32),
        "features_rest": ((cap, (cfg.max_sh_degree + 1) ** 2 - 1, 3), f32),
        "scaling": ((cap, 3), f32),
        "rotation": ((cap, 4), f32),
        "opacity": ((cap, 1), f32),
    }
    if cfg.traj != "static":
        params.update(
            pos_poly_feat=((cap, cfg.poly_dim, 3), f32),
            pos_fourier_feat=((cap, cfg.fourier_dim, 3), f32),
            rot_poly_feat=((cap, cfg.poly_dim, 4), f32),
            rot_fourier_feat=((cap, cfg.fourier_dim, 4), f32),
        )
    if cfg.traj == "lbs":
        params.update(
            pos_lbs_logits=((cap, cfg.num_bones), f32),
            lbs_bone_poly=((cfg.num_bones, cfg.poly_dim, 3), f32),
            lbs_bone_fourier=((cfg.num_bones, cfg.fourier_dim, 3), f32),
        )
    for name, dim in cfg.render_attributes:
        if name not in _MOTION:  # motion coefficients double as attributes
            params[name] = ((cap, dim), f32)
    aux = {"alive": ((cap,), np.dtype(np.bool_))}
    if cfg.traj == "cubic_spline":
        params["pos_cubic_coeff"] = ((cap, 4, cfg.num_knots - 1, 3), f32)
        aux["spline_knots"] = ((cfg.num_knots,), f32)
    return params, aux


def _check(kind: str, arrays: Dict[str, np.ndarray], layout: Dict[str, tuple]) -> None:
    missing = sorted(set(layout) - set(arrays))
    extra = sorted(set(arrays) - set(layout))
    if missing or extra:
        raise ValueError(f"{kind}: missing {missing}, unexpected {extra}")
    for name, (shape, dtype) in layout.items():
        a = arrays[name]
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(
                f"{kind}[{name!r}]: got {a.dtype}{tuple(a.shape)}, expected {dtype}{shape}"
            )


def scene_from_numpy(
    params: Dict[str, np.ndarray],
    aux: Dict[str, np.ndarray],
    cfg: Union[dict, SceneConfig],
    device="cuda",
) -> GaussianScene:
    """Build the port's scene from numpy arrays, on `device`."""
    dev = resolve_device(device)
    cfg = _scene_config(cfg)
    params = {k: np.asarray(v) for k, v in params.items()}
    aux = {k: np.asarray(v) for k, v in aux.items()}
    p_layout, a_layout = expected_layout(cfg)
    _check("params", params, p_layout)
    _check("aux", aux, a_layout)
    return GaussianScene(
        params={k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in params.items()},
        aux={k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in aux.items()},
        cfg=cfg,
    )


def scene_to_numpy(scene: GaussianScene):
    """Inverse of `scene_from_numpy`: (params, aux, cfg dict) as numpy arrays."""
    params = {k: v.detach().cpu().numpy() for k, v in scene.params.items()}
    aux = {k: v.detach().cpu().numpy() for k, v in scene.aux.items()}
    return params, aux, dataclasses.asdict(scene.cfg)
