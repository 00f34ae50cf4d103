"""Carry a scene, or a whole train state, into the port as numpy arrays,
and back.

The JAX package stores scenes with orbax, which the port cannot read
without JAX; a caller that has the JAX scene passes
`{k: np.asarray(v)}` of its `params` and `aux` and its `SceneConfig`
fields (a dict, e.g. `dataclasses.asdict(cfg)`, or the port's
`SceneConfig`). Names, shapes and dtypes are checked against the config.

A train state adds the optimizer (optax keeps one Adam state per
attribute: pass its shared `count` and the `mu` / `nu` dicts), the
`DensifyState` arrays and the PRNG key (`np.asarray(state.key)`: the port
draws with its copy of JAX's generator, `train/prng.py`).

Camera refinement's twists come with their optax Adam state (pass the
`ScaleByAdamState`'s count, mu and nu): `cam_state_from_numpy`. A
multi-atlas model is a dict of scenes (`atlas_from_numpy`), and its train
state a dict of per-atlas scene, optimizer and statistics arrays
(`atlas_train_state_from_numpy`). The perspective engine's state has a
train state's fields (`engine_state_from_numpy`).

The preprocessing networks take the JAX package's numpy parameter dicts
(`random_params`, `params_from_torch`, or a converted `.npz`):
`vit_from_numpy`, `depth_anything_from_numpy`, `tapir_from_numpy` and
`lpips_from_numpy` give the port's modules on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models.atlas import AtlasModel
from .models.gaussians import GaussianScene, SceneConfig
from .train import density as _density
from .train import optim as _optim
from .train import prng as _prng
from .train import trainer as _trainer

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


def train_state_from_numpy(
    params: Dict[str, np.ndarray],
    aux: Dict[str, np.ndarray],
    cfg: Union[dict, SceneConfig],
    opt: dict,
    densify: Dict[str, np.ndarray],
    step: int,
    seed: int = 0,
    device="cuda",
    key=None,
) -> "_trainer.TrainState":
    """A port `TrainState` from numpy: the scene as `scene_from_numpy`,
    opt = {"count": int, "mu": {name: array}, "nu": {name: array}} with
    one entry per scene parameter, densify = the three `DensifyState`
    arrays, the step count and the key: the two uint32 words of `key`, or
    `PRNGKey(seed)` when it is None."""
    scene = scene_from_numpy(params, aux, cfg, device=device)
    dev = scene.device
    layout = {k: (tuple(v.shape), np.dtype(np.float32)) for k, v in scene.params.items()}
    for kind in ("mu", "nu"):
        _check(f"opt[{kind!r}]", {k: np.asarray(v) for k, v in opt[kind].items()}, layout)
    cap = scene.cfg.capacity
    dlayout = {k: ((cap,), np.dtype(np.float32)) for k in _density.DensifyState._fields}
    _check("densify", {k: np.asarray(v) for k, v in densify.items()}, dlayout)
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return _trainer.TrainState(
        scene=scene,
        opt_state=_optim.AdamState(
            count=int(opt["count"]),
            mu={k: tensor(v) for k, v in opt["mu"].items()},
            nu={k: tensor(v) for k, v in opt["nu"].items()},
        ),
        densify_state=_density.DensifyState(**{k: tensor(densify[k]) for k in dlayout}),
        step=int(step),
        key=_prng.key(seed) if key is None else torch.as_tensor(np.asarray(key, np.int64)).reshape(2),
    )


def train_state_to_numpy(state: "_trainer.TrainState") -> dict:
    """Inverse of `train_state_from_numpy`."""
    params, aux, cfg = scene_to_numpy(state.scene)
    arr = lambda t: t.detach().cpu().numpy()
    return dict(
        params=params, aux=aux, cfg=cfg,
        opt={"count": state.opt_state.count,
             "mu": {k: arr(v) for k, v in state.opt_state.mu.items()},
             "nu": {k: arr(v) for k, v in state.opt_state.nu.items()}},
        densify={k: arr(v) for k, v in state.densify_state._asdict().items()},
        step=state.step,
        key=state.key.numpy().astype(np.uint32),
    )


def cam_state_from_numpy(xi: np.ndarray, opt: dict, device="cuda"):
    """(twists [T, 6], their `AdamState`) on `device` from numpy: opt =
    {"count": int, "mu": array, "nu": array}, the twists' optax Adam state
    (its schedule's count equals the Adam count)."""
    dev = resolve_device(device)
    xi = np.asarray(xi)
    layout = {"xi": (tuple(xi.shape), np.dtype(np.float32))}
    _check("xi", {"xi": xi}, layout)
    for kind in ("mu", "nu"):
        _check(f"opt[{kind!r}]", {"xi": np.asarray(opt[kind])}, layout)
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return tensor(xi), _optim.AdamState(count=int(opt["count"]), mu={"xi": tensor(opt["mu"])},
                                        nu={"xi": tensor(opt["nu"])})


def atlas_from_numpy(atlases: Dict[str, dict], device="cuda") -> AtlasModel:
    """An `AtlasModel` from {name: {"params", "aux", "cfg"}} (each as for
    `scene_from_numpy`), in the given order."""
    return AtlasModel(atlases={n: scene_from_numpy(a["params"], a["aux"], a["cfg"], device=device)
                               for n, a in atlases.items()})


def atlas_train_state_from_numpy(atlases: Dict[str, dict], step: int, key, device="cuda"):
    """An `atlas_trainer.AtlasTrainState` from {name: {"params", "aux",
    "cfg", "opt", "densify"}} (each atlas as for `train_state_from_numpy`),
    the shared step count and the key's two uint32 words."""
    from .train.atlas_trainer import AtlasTrainState

    states = {n: train_state_from_numpy(a["params"], a["aux"], a["cfg"], a["opt"], a["densify"], step,
                                        device=device, key=key)
              for n, a in atlases.items()}
    return AtlasTrainState(
        model=AtlasModel(atlases={n: st.scene for n, st in states.items()}),
        opt_states={n: st.opt_state for n, st in states.items()},
        densify_states={n: st.densify_state for n, st in states.items()},
        step=int(step),
        key=torch.as_tensor(np.asarray(key, np.int64)).reshape(2),
    )


def engine_state_from_numpy(params, aux, cfg, opt: dict, densify, step: int, key, device="cuda"):
    """A `train.engine.EngineState` from numpy, with the arguments of
    `train_state_from_numpy` (a static scene)."""
    from .train.engine import EngineState

    return EngineState(*train_state_from_numpy(params, aux, cfg, opt, densify, step, device=device, key=key))


def vit_from_numpy(params: Dict[str, np.ndarray], cfg, device="cuda"):
    """The port's `nets.vit.ViT` on `device` from the JAX package's ViT
    parameter dict (numpy, linears [in, out], the patch kernel HWIO)."""
    from .nets.vit import ViT

    return ViT(cfg, params).to(resolve_device(device))


def depth_anything_from_numpy(params: Dict[str, np.ndarray], cfg, pretrained: bool = False, device="cuda"):
    """The port's `nets.depth_anything.DepthAnything` on `device` from the
    JAX package's parameter dict (convs HWIO, deconvs [k, k, out, in])."""
    from .nets.depth_anything import DepthAnything

    return DepthAnything(cfg, params, pretrained).to(resolve_device(device))


def tapir_from_numpy(params: Dict[str, np.ndarray], cfg, pretrained: bool = False, device="cuda"):
    """The port's `nets.tapir.Tapir` on `device` from the JAX package's
    parameter dict (convs HWIO, linears [in, out], depthwise [k, 1, out])."""
    from .nets.tapir import Tapir

    return Tapir(cfg, params, pretrained).to(resolve_device(device))


def lpips_from_numpy(params: Dict[str, np.ndarray], pretrained: bool = False, device="cuda"):
    """The port's `eval.lpips.Lpips` on `device` from the JAX package's
    VGG16 + heads dict (convs HWIO)."""
    from .eval.lpips import Lpips

    return Lpips(params, pretrained).to(resolve_device(device))
