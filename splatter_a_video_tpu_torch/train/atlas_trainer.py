"""Multi-atlas training (counterpart of
`splatter_a_video_tpu/train/atlas_trainer.py`).

The atlases' activated render inputs are concatenated along the Gaussian
axis for one fused blend (rgb 3 + depth 1 + `track_gs` 3 = 7 channels,
as in the train step: one launch each of K2, K1, K3 and K4 a step). The
uv-sink gradient comes back for the whole concatenated axis and is split
per atlas at the static capacity offsets (`AtlasModel.point_num_sep`) to
feed each atlas's density statistics; each atlas keeps its own Adam state
and its own density control. Atlases may mix trajectory types.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.atlas import AtlasModel
from ..models.gaussians import GaussianScene
from . import density as _density
from . import losses as _losses
from . import optim as _optim
from . import prng as _prng
from .trainer import Batch, TrainerConfig, _render_with_sinks, scene_render_inputs, viewspace_grad_norm


class AtlasTrainState(NamedTuple):
    model: AtlasModel
    opt_states: Dict[str, _optim.AdamState]
    densify_states: Dict[str, _density.DensifyState]
    step: int
    key: torch.Tensor       # JAX-compatible PRNG key, CPU int64 [2] (`prng`)


def init_atlas_train_state(cfg: TrainerConfig, model: AtlasModel, seed: int = 0,
                           device="cuda") -> AtlasTrainState:
    """Step 0: the model on `device`, zero Adam moments and statistics per
    atlas, and the key `jax.random.PRNGKey(seed)`."""
    del cfg
    dev = resolve_device(device)
    model = model.to(dev)
    return AtlasTrainState(
        model,
        {n: _optim.adam_init(s.params) for n, s in model.atlases.items()},
        {n: _density.init_state(s.alive.shape[0], dev) for n, s in model.atlases.items()},
        0,
        _prng.key(seed),
    )


def _concat_inputs(scenes: Dict[str, GaussianScene], t1, t2):
    inps = [scene_render_inputs(s, t1) for s in scenes.values()]
    inp = {k: torch.cat([d[k] for d in inps], dim=0)
           for k in ("position", "opacity", "scaling", "rotation", "shs")}
    pos2 = torch.cat([s.get_position(t2) for s in scenes.values()], dim=0)
    alive = torch.cat([s.alive for s in scenes.values()])
    return inp, pos2, alive


def make_atlas_grad_fn(cfg: TrainerConfig, extr: np.ndarray, device="cuda"):
    """grad_fn(model, batch, key, arap_idx=None) -> (grads {atlas: {name:
    g}}, duv [sum of capacities, 2], radius, metrics): the gradients of the
    multi-atlas objective (rgb, tracking, depth and ARAP over the
    concatenated Gaussians) from one fused render."""
    dev = resolve_device(device)
    rcfg = cfg.raster_cfg()
    extr_t = torch.as_tensor(np.asarray(extr), dtype=torch.float32, device=dev)

    def grad_fn(model: AtlasModel, batch: Batch, key, arap_idx: Optional[torch.Tensor] = None):
        names = model.names
        params = {n: {k: v.detach().requires_grad_(True) for k, v in model.atlases[n].params.items()}
                  for n in names}
        scenes = {n: GaussianScene(params=params[n], aux=model.atlases[n].aux, cfg=model.atlases[n].cfg)
                  for n in names}
        inp, pos2, alive = _concat_inputs(scenes, batch.t1, batch.t2)
        total = model.point_num_sep()[-1]
        uv_sink = torch.zeros((total, 2), device=dev, requires_grad=True)
        abs_sink = torch.zeros((total, 2), device=dev, requires_grad=True)
        out = _render_with_sinks(inp, extr_t, rcfg, {"track_gs": pos2}, cfg.white_bg, uv_sink, abs_sink,
                                 depth_bg=cfg.depth_bg)
        pred_rgb = out.features["rgb"]
        loss_rgb = _losses.rgb_loss(pred_rgb, batch.rgb1, cfg.lambda_dssim)
        vis, _, conf = _losses.parse_tapir_track_info(batch.target_tracks[:, 2], batch.target_tracks[:, 3])
        interval = float(abs(int(batch.t2) - int(batch.t1)))
        loss_flow = _losses.tracking_loss(
            out.features["track_gs"], batch.query_px, batch.target_tracks[:, :2], vis & batch.track_valid,
            conf, interval, cfg.num_frames, cfg.height, cfg.width, quantile=cfg.track_quantile,
        )
        loss_depth = _losses.depth_loss_dpt(out.features["depth"][..., 0], batch.depth1)
        loss_arap = (
            _losses.arap_loss(inp["position"], pos2, arap_idx, k=cfg.arap_knn, sample_num=cfg.arap_sample_num,
                              alive=alive, key=key)
            if cfg.arap_weight else pred_rgb.new_zeros(())
        )
        loss = cfg.loss_rgb_weight * loss_rgb
        if cfg.loss_flow_weight:
            loss = loss + cfg.loss_flow_weight * loss_flow
        if cfg.depth_loss_weight:
            loss = loss + cfg.depth_loss_weight * loss_depth
        if cfg.arap_weight:
            loss = loss + cfg.arap_weight * loss_arap
        metrics = {
            "loss": loss, "loss_rgb": loss_rgb, "loss_flow": loss_flow, "loss_depth": loss_depth,
            "loss_arap": loss_arap, "psnr": _losses.psnr(pred_rgb, batch.rgb1),
            "num_intersections": out.num_intersections,
        }
        leaves = [(n, k) for n in names for k in params[n]]
        inputs = [params[n][k] for n, k in leaves] + [uv_sink]
        gs = torch.autograd.grad(loss, inputs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, gs)]
        grads: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in names}
        for (n, k), g in zip(leaves, gs):
            grads[n][k] = g
        return grads, gs[-1], out.radius, {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def make_atlas_apply_fn(cfg: TrainerConfig):
    """(state, grads, duv, radius, metrics, key) -> (new_state, metrics):
    each atlas's Adam update, and the density statistics split per atlas
    at the capacity offsets."""

    @torch.no_grad()
    def apply_fn(state: AtlasTrainState, grads, duv, radius, metrics, key):
        model = state.model
        offs = model.point_num_sep()
        gnorm = viewspace_grad_norm(cfg, duv)
        atlases, opts, dstates = {}, {}, {}
        for i, n in enumerate(model.names):
            scene = model.atlases[n]
            params, opts[n] = _optim.adam_update(cfg.optim, scene.params, grads[n], state.opt_states[n])
            atlases[n] = dataclasses.replace(scene, params=params)
            lo, hi = offs[i], offs[i + 1]
            dstates[n] = _density.accumulate_stats(state.densify_states[n], radius[lo:hi] > 0, radius[lo:hi],
                                                   gnorm[lo:hi])
        return AtlasTrainState(AtlasModel(atlases=atlases), opts, dstates, state.step + 1, key), metrics

    return apply_fn


def make_atlas_train_step(cfg: TrainerConfig, extr: np.ndarray, device="cuda"):
    """(train_step, density_step, opacity_reset_step) over an
    `AtlasTrainState`.

    train_step(state, batch, arap_idx=None) -> (state, metrics);
    density_step(state) -> (state, {atlas: DensifyInfo}), one density event
    per atlas, each drawing from its own split of the key;
    opacity_reset_step(state) -> state.
    """
    dev = resolve_device(device)
    # the atlas optimizer prunes by size unconditionally, unlike the
    # single-atlas one (as in the JAX package)
    atlas_dcfg = dataclasses.replace(cfg.densify, size_prune_always=True)
    grad_fn = make_atlas_grad_fn(cfg, extr, device=dev)
    apply_fn = make_atlas_apply_fn(cfg)

    def train_step(state: AtlasTrainState, batch: Batch, arap_idx: Optional[torch.Tensor] = None):
        key, sub = _prng.split(state.key)
        grads, duv, radius, metrics = grad_fn(state.model, batch, sub, arap_idx)
        return apply_fn(state, grads, duv, radius, metrics, key)

    def density_step(state: AtlasTrainState):
        key = state.key
        atlases, opts, dstates, infos = {}, {}, {}, {}
        for n in state.model.names:
            key, sub = _prng.split(key)
            atlases[n], opts[n], dstates[n], infos[n] = _density.densify_and_prune(
                state.model.atlases[n], state.opt_states[n], state.densify_states[n], state.step, atlas_dcfg,
                key=sub,
            )
        return AtlasTrainState(AtlasModel(atlases=atlases), opts, dstates, state.step, key), infos

    def opacity_reset_step(state: AtlasTrainState):
        atlases, opts = {}, {}
        for n in state.model.names:
            atlases[n], opts[n] = _density.reset_opacity(state.model.atlases[n], state.opt_states[n])
        return AtlasTrainState(AtlasModel(atlases=atlases), opts, state.densify_states, state.step, state.key)

    return train_step, density_step, opacity_reset_step
