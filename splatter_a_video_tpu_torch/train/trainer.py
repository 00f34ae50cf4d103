"""The train step: render, losses, gradients, Adam, density statistics
(counterpart of `splatter_a_video_tpu/train/trainer.py`).

    loss = loss_rgb_weight * [(1 - 0.2) L1 + 0.2 (1 - SSIM)]
         + loss_flow_weight * tracking_loss
         + depth_loss_weight * depth_loss_dpt(depth, gt_depth)
         + arap_weight * arap_loss

`track_gs`, the other frame's Gaussian positions, is blended into this
frame's render with the other channels in one blend launch. The JAX step is
one jitted function; here it runs eagerly, with the gradient from
`torch.autograd.grad`. The viewspace and |viewspace| gradient sinks of the
reference are zero tensors that require grad. Density control and the
opacity reset are separate steps, called on the host's schedule.

Randomness (ARAP samples, split-child noise) comes from the state's key,
split at every train and density step as the JAX step splits its key, and
drawn with the port's copy of JAX's generator (`prng`): from the same seed
both packages draw the same samples. A test may also pass the draws in as
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import blocking_to, resolve_device
from ..models.gaussians import GaussianScene
from ..ops import projection as _proj
from ..ops import quaternion as _quat
from ..ops import rasterize as _raster
from ..ops import sh as _sh
from ..utils import spans as _spans
from . import density as _density
from . import losses as _losses
from . import optim as _optim
from . import prng as _prng


@dataclass(frozen=True)
class TrainerConfig:
    """Trainer configuration; defaults and their reasons as in the JAX
    package's `TrainerConfig`."""

    width: int
    height: int
    num_frames: int
    loss_rgb_weight: float = 10.0
    loss_flow_weight: float = 2.0
    lambda_dssim: float = 0.2
    depth_loss_weight: float = 1.0
    depth_bg: float = 2.0              # empty pixels read as far: depths live in [0.5, 2]
    arap_weight: float = 1e-3
    arap_sample_num: int = 512
    arap_knn: int = 5
    num_track_samples: int = 4096
    track_quantile: float = 0.98
    train_render_attributes: bool = False
    mask_attr_weight: float = 0.0
    dino_attr_weight: float = 0.0
    fg_layer_weight: float = 0.0
    fg_layer_start_iter: int = 100
    max_intersections: int = 1 << 19
    max_tiles_per_gaussian: int = 64
    nearest: float = 0.01
    block_x: int = 16
    block_y: int = 16
    white_bg: bool = True
    max_steps: int = 20000
    optim: _optim.OptimConfig = field(default_factory=_optim.OptimConfig)
    densify: _density.DensifyConfig = field(default_factory=_density.DensifyConfig)

    def raster_cfg(self, K_idx: int = 0) -> _raster.RasterizeConfig:
        return _raster.RasterizeConfig(
            width=self.width,
            height=self.height,
            max_intersections=self.max_intersections,
            max_tiles_per_gaussian=self.max_tiles_per_gaussian,
            block_x=self.block_x,
            block_y=self.block_y,
            K_idx=K_idx,
            nearest=self.nearest,
        )


class TrainState(NamedTuple):
    scene: GaussianScene
    opt_state: _optim.AdamState
    densify_state: _density.DensifyState
    step: int
    key: torch.Tensor       # JAX-compatible PRNG key, CPU int64 [2] (`prng`)


class Batch(NamedTuple):
    """One (t1, t2) frame pair with its TAPIR supervision. rgb1/depth1 (and
    mask1/dino1) may be None when a `FrameStore` holds the frames."""

    t1: int
    t2: int
    rgb1: Optional[torch.Tensor] = None          # [H, W, 3] in [0, 1]
    depth1: Optional[torch.Tensor] = None        # [H, W]
    query_px: Optional[torch.Tensor] = None      # [P, 2] query pixels in t1
    target_tracks: Optional[torch.Tensor] = None  # [P, 4] (x, y, occ, dist) at t2
    track_valid: Optional[torch.Tensor] = None   # [P] bool
    mask1: Optional[torch.Tensor] = None         # [H, W] in {0, 1}
    dino1: Optional[torch.Tensor] = None         # [H, W, 3]


class FrameStore(NamedTuple):
    """Per-frame supervision on the device, uploaded once."""

    rgb: torch.Tensor                       # [T, H, W, 3]
    depth: torch.Tensor                     # [T, H, W]
    mask: Optional[torch.Tensor] = None     # [T, H, W]
    dino: Optional[torch.Tensor] = None     # [T, H, W, C]


def resolve_batch(frames: Optional[FrameStore], batch: Batch) -> Batch:
    """Fill a slim batch's per-frame tensors from the store."""
    if frames is None or batch.rgb1 is not None:
        return batch
    t1 = int(batch.t1)
    return batch._replace(
        rgb1=frames.rgb[t1],
        depth1=frames.depth[t1],
        mask1=batch.mask1 if frames.mask is None else frames.mask[t1],
        dino1=batch.dino1 if frames.dino is None else frames.dino[t1],
    )


def scene_render_inputs(scene: GaussianScene, t) -> Dict[str, torch.Tensor]:
    """Activated per-Gaussian render inputs at time t."""
    out = {
        "position": scene.get_position(t),
        "opacity": scene.get_opacity(),
        "scaling": scene.get_scaling(),
        "rotation": scene.get_rotation(t),
        "shs": scene.get_shs(),
    }
    for name in ("mask_attribute", "dino_attribute"):
        if name in scene.params:
            out[name] = scene.get_render_attribute(name)
    ppf = scene.params["pos_poly_feat"]
    out["pos_poly_feat"] = ppf.reshape(ppf.shape[0], -1)
    return out


def _render_with_sinks(inp, extr, rcfg, extra, white_bg, uv_sink, abs_sink, depth_bg=2.0):
    """The training render, with the uv / |uv| gradient sinks injected."""
    with _spans.span("step.project"):
        proj = project_for_training(inp, extr, rcfg, extra, white_bg, uv_sink, depth_bg)
    return _raster.rasterize(*proj, rcfg, abs_sink=abs_sink)


def project_for_training(inp, extr, rcfg, extra, white_bg, uv_sink, depth_bg=2.0) -> _raster.Projected:
    """The training render's projection and channel groups: rgb (bg 1 on
    white, else 0), depth (bg `depth_bg`) and each `extra` group (bg 0, no
    gradient to opacity); `uv_sink` [N, 2] is added to uv.

    Known quirk, kept from the JAX package: the EWA rect here is the tight
    3-sigma rect without opacity (`trainer.py:436-439`), whereas
    `rasterize.render_gaussians` passes the opacity for a smaller rect. The
    two give the same pixels; the training render just bins more slots.
    """
    position = inp["position"]
    N = position.shape[0]
    dirs = torch.cat([position.new_zeros((N, 2)), position.new_ones((N, 1))], dim=1)
    uv, depth = _proj.project_ortho(position, extr, rcfg.width, rcfg.height,
                                    rcfg.nearest, rcfg.extent)
    uv = uv + uv_sink   # signed viewspace-gradient capture
    visible = depth != 0
    rgb = _sh.eval_sh(rcfg.sh_degree, inp["shs"], dirs, visible)
    cov3d = _quat.build_cov3d(inp["scaling"], inp["rotation"], visible)
    max_r = _proj.max_radius_for_tile_cap(rcfg.max_tiles_per_gaussian, rcfg.block)
    conic, radius, tiles, rect_min, rect_max = _proj.ewa_ortho(
        cov3d, extr, uv, rcfg.width, rcfg.height, visible, rcfg.block, max_r)
    groups = {
        "rgb": (rgb, 1.0 if white_bg else 0.0, True),
        "depth": (depth[:, None], depth_bg, True),
    }
    for k, v in extra.items():
        groups[k] = (v, 0.0, False)
    return _raster.Projected(uv, depth, conic, radius, tiles, rect_min, rect_max, inp["opacity"], groups)


def compute_losses(cfg: TrainerConfig, rcfg, scene: GaussianScene, batch: Batch, arap_idx,
                   step: int, params, uv_sink, abs_sink, extr_t1, pos2_transform=None,
                   key: Optional[torch.Tensor] = None):
    """The loss of one (t1, t2) pair: (loss, (metrics, radius)).

    `arap_idx` [S] are the ARAP sample indices, or None to draw them from
    `key`. `pos2_transform` maps the t2 positions into the t2 camera
    frame before they are blended as `track_gs` (camera refinement).
    """
    # the trajectories, activations and SH of both instants, with their backward
    with _spans.span("step.render_inputs"):
        params = dict(zip(params, _spans.stage_in("step.render_inputs", *params.values())))
        sc = GaussianScene(params=params, aux=scene.aux, cfg=scene.cfg)
        inp1 = scene_render_inputs(sc, batch.t1)
        *vals, pos2 = _spans.stage_out("step.render_inputs", *inp1.values(), sc.get_position(batch.t2))
        inp1 = dict(zip(inp1, vals))
    if pos2_transform is not None:
        pos2 = pos2_transform(pos2)
    extra = {"track_gs": pos2}
    if cfg.train_render_attributes or cfg.mask_attr_weight or cfg.dino_attr_weight:
        for name in ("mask_attribute", "pos_poly_feat", "dino_attribute"):
            if name in inp1:
                extra[name] = inp1[name]
    out = _render_with_sinks(inp1, extr_t1, rcfg, extra, cfg.white_bg, uv_sink, abs_sink,
                             depth_bg=cfg.depth_bg)
    pred_rgb = out.features["rgb"]
    pred_depth = out.features["depth"][..., 0]
    track_map = out.features["track_gs"]

    # L1 + D-SSIM, with its backward
    with _spans.span("step.loss.rgb"):
        loss_rgb = _spans.stage_out("step.loss.rgb", _losses.rgb_loss(
            _spans.stage_in("step.loss.rgb", pred_rgb), batch.rgb1, cfg.lambda_dssim))
    with _spans.span("step.loss.track"):
        vis, _, conf = _losses.parse_tapir_track_info(batch.target_tracks[:, 2], batch.target_tracks[:, 3])
        interval = float(abs(int(batch.t2) - int(batch.t1)))
        loss_flow = _losses.tracking_loss(
            track_map, batch.query_px, batch.target_tracks[:, :2], vis & batch.track_valid, conf,
            interval, cfg.num_frames, cfg.height, cfg.width, quantile=cfg.track_quantile,
        )
    with _spans.span("step.loss.depth"):
        loss_depth = _losses.depth_loss_dpt(pred_depth, batch.depth1)
    zero = pred_rgb.new_zeros(())
    with _spans.span("step.loss.arap"):
        loss_arap = (
            _losses.arap_loss(inp1["position"], pos2, arap_idx, k=cfg.arap_knn,
                              sample_num=cfg.arap_sample_num, alive=sc.alive, key=key)
            if cfg.arap_weight else zero
        )
    # zero-weight terms are skipped (0 * NaN would still poison the sum)
    loss = cfg.loss_rgb_weight * loss_rgb
    if cfg.loss_flow_weight:
        loss = loss + cfg.loss_flow_weight * loss_flow
    if cfg.depth_loss_weight:
        loss = loss + cfg.depth_loss_weight * loss_depth
    if cfg.arap_weight:
        loss = loss + cfg.arap_weight * loss_arap
    extra_metrics = {}
    if cfg.mask_attr_weight:
        with _spans.span("step.loss.attr"):
            loss_mask = torch.mean((out.features["mask_attribute"][..., 0] - batch.mask1) ** 2)
        loss = loss + cfg.mask_attr_weight * loss_mask
        extra_metrics["loss_mask_attr"] = loss_mask
    if cfg.dino_attr_weight:
        with _spans.span("step.loss.attr"):
            loss_dino = torch.mean((out.features["dino_attribute"] - batch.dino1) ** 2)
        loss = loss + cfg.dino_attr_weight * loss_dino
        extra_metrics["loss_dino_attr"] = loss_dino
    if cfg.fg_layer_weight:
        # fg-only re-render: Gaussians whose (detached) mask attribute is
        # > 0.5, on black, with the sinks cut off so this render does not
        # feed the densification statistics
        fg_sel = (inp1["mask_attribute"][:, 0] > 0.5).detach()
        inp_fg = {**inp1, "opacity": torch.where(fg_sel, inp1["opacity"], 0.0)}
        out_fg = _render_with_sinks(
            inp_fg, extr_t1, rcfg, {"mask_attribute": inp1["mask_attribute"]}, False,
            uv_sink.detach(), abs_sink.detach(), depth_bg=cfg.depth_bg,
        )
        gt_mask1 = batch.mask1[..., None]
        loss_rgb_fg = torch.mean((out_fg.features["rgb"] - batch.rgb1 * gt_mask1) ** 2)
        loss_mask_fg = torch.mean((out_fg.features["mask_attribute"] - gt_mask1) ** 2)
        w_fg = cfg.fg_layer_weight if step > cfg.fg_layer_start_iter else 0.0
        loss = loss + w_fg * (loss_rgb_fg + loss_mask_fg)
        extra_metrics["loss_rgb_fg"] = loss_rgb_fg
        extra_metrics["loss_mask_fg"] = loss_mask_fg
    metrics = {
        **extra_metrics,
        "loss": loss,
        "loss_rgb": loss_rgb,
        "loss_flow": loss_flow,
        "loss_depth": loss_depth,
        "loss_arap": loss_arap,
        "psnr": _losses.psnr(pred_rgb, batch.rgb1),
        "num_intersections": out.num_intersections,
    }
    return loss, (metrics, out.radius)


def viewspace_grad_norm(cfg: TrainerConfig, duv: torch.Tensor) -> torch.Tensor:
    """NDC-scale viewspace gradient norms: |duv * (W/2, H/2)|."""
    scale = blocking_to([cfg.width / 2.0, cfg.height / 2.0], duv.device, duv.dtype)
    return torch.linalg.vector_norm(duv * scale, dim=-1)


def make_train_step(cfg: TrainerConfig, extr: np.ndarray, frames: Optional[FrameStore] = None,
                    device="cuda"):
    """(train_step, density_step, opacity_reset_step) for a fixed camera.

    train_step(state, batch, arap_idx=None) -> (state, metrics);
    density_step(state, noise=None) -> (state, DensifyInfo);
    opacity_reset_step(state) -> state. With `frames`, batches may be slim.
    """
    dev = resolve_device(device)
    rcfg = cfg.raster_cfg()
    extr_t = torch.as_tensor(np.asarray(extr), dtype=torch.float32, device=dev)
    if frames is not None:
        frames = FrameStore(*(None if f is None else f.to(dev) for f in frames))

    def train_step(state: TrainState, batch: Batch, arap_idx: Optional[torch.Tensor] = None):
        batch = resolve_batch(frames, batch)
        key, sub = _prng.split(state.key)
        scene = state.scene
        names = list(scene.params)
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
        N = scene.alive.shape[0]
        uv_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        abs_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        loss, (metrics, radius) = compute_losses(
            cfg, rcfg, scene, batch, arap_idx, state.step, params, uv_sink, abs_sink, extr_t, key=sub,
        )
        inputs = [params[k] for k in names] + [uv_sink, abs_sink]
        with _spans.span("step.backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        gdict = dict(zip(names, grads[: len(names)]))
        duv = grads[-2]
        with _spans.span("step.adam"):
            new_params, opt_state = _optim.adam_update(cfg.optim, scene.params, gdict, state.opt_state)
        with _spans.span("step.density_stats"):
            dstate = _density.accumulate_stats(state.densify_state, radius > 0, radius,
                                               viewspace_grad_norm(cfg, duv))
        new_scene = GaussianScene(params=new_params, aux=scene.aux, cfg=scene.cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(new_scene, opt_state, dstate, state.step + 1, key), metrics

    def density_step(state: TrainState, noise: Optional[torch.Tensor] = None):
        key, sub = _prng.split(state.key)
        scene, opt_state, dstate, info = _density.densify_and_prune(
            state.scene, state.opt_state, state.densify_state, state.step, cfg.densify,
            noise=noise, key=sub,
        )
        return TrainState(scene, opt_state, dstate, state.step, key), info

    def opacity_reset_step(state: TrainState):
        scene, opt_state = _density.reset_opacity(state.scene, state.opt_state)
        return TrainState(scene, opt_state, state.densify_state, state.step, state.key)

    return train_step, density_step, opacity_reset_step


def init_train_state(cfg: TrainerConfig, scene: GaussianScene, seed: int = 0,
                     device="cuda") -> TrainState:
    """The state at step 0: the scene on `device`, zero Adam moments and
    statistics, and the key `jax.random.PRNGKey(seed)` (on the CPU)."""
    del cfg
    dev = resolve_device(device)
    scene = scene.to(dev)
    return TrainState(
        scene=scene,
        opt_state=_optim.adam_init(scene.params),
        densify_state=_density.init_state(scene.alive.shape[0], dev),
        step=0,
        key=_prng.key(seed),
    )


def should_densify(cfg: TrainerConfig, step: int) -> bool:
    """Host-side schedule of the density events."""
    d = cfg.densify
    return d.densify_start_iter < step < d.densify_stop_iter and step % d.duplicate_interval == 0


def should_reset_opacity(cfg: TrainerConfig, step: int) -> bool:
    """The reference's one-step-deferred opacity reset."""
    return step > 1 and step % cfg.densify.opacity_reset_interval == 1
