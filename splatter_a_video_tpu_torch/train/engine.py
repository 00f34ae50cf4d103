"""Generic multi-view 3DGS training engine for static scenes in
perspective (counterpart of `splatter_a_video_tpu/train/engine.py`):
dataset readers -> static Gaussian scene -> perspective render -> L1 +
D-SSIM -> per-attribute Adam + density control -> validation and
test / novel-view export, with the hook lifecycle.

  * One train step takes the view's camera (extrinsic [3,4], intrinsic
    [4]) and its image as tensors on the device. It renders rgb and depth
    (a 4-channel blend through K2, K1, K3 and K4) with `project_persp` and
    `ewa_persp`, so its backward runs through the perspective EWA.
  * SH view directions point from the camera centre to each Gaussian.
  * Progressive SH masks the coefficients above the active degree, which
    equals evaluating the lower degree (the masked coefficients get zero
    gradients).
  * Density control runs under the static capacity (`train/density.py`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import readers as _readers
from ..device import resolve_device
from ..models import camera as _camera
from ..models.gaussians import GaussianScene, SceneConfig, create_scene
from ..ops import projection as _projection
from ..ops import quaternion as _quaternion
from ..ops import rasterize as _raster
from ..ops import sh as _sh
from ..ops.ssim import ssim as _ssim
from . import density as _density
from . import hooks as _hooks
from . import losses as _losses
from . import optim as _optim
from . import prng as _prng

# classic 3DGS learning rates of the generic engine; the video product
# uses `optim.DEFAULT_LRS`
ENGINE_LRS: Dict[str, float] = {
    "position": 0.00016,
    "features_dc": 0.0025,
    "features_rest": 0.000125,
    "scaling": 0.005,
    "rotation": 0.001,
    "opacity": 0.05,
}
ENGINE_SCHEDULES: Dict[str, Tuple[float, float]] = {
    "position": (0.00016, 0.0000016),
}


@dataclass(frozen=True)
class EngineConfig:
    """Engine configuration, with the JAX package's defaults."""

    width: int
    height: int
    capacity: int = 1 << 17
    max_steps: int = 30000
    val_interval: int = 2000
    sh_degree_interval: int = 1000       # active SH degree +1 every this many steps
    max_sh_degree: int = 3
    lambda_dssim: float = 0.2
    init_opacity: float = 0.1
    spatial_lr_scale: bool = True        # scale the position lr by the scene radius
    random_init_points: int = 100_000    # when the reader has no point cloud
    max_intersections: int = 1 << 19
    max_tiles_per_gaussian: int = 64
    block_x: int = 16
    block_y: int = 16
    nearest: float = 0.2                 # perspective near cull
    densify: _density.DensifyConfig = field(
        default_factory=lambda: _density.DensifyConfig(
            percent_dense=0.01, densify_start_iter=500, densify_stop_iter=15000, min_opacity=0.005,
        )
    )
    optim: _optim.OptimConfig = field(
        default_factory=lambda: _optim.OptimConfig(
            max_steps=30000,
            lrs=tuple(sorted(ENGINE_LRS.items())),
            schedules=tuple(sorted(ENGINE_SCHEDULES.items())),
        )
    )

    def raster_cfg(self) -> _raster.RasterizeConfig:
        return _raster.RasterizeConfig(
            width=self.width, height=self.height, max_intersections=self.max_intersections,
            max_tiles_per_gaussian=self.max_tiles_per_gaussian, block_x=self.block_x, block_y=self.block_y,
            nearest=self.nearest, ortho=False, sh_degree=self.max_sh_degree,
        )


class EngineState(NamedTuple):
    scene: GaussianScene
    opt_state: _optim.AdamState
    densify_state: _density.DensifyState
    step: int
    key: torch.Tensor       # JAX-compatible PRNG key, CPU int64 [2] (`prng`)


class FrameBatch(NamedTuple):
    """One training view on the device; the background is a per-dataset
    constant given to `make_engine_train_step`."""

    extr: torch.Tensor     # [3, 4]
    intr: torch.Tensor     # [4] (fx, fy, cx, cy)
    rgb: torch.Tensor      # [H, W, 3]


def _sh_degree_mask(active_degree: int, max_degree: int, device=None) -> torch.Tensor:
    """[(max_degree+1)^2] 0/1 mask keeping the coefficients of degree <=
    active_degree."""
    idx = torch.arange((max_degree + 1) ** 2, device=device)
    degree_of = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    return (degree_of <= active_degree).to(torch.float32)


def project_persp_for_training(scene: GaussianScene, rcfg, batch: FrameBatch, active_sh: int, uv_sink,
                               bg: float) -> _raster.Projected:
    """The engine render's projection and channel groups: perspective,
    camera-centred SH directions with the coefficients above `active_sh`
    masked, rgb (bg `bg`) and depth (bg 0); `uv_sink` [N, 2] is added to
    uv."""
    position = scene.get_position(0.0)
    dirs = _raster.camera_view_dirs(position, batch.extr)
    uv, depth = _projection.project_persp(position, batch.intr, batch.extr, rcfg.width, rcfg.height,
                                          rcfg.nearest, rcfg.extent)
    uv = uv + uv_sink
    visible = depth != 0
    shs = scene.get_shs() * _sh_degree_mask(active_sh, rcfg.sh_degree, position.device)[None, :, None]
    rgb = _sh.eval_sh(rcfg.sh_degree, shs, dirs, visible)
    cov3d = _quaternion.build_cov3d(scene.get_scaling(), scene.get_rotation(0.0), visible)
    max_r = _projection.max_radius_for_tile_cap(rcfg.max_tiles_per_gaussian, rcfg.block)
    opacity = scene.get_opacity()
    conic, radius, tiles, rect_min, rect_max = _projection.ewa_persp(
        position, cov3d, batch.intr, batch.extr, uv, rcfg.width, rcfg.height, visible, rcfg.block, max_r,
        rcfg.rect_mode, opacity.detach(),
    )
    groups = {"rgb": (rgb, float(bg), True), "depth": (depth[:, None], 0.0, True)}
    return _raster.Projected(uv, depth, conic, radius, tiles, rect_min, rect_max, opacity, groups)


def _render_persp_with_sinks(scene: GaussianScene, rcfg, batch: FrameBatch, active_sh: int, uv_sink, abs_sink,
                             bg: float):
    """The engine render with the viewspace gradient sinks."""
    return _raster.rasterize(*project_persp_for_training(scene, rcfg, batch, active_sh, uv_sink, bg), rcfg,
                             abs_sink=abs_sink)


def make_engine_train_step(cfg: EngineConfig, bg: float = 0.0, device="cuda"):
    """(train_step, density_step, opacity_reset_step, eval_step).

    train_step(state, batch, active_sh) -> (state, metrics);
    density_step(state) -> (state, DensifyInfo);
    opacity_reset_step(state) -> state;
    eval_step(state, batch) -> (clipped rgb, {"psnr", "ssim", "l1"}).
    """
    dev = resolve_device(device)
    rcfg = cfg.raster_cfg()

    def train_step(state: EngineState, batch: FrameBatch, active_sh: int):
        scene0 = state.scene
        names = list(scene0.params)
        params = {k: v.detach().requires_grad_(True) for k, v in scene0.params.items()}
        N = scene0.alive.shape[0]
        uv_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        abs_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        sc = GaussianScene(params=params, aux=scene0.aux, cfg=scene0.cfg)
        out = _render_persp_with_sinks(sc, rcfg, batch, int(active_sh), uv_sink, abs_sink, bg)
        pred = out.features["rgb"]
        loss = _losses.rgb_loss(pred, batch.rgb, cfg.lambda_dssim)
        inputs = [params[k] for k in names] + [uv_sink]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        new_params, opt_state = _optim.adam_update(cfg.optim, scene0.params, dict(zip(names, grads[:-1])),
                                                   state.opt_state)
        with torch.no_grad():
            scale = torch.tensor([cfg.width / 2.0, cfg.height / 2.0], dtype=torch.float32, device=dev)
            dstate = _density.accumulate_stats(state.densify_state, out.radius > 0, out.radius,
                                               torch.linalg.vector_norm(grads[-1] * scale, dim=-1))
            metrics = {"loss": loss.detach(), "psnr": _losses.psnr(pred, batch.rgb).detach(),
                       "num_intersections": out.num_intersections}
        return EngineState(dataclasses.replace(scene0, params=new_params), opt_state, dstate, state.step + 1,
                           state.key), metrics

    def density_step(state: EngineState):
        key, sub = _prng.split(state.key)
        scene, opt_state, dstate, info = _density.densify_and_prune(
            state.scene, state.opt_state, state.densify_state, state.step, cfg.densify, key=sub)
        return EngineState(scene, opt_state, dstate, state.step, key), info

    def opacity_reset_step(state: EngineState):
        scene, opt_state = _density.reset_opacity(state.scene, state.opt_state)
        return EngineState(scene, opt_state, state.densify_state, state.step, state.key)

    @torch.no_grad()
    def eval_step(state: EngineState, batch: FrameBatch):
        zeros = torch.zeros((state.scene.alive.shape[0], 2), device=dev)
        out = _render_persp_with_sinks(state.scene, rcfg, batch, cfg.max_sh_degree, zeros, zeros, bg)
        pred = torch.clamp(out.features["rgb"], 0.0, 1.0)
        return pred, {"psnr": _losses.psnr(pred, batch.rgb), "ssim": _ssim(pred, batch.rgb),
                      "l1": _losses.l1_loss(pred, batch.rgb)}

    return train_step, density_step, opacity_reset_step, eval_step


def _frames_to_device(frames: _readers.SceneFrames, dev: torch.device) -> List[FrameBatch]:
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return [FrameBatch(extr=tensor(cam.extrinsic), intr=tensor(cam.intrinsic), rgb=tensor(frames.load_image(i)))
            for i, cam in enumerate(frames.cameras)]


class Engine:
    """Host-side orchestration of the engine's steps: random views without
    replacement, progressive SH, density events, validation, export."""

    def __init__(
        self,
        cfg: EngineConfig,
        train_frames: _readers.SceneFrames,
        val_frames: Optional[_readers.SceneFrames] = None,
        out_dir: str = "output",
        hooks: Optional[Sequence[_hooks.Hook]] = None,
        seed: int = 0,
        device="cuda",
    ):
        dev = resolve_device(device)
        for cam in train_frames.cameras:
            if (cam.width, cam.height) != (cfg.width, cfg.height):
                raise ValueError(f"camera {cam.width}x{cam.height} != engine {cfg.width}x{cfg.height} "
                                 "(uniform sizes required)")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

        extent = train_frames.camera_extent()
        if cfg.spatial_lr_scale:
            cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, spatial_lr_scale=extent),
                                      densify=dataclasses.replace(cfg.densify, cameras_extent=extent))
        self.cfg = cfg

        pcd = train_frames.pointcloud
        rng = np.random.RandomState(seed)
        if pcd is not None:
            positions, colors = pcd.positions, pcd.colors
        else:
            # random init in the camera-extent cube
            n = min(cfg.random_init_points, cfg.capacity)
            positions = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
            colors = rng.uniform(0.25, 0.75, (n, 3)).astype(np.float32)
        if positions.shape[0] > cfg.capacity:
            sel = rng.choice(positions.shape[0], cfg.capacity, replace=False)
            positions, colors = positions[sel], colors[sel]

        scfg = SceneConfig(capacity=cfg.capacity, num_frames=1, max_sh_degree=cfg.max_sh_degree, traj="static")
        scene = create_scene(scfg, positions, colors, init_opacity=cfg.init_opacity, device=dev)
        self.state = EngineState(scene=scene, opt_state=_optim.adam_init(scene.params),
                                 densify_state=_density.init_state(cfg.capacity, dev), step=0,
                                 key=_prng.key(seed))
        self.bg = float(train_frames.backgrounds[0]) if train_frames.backgrounds else 0.0
        self.train_batches = _frames_to_device(train_frames, dev)
        self.val_batches = _frames_to_device(val_frames, dev) if val_frames else []
        (self._train_step, self._density_step, self._opacity_reset,
         self._eval_step) = make_engine_train_step(cfg, self.bg, device=dev)
        self.hooks = list(hooks) if hooks else []
        self.ctx = _hooks.HookContext(out_dir, cfg)
        self._rng = rng
        self._order: List[int] = []
        self.metrics: Dict[str, float] = {}
        self.val_metrics: Dict[str, float] = {}

    def _next_view(self) -> FrameBatch:
        """Views drawn without replacement from a shuffled stack, reshuffled
        when it runs out."""
        if not self._order:
            self._order = list(self._rng.permutation(len(self.train_batches)))
        return self.train_batches[self._order.pop()]

    def active_sh_degree(self, step: int) -> int:
        return min(step // self.cfg.sh_degree_interval, self.cfg.max_sh_degree)

    def train(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.max_steps
        _hooks.run_hooks(self.hooks, "before_train", self.ctx)
        start = int(self.state.step)
        for it in range(start, start + total):
            _hooks.run_hooks(self.hooks, "before_train_iter", self.ctx)
            batch = self._next_view()
            self.state, metrics = self._train_step(self.state, batch, self.active_sh_degree(it))
            d = cfg.densify
            if d.densify_start_iter < it < d.densify_stop_iter and it > 0 and it % d.duplicate_interval == 0:
                self.state, info = self._density_step(self.state)
                self.metrics["num_alive"] = int(info.num_alive)
            if it > 1 and it % d.opacity_reset_interval == 1:
                self.state = self._opacity_reset(self.state)
            # one read of the step's metrics, as the JAX engine reads them
            self.metrics.update(zip(metrics, torch.stack(
                [v.reshape(()).to(torch.float32) for v in metrics.values()]).tolist()))
            self.ctx.step = it
            self.ctx.metrics = self.metrics
            self.ctx.state = self.state
            self.ctx.hooks = self.hooks
            _hooks.run_hooks(self.hooks, "after_train_iter", self.ctx)
            if self.val_batches and (it + 1) % cfg.val_interval == 0:
                self.validation()
        _hooks.run_hooks(self.hooks, "after_train", self.ctx)
        return self.metrics

    def validation(self) -> Dict[str, float]:
        _hooks.run_hooks(self.hooks, "before_val", self.ctx)
        acc: Dict[str, float] = {}
        for batch in self.val_batches:
            _hooks.run_hooks(self.hooks, "before_val_iter", self.ctx)
            _, m = self._eval_step(self.state, batch)
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v)
            _hooks.run_hooks(self.hooks, "after_val_iter", self.ctx)
        n = max(len(self.val_batches), 1)
        self.val_metrics = {k: v / n for k, v in acc.items()}
        self.ctx.val_metrics = self.val_metrics
        _hooks.run_hooks(self.hooks, "after_val", self.ctx)
        return self.val_metrics

    def render_view(self, batch: FrameBatch) -> np.ndarray:
        pred, _ = self._eval_step(self.state, batch)
        return pred.cpu().numpy()

    def test(self, novel_views: int = 0) -> Dict[str, float]:
        """Render the validation views (and a spiral of `novel_views` novel
        views) as PNGs into `out_dir`."""
        import imageio.v2 as imageio

        metrics = self.validation() if self.val_batches else {}
        for i, batch in enumerate(self.val_batches):
            imageio.imwrite(os.path.join(self.out_dir, f"test_{i:03d}.png"),
                            (self.render_view(batch) * 255).astype(np.uint8))
        if novel_views:
            base = _camera.Camera(width=self.cfg.width, height=self.cfg.height)
            if self.val_batches:
                extr = self.val_batches[0].extr.cpu().numpy()
                base = base.with_pose(extr[:3, :3], extr[:3, 3])
            dev = self.state.scene.device
            for i, cam in enumerate(_camera.spiral_path(base, novel_views)):
                nb = FrameBatch(extr=torch.from_numpy(cam.extrinsic).to(dev),
                                intr=torch.from_numpy(cam.intrinsic).to(dev),
                                rgb=torch.zeros((self.cfg.height, self.cfg.width, 3), device=dev))
                imageio.imwrite(os.path.join(self.out_dir, f"novel_{i:03d}.png"),
                                (self.render_view(nb) * 255).astype(np.uint8))
        return metrics


def engine_from_dataset(data_root: str, data_format: str, cfg: Optional[EngineConfig] = None,
                        out_dir: str = "output", device="cuda", **engine_kw) -> Engine:
    """An Engine over a registered dataset format (`readers.parse_data_format`),
    with the "val" split when the format has one."""
    reader = _readers.parse_data_format(data_format)
    train_frames = reader(data_root, "train")
    try:
        val_frames = reader(data_root, "val")
    except (FileNotFoundError, KeyError):
        val_frames = None
    if cfg is None:
        cam = train_frames.cameras[0]
        cfg = EngineConfig(width=cam.width, height=cam.height)
    return Engine(cfg, train_frames, val_frames, out_dir=out_dir, device=device, **engine_kw)
