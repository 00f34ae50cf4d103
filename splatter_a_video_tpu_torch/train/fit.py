"""Fitting one clip end to end: lift tracks, build the spline scene, then
run the train step on a prefetched stream of frame pairs with density
control on its schedule (counterpart of `splatter_a_video_tpu/train/fit.py`).

The loop keeps the JAX package's order step by step. Per-frame images
live on the device in a `trainer.FrameStore`, so a step uploads only its
track batch (pinned, non-blocking). The host reads device values only
where the JAX package reads them: at the log and hook cadences, at density
events and at error-map resampling; no other step waits for the card.

Not ported yet: data-parallel training (`distributed=True`, ROADMAP A.16)
and joint camera refinement (`refine_camera=True`, ROADMAP A.15); both
raise `NotImplementedError`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.pairs import BatchBuilder, PairSampler, PairSamplerConfig, batch_stream, batch_to_device
from ..data.video_flow import VideoFlowData, bilinear_sample, normalize_xy
from ..device import resolve_device
from ..models import camera as _camera
from ..models.gaussians import GaussianScene, SceneConfig, create_scene
from . import losses as _losses
from . import trainer as _trainer


@dataclass(frozen=True)
class FitConfig:
    """End-to-end fit configuration; the fields and defaults of the JAX
    package's `FitConfig`."""

    num_iters: int = 20000
    num_fg_samples: int = 10000
    num_bg_samples: int = 10000
    capacity_factor: float = 2.0             # slack over the initial points
    video_flow_margin: float = 0.25          # bg border grid, 64 / (margin / 0.25) wide
    init_opacity: float = 0.5
    traj: str = "cubic_spline"
    render_attributes: Tuple[Tuple[str, int], ...] = (
        ("mask_attribute", 1),
        ("dino_attribute", 3),
    )
    num_track_samples: int = 4096
    log_every: int = 100
    seed: int = 0
    # top the lifted tracks up to this many points with static points
    # unprojected from the lifting depth of random pixels (0 = tracks only)
    init_num_points: int = 0
    # a non-finite loss at a log step raises with that step's metrics
    nan_guard: bool = True
    # a torch.profiler trace of steps [start, start + count) into this
    # directory (None = off)
    profile_dir: Optional[str] = None
    profile_start: int = 200
    profile_count: int = 5
    # every this many steps: render every frame, write the per-frame mean
    # |rgb error| to out_dir/flow_error.txt and draw id1 by it (0 = off)
    error_resample_every: int = 0
    distributed: bool = False                # not ported yet (ROADMAP A.16)
    # PSNR / SSIM over `val_frames` evenly spaced frames every `val_every`
    # steps, with the four val hook sites (0 = off)
    val_every: int = 0
    val_frames: int = 4
    refine_camera: bool = False              # not ported yet (ROADMAP A.15)
    camera_lr: float = 1e-4
    camera_prior: float = 1e-2
    camera_warmup: int = 0
    camera_init_xi: Optional[np.ndarray] = None


def _depth_topup_points(data: VideoFlowData, need: int,
                        rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """[need, 3] static canonical-frustum points from random pixels of
    random frames, unprojected with the renormalised lifting depth, and
    their [need, 3] source-frame colours."""
    H, W = data.image_size
    fs = rng.randint(0, data.num_frames, size=need)
    xy = np.stack([rng.uniform(0, W - 1, need), rng.uniform(0, H - 1, need)], axis=1).astype(np.float32)
    pts = np.zeros((need, 3), np.float32)
    cols = np.zeros((need, 3), np.float32)
    pts[:, :2] = normalize_xy(xy, W, H)
    for f in np.unique(fs):
        m = fs == f
        pts[m, 2] = bilinear_sample(data.get_depth(int(f)), xy[m])
        cols[m] = bilinear_sample(np.asarray(data.frames[int(f)], np.float32), xy[m])
    return pts, cols


def lift_clip(data: VideoFlowData, cfg: FitConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The initial point tracks [T, N, 3] and colours [N, 3]: fg tracks, bg
    tracks, the bg border extension, then the depth top-up, drawn from one
    `RandomState(cfg.seed)` in that order."""
    rng = np.random.RandomState(cfg.seed)
    fg_tracks, *_, fg_colors = data.get_tracks_3d(cfg.num_fg_samples, extract_fg=True, rng=rng)
    bg_tracks, *_, bg_colors = data.get_tracks_3d(cfg.num_bg_samples, extract_fg=False, rng=rng)
    ext_tracks, ext_colors = data.extend_track3d(
        bg_tracks, grid_size=int(64 / (cfg.video_flow_margin / 0.25)), margin=cfg.video_flow_margin)

    tracks = np.concatenate([fg_tracks, bg_tracks, ext_tracks], axis=0)  # [N, T, 3]
    colors = np.concatenate([fg_colors, bg_colors, ext_colors], axis=0)
    ok = ~np.isnan(tracks).any(axis=(1, 2))   # drop tracks with NaNs
    tracks, colors = tracks[ok], colors[ok]

    if cfg.init_num_points and tracks.shape[0] < cfg.init_num_points:
        need = cfg.init_num_points - tracks.shape[0]
        pts, cols = _depth_topup_points(data, need, rng)
        tracks = np.concatenate([tracks, np.repeat(pts[:, None, :], tracks.shape[1], axis=1)], 0)
        colors = np.concatenate([colors, cols], 0)
    return np.swapaxes(tracks, 0, 1), colors


def scene_from_tracks(track_seq: np.ndarray, colors: np.ndarray, num_frames: int, cfg: FitConfig,
                      device="cuda") -> Tuple[GaussianScene, SceneConfig]:
    """The spline scene of the lifted tracks, with capacity N *
    capacity_factor rounded up to a multiple of 128."""
    N = track_seq.shape[1]
    capacity = int(np.ceil(N * cfg.capacity_factor / 128) * 128)
    scfg = SceneConfig(capacity=capacity, num_frames=num_frames, traj=cfg.traj,
                       render_attributes=cfg.render_attributes)
    scene = create_scene(scfg, track_seq[0], colors, init_opacity=cfg.init_opacity,
                         track_seq=track_seq if cfg.traj == "cubic_spline" else None, device=device)
    return scene, scfg


def build_scene_from_clip(data: VideoFlowData, cfg: FitConfig,
                          device="cuda") -> Tuple[GaussianScene, SceneConfig]:
    """Lift the clip's tracks and initialise the spline scene on `device`."""
    track_seq, colors = lift_clip(data, cfg)
    return scene_from_tracks(track_seq, colors, data.num_frames, cfg, device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_frame_error_fn(data: VideoFlowData, tcfg: _trainer.TrainerConfig, cam, device):
    """scene -> [T] per-frame mean |rgb error| (numpy), the error map that
    `flow_error.txt` carries: no-grad renders of every frame, one host read."""
    from .. import inference

    rcfg = tcfg.raster_cfg()
    dev = resolve_device(device)
    gts = torch.from_numpy(np.stack([np.asarray(f, np.float32) for f in data.frames])).to(dev)

    def frame_errors(scene: GaussianScene) -> np.ndarray:
        errs = torch.stack([
            torch.mean(torch.abs(
                inference.render_frame(scene, float(t), cam.extrinsic, rcfg, device=dev).features["rgb"]
                - gts[t]))
            for t in range(data.num_frames)
        ])
        return errs.cpu().numpy()

    return frame_errors


def _make_panel_fn(data: VideoFlowData, tcfg: _trainer.TrainerConfig, cam, device):
    """Per-frame image panels for the hooks: rendered rgb, ground truth,
    colourised depth, error map and a track overlay."""
    from .. import inference
    from ..utils import vis as _vis

    rcfg = tcfg.raster_cfg()
    dev = resolve_device(device)

    def panels(scene, t: int):
        t = int(t)
        out = inference.render_frame(scene, float(t), cam.extrinsic, rcfg, device=dev)
        rgb = np.clip(out.features["rgb"].cpu().numpy(), 0, 1)
        depth = out.features["depth"][..., 0].cpu().numpy()
        gt = np.asarray(data.frames[t], np.float32)
        imgs = {
            "rgb_pred": rgb,
            "rgb_gt": gt,
            "depth": _vis.colorize_depth(depth),
            "error": np.repeat(np.abs(rgb - gt).mean(-1, keepdims=True), 3, axis=-1),
        }
        try:
            tr3d = inference.gaussian_trajectories(scene, list(range(t + 1)), sample=128, device=dev)
            px = _losses.denormalize_coords(torch.from_numpy(tr3d[..., :2]), tcfg.height, tcfg.width).numpy()
            imgs["tracks"] = _vis.draw_tracks_2d(rgb, px)
        except Exception:
            pass  # the overlay is best-effort; the panels above always ship
        return imgs

    return panels


def _run_validation(data, scene, render_panels, val_frames, hooks, ctx):
    """PSNR / SSIM over evenly spaced frames, with the four val hook sites."""
    from ..eval import metrics as _metrics
    from .hooks import run_hooks

    run_hooks(hooks, "before_val", ctx)
    T = data.num_frames
    ts = np.unique(np.linspace(0, T - 1, min(val_frames, T)).astype(int))
    psnrs, ssims = [], []
    for t in ts:
        run_hooks(hooks, "before_val_iter", ctx)
        imgs = render_panels(scene, int(t))
        gt = np.asarray(data.frames[int(t)], np.float32)
        psnrs.append(_metrics.psnr(imgs["rgb_pred"], gt))
        ssims.append(_metrics.ssim(imgs["rgb_pred"], gt))
        run_hooks(hooks, "after_val_iter", ctx)
    ctx.val_metrics = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "num_frames": float(len(ts)),
    }
    run_hooks(hooks, "after_val", ctx)


def _read_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All of a step's metrics in one device-to-host read."""
    names = list(metrics)
    vals = torch.stack([metrics[k].reshape(()).to(torch.float32) for k in names]).tolist()
    return dict(zip(names, vals))


def fit_clip(
    data: VideoFlowData,
    fit_cfg: Optional[FitConfig] = None,
    trainer_cfg: Optional[_trainer.TrainerConfig] = None,
    callback: Optional[Callable[[int, Dict], None]] = None,
    hooks: Optional[List] = None,
    out_dir: Optional[str] = None,
    resume: bool = False,
    sampler=None,
    device="cuda",
) -> Tuple[_trainer.TrainState, List[Dict]]:
    """Fit one clip end to end on `device`. Returns (final state, metric
    history of the log steps).

    hooks: `train.hooks.Hook`s, run at their lifecycle sites with a
    `HookContext`. resume=True restores the newest checkpoint under
    `out_dir` and continues from its step; as in the JAX package, the pair
    sampler and the track-row draws then start again from their seeds.
    """
    if fit_cfg is not None and fit_cfg.distributed:
        raise NotImplementedError("distributed=True: data-parallel training is not ported yet (ROADMAP A.16)")
    if fit_cfg is not None and fit_cfg.refine_camera:
        raise NotImplementedError("refine_camera=True: camera refinement is not ported yet (ROADMAP A.15)")
    dev = resolve_device(device)
    t_fit0 = time.time()
    fit_cfg = fit_cfg or FitConfig()
    H, W = data.image_size
    if trainer_cfg is None:
        trainer_cfg = _trainer.TrainerConfig(
            width=W, height=H, num_frames=data.num_frames,
            num_track_samples=fit_cfg.num_track_samples, max_steps=fit_cfg.num_iters,
        )

    track_seq, colors = lift_clip(data, fit_cfg)
    t_lift = time.time()
    scene, scfg = scene_from_tracks(track_seq, colors, data.num_frames, fit_cfg, device=dev)
    _sync(dev)
    t_scene = time.time()
    cam = _camera.canonical_camera(W, H)
    # the per-frame supervision goes to the device once; batches stay slim
    need_mask = trainer_cfg.mask_attr_weight > 0 or trainer_cfg.fg_layer_weight > 0
    need_dino = trainer_cfg.dino_attr_weight > 0
    dinos = [data.get_dino(t) for t in range(data.num_frames)] if need_dino else [None]
    stack = lambda arrs: torch.from_numpy(np.stack([np.asarray(a, np.float32) for a in arrs])).to(dev)
    frames = _trainer.FrameStore(
        rgb=stack(data.frames),
        depth=stack([data.get_loss_depth(t) for t in range(data.num_frames)]),
        mask=stack(data.masks_raw) if need_mask else None,
        dino=stack(dinos) if need_dino and dinos[0] is not None else None,
    )
    train_step, density_step, opacity_reset = _trainer.make_train_step(
        trainer_cfg, cam.extrinsic, frames=frames, device=dev)

    from .hooks import HookContext, run_hooks

    hooks = hooks or []
    ctx = HookContext(out_dir or ".", cfg=trainer_cfg)
    ctx.hooks = hooks
    run_hooks(hooks, "before_run", ctx)

    state = _trainer.init_train_state(trainer_cfg, scene, seed=fit_cfg.seed, device=dev)
    start_step = 0
    if resume and out_dir is not None:
        from ..utils import checkpoint as _ckpt

        restored, ck_step = _ckpt.restore_checkpoint(out_dir, state)
        if restored is not None:
            state, start_step = restored, int(ck_step)
            print(f"resumed from {out_dir} at step {start_step}", flush=True)
            ctx.state = state
            ctx.step = start_step
            run_hooks(hooks, "after_load_checkpoint", ctx)

    ctx.state = state
    run_hooks(hooks, "before_train", ctx)

    # image-panel cadence: the largest image_every any hook asks for
    image_every = max([getattr(h, "image_every", 0) or 0 for h in hooks], default=0)
    # after_train_iter also fires on every hook's own cadence: a
    # CheckPointHook(every=250) with log_every=100 would otherwise save only
    # at multiples of 500
    hook_cadences = sorted({
        c for h in hooks
        for c in (getattr(h, "every", 0), getattr(h, "print_every", 0), getattr(h, "image_every", 0))
        if c
    })
    render_panels = None
    if image_every > 0 or fit_cfg.val_every > 0:
        render_panels = _make_panel_fn(data, trainer_cfg, cam, dev)

    if sampler is None:
        sampler = PairSampler(PairSamplerConfig(num_frames=data.num_frames, seed=fit_cfg.seed))
    builder = BatchBuilder(data, fit_cfg.num_track_samples, seed=fit_cfg.seed, slim=True)

    frame_errors = None
    if fit_cfg.error_resample_every > 0:
        frame_errors = _make_frame_error_fn(data, trainer_cfg, cam, dev)

    history: List[Dict] = []
    densify_totals = {"cloned": 0, "split": 0, "pruned": 0, "dropped": 0, "events": 0}
    densify_events: List[Dict] = []   # each event's step and DensifyInfo, as read there
    densify_stopped = False
    _sync(dev)
    t_start = time.time()
    t_first_step = None  # wall after step 1 completes
    profiler = None
    stream = batch_stream(sampler, builder, fit_cfg.num_iters, start_step=start_step)
    for step, batch in enumerate(stream, start=start_step + 1):
        ctx.step = step
        run_hooks(hooks, "before_train_iter", ctx)
        if fit_cfg.profile_dir is not None:
            if step == fit_cfg.profile_start:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                profiler = profile(activities=acts)
                profiler.start()
            elif profiler is not None and step == fit_cfg.profile_start + fit_cfg.profile_count:
                profiler = _stop_profile(profiler, fit_cfg, dev)
        state, metrics = train_step(state, batch_to_device(batch, dev))
        if t_first_step is None:
            # one deliberate wait: separates the first step (kernel builds,
            # caches) from the steady rate in the timing breakdown
            _sync(dev)
            t_first_step = time.time()
        if _trainer.should_densify(trainer_cfg, step) and not densify_stopped:
            state, dinfo = density_step(state)
            # capacity accounting: candidates that find no free slot are
            # dropped, never silently. Known quirk kept from the JAX package:
            # `dropped` counts candidates, not split parents kept alive, so
            # it undercounts.
            info = {k: int(v) for k, v in dinfo._asdict().items()}
            densify_events.append({"step": step, **info})
            densify_totals["cloned"] += info["num_cloned"]
            densify_totals["split"] += info["num_split"]
            densify_totals["pruned"] += info["num_pruned"]
            densify_totals["dropped"] += info["dropped"]
            densify_totals["events"] += 1
            if info["dropped"] > 0:
                print(f"# densify step {step}: {info['dropped']} candidates dropped (capacity "
                      f"{int(state.scene.cfg.capacity)}, alive {info['num_alive']})", flush=True)
            # saturation latch: a full scene cannot grow, and further events
            # only prune and refill (the churn that collapsed the textured
            # 480p fit in the JAX package). Known quirk kept from the JAX
            # package: the latch lives here in the fit loop, not in
            # density control, and lasts for the rest of the run.
            sat_stop = getattr(trainer_cfg.densify, "saturation_stop", 0.0)
            if sat_stop and info["num_alive"] >= sat_stop * state.scene.cfg.capacity:
                densify_stopped = True
                densify_totals["stopped_at_step"] = step
                print(f"# densify stopped at step {step}: saturation {info['num_alive']}/"
                      f"{int(state.scene.cfg.capacity)} >= {sat_stop:.2f} (churn guard)", flush=True)
        if _trainer.should_reset_opacity(trainer_cfg, step):
            state = opacity_reset(state)
        if frame_errors is not None and step % fit_cfg.error_resample_every == 0 and step < fit_cfg.num_iters:
            errs = np.maximum(frame_errors(state.scene), 1e-8)
            sampler.cfg.error_weights = errs  # biases later id1 draws
            if out_dir is not None:
                np.savetxt(os.path.join(out_dir, "flow_error.txt"), errs)
        fire_log = step % fit_cfg.log_every == 0 or step == fit_cfg.num_iters
        if fire_log or any(step % c == 0 for c in hook_cadences):
            m = _read_metrics(metrics)
            m["step"] = step
            m["alive"] = int(state.scene.num_alive)
            m["capacity"] = int(state.scene.cfg.capacity)
            m["saturation"] = round(m["alive"] / max(m["capacity"], 1), 4)
            if densify_totals["events"]:
                m["densify"] = dict(densify_totals)
            m["wall_s"] = time.time() - t_start
            if fire_log:
                history.append(m)
                if fit_cfg.nan_guard and not np.isfinite(m.get("loss", 0.0)):
                    raise FloatingPointError(f"non-finite loss at step {step}: {m}")
                if callback:
                    callback(step, m)
            ctx.step = step
            ctx.metrics = m
            ctx.state = state
            if render_panels is not None and image_every and step % image_every == 0:
                ctx.images = render_panels(state.scene, step % data.num_frames)
            run_hooks(hooks, "after_train_iter", ctx)
        if fit_cfg.val_every and step % fit_cfg.val_every == 0:
            ctx.step = step
            ctx.state = state
            _run_validation(data, state.scene, render_panels, fit_cfg.val_frames, hooks, ctx)
    if profiler is not None:
        _stop_profile(profiler, fit_cfg, dev)
    if history:
        _sync(dev)   # the last steps' device work belongs in the times
        t_end = time.time()
        timing = {"setup_s": round(t_start - t_fit0, 2), "lift_s": round(t_lift - t_fit0, 2),
                  "create_scene_s": round(t_scene - t_lift, 2)}
        if t_first_step is not None:
            timing["first_step_s"] = round(t_first_step - t_start, 2)
            n_steady = int(state.step) - start_step - 1
            if n_steady > 0:
                # the whole loop after step 1, density events, logging,
                # validation, panels and checkpoints included: run
                # telemetry, not a per-step device time
                timing["steady_ms"] = round((t_end - t_first_step) / n_steady * 1e3, 3)
                timing["steady_includes_hooks"] = True
        timing["total_s"] = round(t_end - t_fit0, 2)
        history[-1]["timing"] = timing
        if densify_totals["events"]:
            history[-1]["densify_totals"] = dict(densify_totals)
            history[-1]["densify_events"] = densify_events
    ctx.step = int(state.step)
    ctx.state = state
    run_hooks(hooks, "after_train", ctx)
    run_hooks(hooks, "after_run", ctx)
    return state, history


def _stop_profile(profiler, fit_cfg: FitConfig, dev: torch.device):
    """End the trace and write it as Chrome JSON under `profile_dir`."""
    _sync(dev)
    profiler.stop()
    os.makedirs(fit_cfg.profile_dir, exist_ok=True)
    end = fit_cfg.profile_start + fit_cfg.profile_count
    profiler.export_chrome_trace(os.path.join(fit_cfg.profile_dir, f"fit_steps_{fit_cfg.profile_start}_{end}.json"))
    return None
