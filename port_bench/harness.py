"""One run of one cell: set-up, the measured window, the check, the trace.

The window drives the program's own entry point, `train.fit.fit_clip`, with
the cell's configuration. A `WindowHook` (a `train.hooks.Hook`) opens the
window at the first step after the warm-up, with a synchronize, counts the
steps, and closes it with a synchronize once `seconds` have passed, by
raising `WindowClosed` out of the fit. A `Probe` wraps the train and density
steps that `fit_clip` builds, passing every call through unchanged: it
notes what the check compares (the first steps' losses, Adam's first
moments, the parameters' change, the density event's state before and
after) and, in a traced run, the traced steps' intersection counts.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch
from splatter_a_video_tpu_torch.train.hooks import Hook

from . import clip as _clip
from . import compare as _compare
from . import trace as _trace

FIT_SEED_MOD = 2 ** 32     # numpy's RandomState and the program's key take 32-bit seeds


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class WindowClosed(Exception):
    """Raised out of the fit loop when the measured window has closed."""


def fit_seed(seed: int) -> int:
    return int(seed) % FIT_SEED_MOD


def program_configs(cfg: dict, seed: int):
    """The program's (FitConfig, TrainerConfig) for the cell's configuration."""
    from splatter_a_video_tpu_torch.train import density, fit, optim, trainer

    r = cfg["recipe"]
    W, H = cfg["frame_size"]
    oc, lc, rc, fc = r["optim"], r["loss"], r["raster"], r["fit"]
    opt = optim.OptimConfig(
        max_steps=oc["lr_max_steps"], eps=oc["eps"], b1=oc["b1"], b2=oc["b2"],
        spatial_lr_scale=oc["spatial_lr_scale"], lrs=tuple(sorted(oc["lrs"].items())),
        schedules=tuple(sorted((k, tuple(v)) for k, v in oc["schedules"].items())))
    dens = density.DensifyConfig(densify_start_iter=cfg["densify_start_iter"], **r["density"])
    tcfg = trainer.TrainerConfig(
        width=W, height=H, num_frames=cfg["num_frames"],
        loss_rgb_weight=lc["rgb_weight"], loss_flow_weight=lc["flow_weight"], lambda_dssim=lc["lambda_dssim"],
        depth_loss_weight=lc["depth_weight"], depth_bg=rc["depth_bg"], arap_weight=lc["arap_weight"],
        arap_sample_num=lc["arap_sample_num"], arap_knn=lc["arap_knn"],
        num_track_samples=fc["num_track_samples"], track_quantile=lc["track_quantile"],
        train_render_attributes=lc["train_render_attributes"], mask_attr_weight=lc["mask_attr_weight"],
        dino_attr_weight=lc["dino_attr_weight"], fg_layer_weight=0.0,
        max_intersections=cfg["max_intersections"], max_tiles_per_gaussian=rc["max_tiles_per_gaussian"],
        nearest=rc["nearest"], block_x=rc["block"], block_y=rc["block"], white_bg=rc["white_bg"],
        max_steps=cfg["num_iters"], optim=opt, densify=dens)
    fcfg = fit.FitConfig(
        num_iters=cfg["num_iters"], num_fg_samples=cfg["num_fg_samples"], num_bg_samples=cfg["num_bg_samples"],
        capacity_factor=cfg["capacity_factor"], video_flow_margin=fc["video_flow_margin"],
        init_opacity=fc["init_opacity"], traj=cfg["traj"],
        render_attributes=tuple((k, int(v)) for k, v in fc["render_attributes"].items()),
        num_track_samples=fc["num_track_samples"], log_every=fc["log_every"], seed=fit_seed(seed),
        init_num_points=cfg["alive_at_start"])
    return fcfg, tcfg


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Probe:
    """Notes what the check needs from the program's own steps, and passes
    every call through unchanged."""

    def __init__(self, check_steps: int, trace_steps=()):
        self.check_steps = check_steps
        self.trace_steps = set(trace_steps)
        self.capture_s = 0.0                 # host seconds spent copying for the check
        self.init: Optional[dict] = None
        self.losses: List[torch.Tensor] = []
        self.pairs: List[tuple] = []
        self.mu1: Optional[Dict[str, torch.Tensor]] = None
        self.change: Optional[Dict[str, torch.Tensor]] = None
        self.event_pre: Optional[dict] = None
        self.event_post: Optional[dict] = None
        self.events: List[dict] = []
        self.traced: List[dict] = []
        self.trace_scene = None
        self._p0 = None
        self.t_fit = self.t_first = None
        self.phases: Dict[str, float] = {}
        self.nint1 = None

    def _timed(self, fn):
        t0 = time.perf_counter()
        fn()
        self.capture_s += time.perf_counter() - t0

    def on_step(self, state, batch, new_state, metrics):
        step = int(new_state.step)
        if step == 1:
            self.t_first = time.perf_counter()
            _say(f"[phase] first_step_at {self.t_first - self.t_fit!r}")
            def grab():
                sc = state.scene
                self.init = {"params": {k: _to_host(v) for k, v in sc.params.items()},
                             "alive": _to_host(sc.alive),
                             "knots": _to_host(sc.aux["spline_knots"]) if "spline_knots" in sc.aux else None}
                self.mu1 = {k: torch.linalg.vector_norm(v) for k, v in new_state.opt_state.mu.items()}
            self._timed(grab)
            self._p0 = state.scene.params
        if step <= self.check_steps:
            self.losses.append(metrics["loss"])
            self.pairs.append((int(batch.t1), int(batch.t2)))
        if step == self.check_steps:
            self.change = {k: torch.linalg.vector_norm(v - self._p0[k]) for k, v in new_state.scene.params.items()}
            self._p0 = None
        if step in self.trace_steps:
            if self.trace_scene is None:
                self.trace_scene = state.scene
            self.traced.append({"t1": int(batch.t1), "t2": int(batch.t2), "nint": metrics["num_intersections"]})
        if step == 1:
            self.nint1 = metrics["num_intersections"]

    def on_event(self, state, out):
        new_state, info = out
        rec = {"step": int(state.step), **{k: int(v) for k, v in info._asdict().items()}}
        self.events.append(rec)
        if self.event_pre is not None:
            return

        def grab():
            sc, ds = state.scene, state.densify_state
            self.event_pre = {"params": {k: _to_host(v) for k, v in sc.params.items()}, "alive": _to_host(sc.alive),
                              "accum": _to_host(ds.pos_grad_accum), "denom": _to_host(ds.denom),
                              "step": int(state.step), "key": state.key.clone()}
            used = new_state.scene.alive & ~sc.alive
            mom = sum(int(((v != 0).reshape(v.shape[0], -1).any(1) & used).sum()) for v in
                      list(new_state.opt_state.mu.values()) + list(new_state.opt_state.nu.values())
                      if v.dim() and v.shape[0] == used.shape[0])
            self.event_post = {"params": {k: _to_host(v) for k, v in new_state.scene.params.items()},
                               "alive": _to_host(new_state.scene.alive), "counts": rec, "moments_left": mom}
        self._timed(grab)

    @contextlib.contextmanager
    def installed(self):
        """Wrap `trainer.make_train_step` for the fit that runs inside."""
        from splatter_a_video_tpu_torch.train import trainer

        made = trainer.make_train_step
        probe = self

        def make_train_step(*a, **k):
            train_step, density_step, reset = made(*a, **k)

            def probed_train_step(state, batch, arap_idx=None):
                new_state, metrics = train_step(state, batch, arap_idx)
                probe.on_step(state, batch, new_state, metrics)
                return new_state, metrics

            def probed_density_step(state, noise=None):
                out = density_step(state, noise)
                probe.on_event(state, out)
                return out

            return probed_train_step, probed_density_step, reset

        from splatter_a_video_tpu_torch.train import fit

        lift, scene = fit.lift_clip, fit.scene_from_tracks

        def timed(name, fn):
            def call(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                probe.phases[name] = time.perf_counter() - t
                _say(f"[phase] {name} {probe.phases[name]!r}")
                return out
            return call

        trainer.make_train_step = make_train_step
        fit.lift_clip, fit.scene_from_tracks = timed("lift_s", lift), timed("scene_s", scene)
        try:
            yield self
        finally:
            trainer.make_train_step = made
            fit.lift_clip, fit.scene_from_tracks = lift, scene


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class WindowHook(Hook):
    """Opens the window before step `first`, closes it after `seconds`;
    with a trace, profiles steps [first + skip, first + skip + count)."""

    def __init__(self, dev, first: int, seconds: float, trace_skip: int = 0, trace_count: int = 0,
                 trace_path: Optional[str] = None):
        self.dev, self.first, self.seconds = dev, first, seconds
        self.trace_at = first + trace_skip if trace_count else None
        self.trace_end = first + trace_skip + trace_count if trace_count else None
        self.trace_path = trace_path
        self.t_open = self.t_close = None
        self.steps = 0
        self.prof = None
        self.step_mark = None

    def before_train_iter(self, ctx) -> None:
        step = int(ctx.step)
        if self.step_mark is not None:
            self.step_mark.__exit__(None, None, None)
            self.step_mark = None
        if step == self.first:
            _sync(self.dev)
            self.t_open = time.perf_counter()
        if self.t_open is None:
            return
        if self.trace_at is not None:
            if step == self.trace_at:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
                self.prof = profile(activities=acts)
                self.prof.start()
            elif step == self.trace_end and self.prof is not None:
                _sync(self.dev)
                self.prof.stop()
                self.prof.export_chrome_trace(self.trace_path)
                self.prof = None
            if self.prof is not None:
                self.step_mark = torch.profiler.record_function(_trace.STEP_MARK)
                self.step_mark.__enter__()
        if time.perf_counter() - self.t_open >= self.seconds and (self.trace_end is None or step > self.trace_end):
            _sync(self.dev)
            self.t_close = time.perf_counter()
            self.steps = step - self.first
            raise WindowClosed()


def run_cell(cfg: dict, traffic: dict, limits: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, readers: Dict[str, object], metric_names: List[str], keep: bool = False) -> dict:
    """Set up, measure, check and (with `trace`) trace one run of a cell.
    Returns the result line's fields and the numbers compared; with `keep`,
    also the check's inputs and the reference's results (for the control)."""
    from splatter_a_video_tpu_torch.train import fit

    dev = torch.device(device)
    warm, check_steps = traffic["warm_steps"], traffic["check_steps"]
    skip, count = traffic["trace_skip"], traffic["trace_steps"]
    first = warm + 1
    trace_steps = range(first + skip, first + skip + count) if trace else ()
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    trace_path = os.path.join(tmp, "trace.json")
    phases = {}
    t = time.perf_counter()
    clip = _clip.make_clip(_clip.spec_from_config(cfg), seed, dev)
    phases["clip_s"] = time.perf_counter() - t
    _say(f"[phase] clip_s {phases['clip_s']!r}")
    t = time.perf_counter()
    data = _clip.to_video_flow(clip)
    phases["video_flow_s"] = time.perf_counter() - t
    _say(f"[phase] video_flow_s {phases['video_flow_s']!r}")
    fcfg, tcfg = program_configs(cfg, seed)
    probe = Probe(check_steps, trace_steps)
    win = WindowHook(dev, first, seconds, skip if trace else 0, count if trace else 0, trace_path)
    probe.t_fit = time.perf_counter()
    with probe.installed():
        try:
            fit.fit_clip(data, fcfg, tcfg, hooks=[win], device=dev)
        except WindowClosed:
            pass
    if win.t_close is None:
        raise RuntimeError(f"the fit ended before the window closed ({cfg['num_iters']} steps)")
    phases.update(probe.phases)
    phases["fit_to_first_step_s"] = probe.t_first - probe.t_fit
    phases["warm_steps_s"] = win.t_open - probe.t_first
    phases["capture_s"] = probe.capture_s
    setup_s = win.t_open - t_start - probe.capture_s
    fit_ms = (win.t_close - win.t_open) / win.steps * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the program's numbers, then its state goes before the reference runs
    prog = {"losses": [float(x) for x in probe.losses], "pairs": list(probe.pairs),
            "grad_norms": {k: float(v) / (1.0 - cfg["recipe"]["optim"]["b1"]) for k, v in probe.mu1.items()},
            "change_norms": {k: float(v) for k, v in probe.change.items()},
            "events": probe.events, "event_post": probe.event_post}
    traced = [{"t1": d["t1"], "t2": d["t2"], "nint": int(d["nint"])} for d in probe.traced]
    phases["intersections_step1"] = int(probe.nint1)
    trace_scene = probe.trace_scene
    init, event_pre = probe.init, probe.event_pre
    del probe, data
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {"setup_s": setup_s, "fit_ms_per_step": fit_ms, "steps": win.steps, "memory_peak_bytes": peak,
           "phases": phases,
           "alive_at_start": int(init["alive"].sum()), "capacity": int(init["alive"].shape[0]),
           "events": prog["events"]}
    if trace:
        summary = _trace.summarize(trace_path, count, cfg)
        counts = _trace.blend_counts(trace_scene, traced, clip, cfg, dev)
        del trace_scene
        ctx = {"summary": summary, "counts": counts, "traced": traced, "cfg": cfg}
        out["per_layer"] = {}
        for name in metric_names:
            v = readers[name].read(ctx)
            if v is not None:
                out["per_layer"][name] = v
        out["busy_s"], out["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = summary["breakdown"]
        with contextlib.suppress(OSError):
            os.remove(trace_path)
    with contextlib.suppress(OSError):
        os.rmdir(tmp)
    t_ref = time.perf_counter()
    res = _compare.check(prog, init, event_pre, clip, cfg, limits, fit_seed(seed), check_steps, dev)
    out["check"] = res.pop("check")
    out["phases"]["reference_s"] = time.perf_counter() - t_ref
    if keep:
        out["kept"] = {"init": init, "clip": clip, "event_pre": event_pre, **res}
    return out
