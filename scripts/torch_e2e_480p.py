"""Production-scale e2e quality harness of the PyTorch/CUDA port: 854x480,
100k init Gaussians, 20k steps, production density control. The port's
counterpart of `scripts/e2e_480p.py`, with the same run shape, the same
`E480_*` environment knobs (same defaults, same meaning) and the same
record, so one command line drives either package:

    E480_TEXTURE=1 E480_GROWTH_FRAC=0.05 E480_LR_STEPS=8000 \\
        python3 scripts/torch_e2e_480p.py

Runs on the GPU (`device="cuda"`, no fallback); `E480_CPU=1` runs the plain
PyTorch path on the CPU. Writes the record to
`METRICS_480p{suffix}_torch.json` and the fitted scene to
`out/e480_torch/` (the JAX script's npz names and keys), never to the JAX
package's files; `E480_QUICK=1` (214x120, 8 frames) writes nothing. The
record is also the last line of standard output.
"""

import dataclasses
import json
import os
import resource
import sys
import time
from typing import Callable, Mapping, Optional

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np
import torch

from splatter_a_video_tpu_torch import inference
from splatter_a_video_tpu_torch.data import synthetic
from splatter_a_video_tpu_torch.device import hardware, resolve_device
from splatter_a_video_tpu_torch.eval import metrics, tapvid
from splatter_a_video_tpu_torch.models import camera
from splatter_a_video_tpu_torch.ops import rasterize
from splatter_a_video_tpu_torch.train import density, fit, optim, trainer

FLAGSHIP_T, FLAGSHIP_CAPF = 48, 1.31


@dataclasses.dataclass(frozen=True)
class Settings:
    """The run as `scripts/e2e_480p.py` reads it from the environment."""

    env: Mapping[str, str]
    quick: bool
    texture: bool
    steps: int
    frames: int
    width: int
    height: int
    fg: int
    bg: int
    init_n: int
    maxi: int
    ntrack: int
    grid: int
    flow_w: float
    capf: float
    attr_w: float
    densify: bool

    def get(self, name: str, default: str) -> str:
        return self.env.get(name, default)


def read_env(env: Optional[Mapping[str, str]] = None) -> Settings:
    """The knobs of `scripts/e2e_480p.py:42-84`, with its defaults."""
    env = dict(os.environ if env is None else env)
    quick = env.get("E480_QUICK", "0") == "1"
    texture = env.get("E480_TEXTURE", "0") == "1"
    T = int(env.get("E480_FRAMES", "8" if quick else "48"))
    W, H = (214, 120) if quick else (854, 480)
    FG, BG = (500, 300) if quick else (60_000, 40_000)
    return Settings(
        env=env, quick=quick, texture=texture,
        steps=int(env.get("E480_STEPS", "300" if quick else "20000")),
        frames=T, width=W, height=H, fg=FG, bg=BG,
        init_n=800 if quick else 100_000,   # topped up with depth-unprojected points
        # 1 << 20: the production-density run reaches ~684k intersections at
        # 131k Gaussians (the reference allocates dynamically)
        maxi=(1 << 15) if quick else int(env.get("E480_MAXI", str(1 << 20))),
        ntrack=512 if quick else 4096,
        # stride-2 query grid at T <= 64 (T^2 * n * 16 B of GT tracks: 3.8 GB
        # at T = 48), stride 4 for longer clips
        grid=int(env.get("E480_TRACK_GRID", "4" if quick else ("2" if T <= 64 else "4"))),
        # flow weight 20 binds tracking on the textureless blob clip; the
        # textured clip takes the reference's production weight 2
        flow_w=float(env.get("E480_FLOW_W", "2.0" if texture else "20.0")),
        capf=float(env.get("E480_CAPF", str(FLAGSHIP_CAPF))),
        # the reference's hand-enabled mask supervision at weight 20
        attr_w=20.0 if env.get("E480_ATTR", "0") == "1" else 0.0,
        densify=env.get("E480_DENSIFY", "1") == "1",
    )


def clip_config(s: Settings) -> synthetic.SyntheticClipConfig:
    return synthetic.SyntheticClipConfig(
        width=s.width, height=s.height, num_frames=s.frames,
        blob_radius=(10.0 if s.quick else 42.0), num_blobs=6,
        track_grid=s.grid, texture=s.texture,
    )


def fit_configs(s: Settings):
    """(FitConfig, TrainerConfig) as `scripts/e2e_480p.py:82-155`."""
    fcfg = fit.FitConfig(
        num_iters=s.steps, num_fg_samples=s.fg, num_bg_samples=s.bg,
        num_track_samples=s.ntrack, log_every=max(s.steps // 40, 1),
        capacity_factor=s.capf, init_num_points=s.init_n,
    )
    if s.densify:
        # production values (frag_gs_v10.yaml: start 500, no stop within 20k,
        # reset every 3000, threshold 0.0002) and the atlas optimizer's
        # unconditional size prune; max_growth_frac is the per-event growth
        # budget (0 = the reference's unlimited growth)
        dcfg = density.DensifyConfig(
            densify_start_iter=int(s.get("E480_DENSIFY_START", "500")),
            densify_stop_iter=int(s.get("E480_DENSIFY_STOP", "100000")),
            prune_interval=int(s.get("E480_DENSIFY_INT", "100")),
            duplicate_interval=int(s.get("E480_DENSIFY_INT", "100")),
            opacity_reset_interval=int(s.get("E480_RESET_INT", "3000")),
            densify_grad_threshold=float(s.get("E480_GRAD_TH", "0.0002")),
            max_growth_frac=float(s.get("E480_GROWTH_FRAC", "0")),
            size_prune_always=s.get("E480_SIZE_PRUNE_ALWAYS", "1") == "1",
        )
    else:   # E480_DENSIFY=0: no density control and no reset (a diagnostic)
        dcfg = density.DensifyConfig(densify_start_iter=s.steps + 1, densify_stop_iter=s.steps + 1,
                                     opacity_reset_interval=10**9)
    tcfg = trainer.TrainerConfig(
        width=s.width, height=s.height, num_frames=s.frames,
        nearest=float(s.get("E480_NEAREST", "0.2")),
        loss_flow_weight=s.flow_w,
        mask_attr_weight=s.attr_w,
        # the fg-layer re-render is gated apart from the mask term
        fg_layer_weight=(s.attr_w if s.get("E480_FG_LAYER", "") == "1" else 0.0),
        num_track_samples=s.ntrack, max_intersections=s.maxi,
        # E480_LR_STEPS decouples the lr-annealing horizon from the step
        # count; past it the schedule's final lr holds (expon_lr clamps)
        optim=optim.OptimConfig(max_steps=int(s.get("E480_LR_STEPS", str(s.steps)))),
        densify=dcfg,
    )
    return fcfg, tcfg


def scene_path(s: Settings, root: str = ROOT) -> str:
    """Where the fitted scene goes: out/e480_torch/, the JAX script's names
    (a run other than the flagship shape does not replace its scene)."""
    name = "final_scene.npz"
    if s.frames != FLAGSHIP_T or s.capf != FLAGSHIP_CAPF or s.attr_w or s.get("E480_SUFFIX", ""):
        name = f"final_scene_T{s.frames}_c{s.capf}{'_attr' if s.attr_w else ''}{s.get('E480_SUFFIX', '')}.npz"
    return os.path.join(root, "out", "e480_torch", name)


def record_path(s: Settings, capacity: int, root: str = ROOT) -> str:
    """METRICS_480p{suffix}_torch.json, the JAX script's suffix rules."""
    suffix = "" if s.texture else "_blobs"
    if not s.densify:
        suffix = "_nodensify"
    if s.frames != FLAGSHIP_T and not s.quick:
        suffix += f"_T{s.frames}"
    if s.capf != FLAGSHIP_CAPF:
        suffix += f"_c{int(capacity / 1000)}k"
    if s.attr_w:
        suffix += "_attr"
    if s.get("E480_SUFFIX", ""):
        suffix += "_" + s.get("E480_SUFFIX", "")
    return os.path.join(root, f"METRICS_480p{suffix}_torch.json")


def save_scene(path: str, scene) -> None:
    """Every parameter, `alive` and `spline_knots`, as numpy arrays."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in scene.params.items()},
             alive=scene.alive.cpu().numpy(), spline_knots=scene.aux["spline_knots"].cpu().numpy())


def step_printer(t0: float) -> Callable[[int, dict], None]:
    return lambda s, m: print(
        f"step {s}: loss={m['loss']:.3f} psnr={m['psnr']:.2f} "
        f"rgb={m['loss_rgb']:.3f} flow={m['loss_flow']:.3f} "
        f"depth={m['loss_depth']:.3f} arap={m['loss_arap']:.4f} "
        f"alive={m['alive']} {s / (time.time() - t0):.1f} it/s", flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(s: Settings, device="cuda", hooks=None, write: Optional[bool] = None, root: str = ROOT):
    """Fit the clip, evaluate it as `scripts/e2e_480p.py:157-213` does and
    build its record. Writes the scene and the record under `root` unless
    QUICK (or `write` is False). Returns (record, final train state, fit
    history, clip)."""
    dev = resolve_device(device)
    write = (not s.quick) if write is None else write
    t_clip = time.time()
    clip = synthetic.make_clip(clip_config(s))
    clip_s = time.time() - t_clip
    fcfg, tcfg = fit_configs(s)

    t0 = time.time()
    state, hist = fit.fit_clip(clip, fcfg, tcfg, callback=step_printer(t0), hooks=hooks, device=dev)
    train_min = (time.time() - t0) / 60
    print(f"trained {s.steps} steps in {train_min:.1f} min", flush=True)

    scene = state.scene
    T, W, H = s.frames, s.width, s.height
    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=s.maxi)
    if write:
        save_scene(scene_path(s, root), scene)

    ev = {}
    t1 = time.time()
    res = inference.render_video(scene, cam, rcfg, list(range(T)), device=dev)
    ev["render_video_s"] = round(time.time() - t1, 2)
    # intersection-budget audit: a truncated render (at the budget ceiling)
    # silently degrades eval while training adapts around it
    sub = list(range(0, T, max(T // 6, 1)))
    ni = [int(inference.render_frame(scene, t, cam.extrinsic, rcfg, device=dev).num_intersections) for t in sub]
    print(f"eval num_intersections: max {max(ni)} of budget "
          f"{rcfg.max_intersections} {'*** OVERFLOW ***' if max(ni) >= rcfg.max_intersections else ''}",
          flush=True)
    t1 = time.time()
    psnrs = [metrics.psnr(res["rgb"][t], clip.frames[t]) for t in range(T)]
    ssims = [metrics.ssim(res["rgb"][t], clip.frames[t]) for t in range(T)]
    ev["psnr_ssim_host_s"] = round(time.time() - t1, 2)
    t1 = time.time()
    lp = [metrics.lpips(res["rgb"][t], clip.frames[t], device=dev) for t in sub]
    lp_pre = bool(metrics.lpips_is_pretrained(device=dev))
    _sync(dev)
    ev["lpips_s"] = round(time.time() - t1, 2)
    print(f"recon: PSNR {np.mean(psnrs):.2f} SSIM {np.mean(ssims):.4f} "
          f"LPIPS {np.mean(lp):.4f}{'' if lp_pre else ' (random-trunk)'}", flush=True)

    t1 = time.time()
    m = tapvid.evaluate_scene_tracking(scene, clip, cam, rcfg, num_queries=256, device=dev)
    ev["tapvid_s"] = round(time.time() - t1, 2)
    print("tapvid:", json.dumps({k: round(v, 2) for k, v in m.items()}), flush=True)

    # the fit's phase split, then the clip's generation, the evaluation's
    # parts and the host's peak resident memory (Linux: KiB)
    timing = dict(hist[-1].get("timing", {}))
    timing.update(clip_s=round(clip_s, 2), eval=ev,
                  host_peak_rss_gib=round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2))
    d = tcfg.densify
    out = {
        "date": time.strftime("%Y-%m-%d"),
        "scale": {"width": W, "height": H, "frames": T, "steps": s.steps,
                  "track_grid": s.grid, "attr_weight": s.attr_w,
                  "texture": s.texture, "loss_flow_weight": s.flow_w,
                  "init_points_requested": s.init_n,
                  "init_points": int(hist[0]["alive"]),
                  "capacity": int(scene.cfg.capacity),
                  "densify": s.densify,
                  "densify_start_iter": d.densify_start_iter,
                  "densify_interval": d.duplicate_interval,
                  "max_growth_frac": d.max_growth_frac,
                  "densify_grad_threshold": d.densify_grad_threshold,
                  "opacity_reset_interval": d.opacity_reset_interval,
                  "size_prune_always": d.size_prune_always,
                  "cameras_extent": d.cameras_extent},
        "train_minutes": round(train_min, 2),
        "timing": timing,
        "final_alive": int(hist[-1]["alive"]),
        "saturation": hist[-1].get("saturation"),
        "densify_totals": hist[-1].get("densify_totals"),
        "eval_num_intersections": {"max": max(ni), "budget": int(rcfg.max_intersections),
                                   "overflow": max(ni) >= rcfg.max_intersections},
        "recon": {"psnr": round(float(np.mean(psnrs)), 2),
                  "ssim": round(float(np.mean(ssims)), 4),
                  "lpips_fallback": round(float(np.mean(lp)), 4),
                  "lpips_is_pretrained": lp_pre,
                  "psnr_per_frame": [round(p, 2) for p in psnrs],
                  "psnr_min": round(float(np.min(psnrs)), 2),
                  "psnr_max": round(float(np.max(psnrs)), 2)},
        "tapvid": {k: round(float(v), 2) for k, v in m.items()},
        "hardware": hardware(dev),
    }
    if write:
        dest = record_path(s, int(scene.cfg.capacity), root)
        with open(dest, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {os.path.abspath(dest)}", flush=True)
    return out, state, hist, clip


def main() -> int:
    s = read_env()
    out = run(s, device="cpu" if s.get("E480_CPU", "0") == "1" else "cuda")[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
