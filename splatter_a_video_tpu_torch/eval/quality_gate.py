"""The quality gate's mini-fit through the port: the `fitted` configuration
of `tests/test_quality_gate.py` (128x96, 12 frames, textured clip, 500
steps, production density control), its reconstruction PSNR, TAP-Vid AJ /
OA and final alive count, held to the bands pinned there (copied here:
the port imports nothing of the JAX package; a CPU test keeps the copies
equal).

    python -m splatter_a_video_tpu_torch.eval.quality_gate [--device cpu]

The same fit without random draws (ARAP off, zero split noise) is held to
the JAX package's values of that fit (`NO_DRAWS_JAX`, from its CPU run in
`tests/test_torch_quality_gate.py`, which keeps them equal to the live
JAX fit) within `NO_DRAWS_TOL`. Prints one JSON line per fit; exits 1 if a
value misses.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Dict

import numpy as np
import torch

W, H, T, STEPS, MAX_INTERSECTIONS = 128, 96, 12, 500, 1 << 15
PINNED = {"psnr": 10.37, "aj": 8.13, "oa": 51.99, "alive": 3537}
PSNR_DROP, AJ_DROP, OA_DROP, ALIVE_REL = 0.75, 4.0, 6.0, 0.25
# the JAX package's fit without random draws (CPU), and how far the port's
# may be from it: PSNR dB, AJ and OA points, alive relative
NO_DRAWS_JAX = {"psnr": 11.233915567398071, "aj": 6.49650529611443, "oa": 74.00568181818183, "alive": 3661}
NO_DRAWS_TOL = {"psnr": 0.05, "aj": 0.5, "oa": 1.0, "alive": 0.005}


def configs():
    """(clip config, FitConfig, TrainerConfig) of the gate's fit."""
    from ..data import synthetic
    from ..train import density, fit, optim, trainer

    clip_cfg = synthetic.SyntheticClipConfig(width=W, height=H, num_frames=T, num_blobs=4, blob_radius=W / 9.0,
                                             track_grid=3, texture=True)
    fcfg = fit.FitConfig(num_iters=STEPS, num_fg_samples=1200, num_bg_samples=800, num_track_samples=256,
                         log_every=100, capacity_factor=1.31, init_num_points=3000)
    tcfg = trainer.TrainerConfig(
        width=W, height=H, num_frames=T, loss_flow_weight=2.0, num_track_samples=256,
        max_intersections=MAX_INTERSECTIONS, arap_sample_num=128, optim=optim.OptimConfig(max_steps=STEPS),
        densify=density.DensifyConfig(densify_start_iter=100, densify_stop_iter=10**9, prune_interval=100,
                                      duplicate_interval=100, opacity_reset_interval=300,
                                      densify_grad_threshold=0.0002, size_prune_always=True))
    return clip_cfg, fcfg, tcfg


def bands(values: Dict[str, float]) -> Dict[str, tuple]:
    """name -> (value, lower bound, upper bound or None, inside)."""
    lo_alive, hi_alive = PINNED["alive"] * (1 - ALIVE_REL), PINNED["alive"] * (1 + ALIVE_REL)
    out = {
        "psnr": (values["psnr"], PINNED["psnr"] - PSNR_DROP, None),
        "aj": (values["aj"], PINNED["aj"] - AJ_DROP, None),
        "oa": (values["oa"], PINNED["oa"] - OA_DROP, None),
        "alive": (values["alive"], lo_alive, hi_alive),
    }
    res = {k: (v, lo, hi, v > lo and (hi is None or v < hi)) for k, (v, lo, hi) in out.items()}
    a = res["alive"]
    res["alive"] = a[:3] + (a[3] and values["alive"] != 3000,)   # a density event must have fired
    return res


def near_jax_without_draws(values: Dict[str, float], ref: Dict[str, float] = NO_DRAWS_JAX) -> Dict[str, tuple]:
    """name -> (value, JAX's value, allowed distance, inside) for a fit
    without random draws."""
    out = {}
    for k, tol in NO_DRAWS_TOL.items():
        allowed = tol * ref[k] if k == "alive" else tol
        out[k] = (values[k], ref[k], allowed, abs(values[k] - ref[k]) < allowed)
    return out


@contextlib.contextmanager
def _zero_split_noise():
    """Density events split with zero noise instead of the key's normal
    draws (the JAX side of the comparison patches `jax.random.normal`)."""
    from ..train import density

    densify = density.densify_and_prune

    def zero_noise(scene, opt_state, state, step, cfg, noise=None, key=None):
        return densify(scene, opt_state, state, step, cfg,
                       noise=torch.zeros((scene.alive.shape[0], 3), device=scene.alive.device), key=key)

    density.densify_and_prune = zero_noise
    try:
        yield
    finally:
        density.densify_and_prune = densify


def run(device="cuda", draws: bool = True, clip=None) -> dict:
    """Fit, render and track; returns the gate's values, the fit history's
    last entry and the fit's seconds. draws=False fits without random
    draws: ARAP off and zero split noise."""
    from .. import inference
    from ..data import synthetic
    from ..device import resolve_device
    from ..models import camera
    from ..ops import rasterize
    from ..train import fit
    from . import metrics, tapvid

    dev = resolve_device(device)
    clip_cfg, fcfg, tcfg = configs()
    clip = clip or synthetic.make_clip(clip_cfg)
    if not draws:
        tcfg = dataclasses.replace(tcfg, arap_weight=0.0)
    with contextlib.nullcontext() if draws else _zero_split_noise():
        t0 = time.perf_counter()
        state, hist = fit.fit_clip(clip, fcfg, tcfg, device=dev)
        fit_s = time.perf_counter() - t0
    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS)
    video = inference.render_video(state.scene, cam, rcfg, list(range(T)), device=dev)
    m = tapvid.evaluate_scene_tracking(state.scene, clip, cam, rcfg, num_queries=128, device=dev)
    values = {"psnr": float(np.mean([metrics.psnr(video["rgb"][t], clip.frames[t]) for t in range(T)])),
              "aj": m["average_jaccard"], "oa": m["occlusion_accuracy"], "alive": hist[-1]["alive"]}
    return {"values": values, "delta_avg": m["delta_avg"], "last": hist[-1], "fit_s": fit_s, "scene": state.scene}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..data import synthetic

    clip = synthetic.make_clip(configs()[0])
    inside = True
    for draws, check in ((True, bands), (False, near_jax_without_draws)):
        r = run(args.device, draws=draws, clip=clip)
        res = check(r["values"])
        inside &= all(x[3] for x in res.values())
        print(json.dumps({"draws": draws, "fit_s": round(r["fit_s"], 2), "delta_avg": r["delta_avg"],
                          "timing": r["last"].get("timing"), "densify_totals": r["last"].get("densify_totals"),
                          "checks": {n: list(x) for n, x in res.items()}}),
              flush=True)
    return 0 if inside else 1


if __name__ == "__main__":
    raise SystemExit(main())
