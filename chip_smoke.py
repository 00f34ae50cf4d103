#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Builds the port's four CUDA kernels from `splatter_a_video_tpu_torch/csrc/`
and holds each against its plain PyTorch version at the flagship shapes
(854x480, 131,000 Gaussians of which 100,000 alive, degree-3 SH):

  render: K1 blend_forward and K2 expand_intersections with the mask /
     pos_poly_feat / dino render attributes (C = 20 blended channels, and
     widened to C = 32, the largest channel bucket), K2 also at a saturated
     budget (M = 1 << 18, fewer slots than frame 0's intersections), then a
     5-frame video through `inference.render_video`;
  train: K3 blend_backward and K4 reduce_gaussians at the training blend
     (rgb, depth, track_gs: C = 7, track_gs masked from opacity; also
     widened to C = 32), K4 also on the rows of the saturated budget, the
     gradients of the 64x48 training render on the card against the CPU,
     then ten steps of `trainer.make_train_step` with a density step and an
     opacity reset;
  fit (phases 12-14): 300 steps of `fit.fit_clip` at full width on the
     textured clip of `scripts/e2e_480p.py` (100,000 Gaussians in 131,072
     slots; cut: 300 steps, the density schedule moved forward so events
     fire at steps 200 and 300, track grid 4), its setup, steady ms/step,
     device busy share, the host time of its random draws and a checkpoint
     round trip; the same fit a second time, held `torch.equal` to the
     first after each density event and at the end; the mini-fit of
     `tests/test_quality_gate.py` on the card against its pinned bands (PSNR and alive held; AJ and OA printed
     beside theirs), and without random draws held to the JAX package's
     fit and to all four bands (see `mini_fit_phase`); the training CLI
     (`apps.train --synthetic`: train, checkpoint, `--resume`, reload and
     render) and the native track loader, built with this machine's g++;
  side paths (phases 15-18): editing the flagship scene (selection at
     K_idx 10 under the central 427x240, 20 appearance steps, 5 whole-frame
     steps, layers, a moved copy); pose refinement from 4 frames at known
     twists, then 30 steps of `fit_clip(refine_camera=True)` on phase 12's
     clip with a checkpoint and a resume; two atlases at full width; the
     perspective engine at 800x800 with `EngineConfig`'s defaults. Their
     new blend instances (K1 at K_idx 10 and at C = 4, K3 and K4 at C = 4,
     the engine's perspective C = 4) are held to the plain versions too;
  data parallel, slabs, networks (phases 19-21): a process group of one
     rank (NCCL, a FileStore): ten `make_dp_train_step` steps at the
     training shape, one DP step on the card against the same step on the
     CPU (gloo) at 64x48 at the gradient bars, one atlas and one joint DP
     step; the flagship frame (C = 4) as 4 depth slabs folded, against the
     single render (bar 1.2e-2), and the collective render at world size 1
     `torch.equal` to the fold of one slab; Depth-Anything-V2-small,
     TAPIR, LPIPS and the VGG perceptual loss at their default
     configurations with random weights, timed, and held against the
     port's CPU path on smaller inputs at the JAX package's bars;
  the loss library (phase 22): the first-K entropy and blend on the
     flagship frame's ids at K_idx 10, the depth correlation, scale-shift-
     invariant and range losses on its depth, the feature smoothness over
     the scene's positions and the distortion loss, each against the CPU
     (values and gradients) and each gradient twice on the card,
     `torch.equal`;
  the lbs scene's random draws (C.7): `create_scene(traj="lbs")` without
     a key or generator twice on the card at the flagship size, every
     parameter `torch.equal`, and its colours and skinning logits on the
     card equal to the CPU call's at LBS_POINTS points;
  the blend's wide instances (phase 23): ten `make_train_step` steps and a
     density step at the training shape with a 32-wide DINO attribute
     blended and supervised (C = 52, R = 60 rows into K4), one
     `inference.render_frame` with the three render attributes (C = 49),
     K1, K3 and K4 at C = 33, 52, 64 and 200 and on 32x32 and 12x12 tiles
     (C = 7 and 52) and on tiles above the 1024 threads of a block (64x32
     at C = 7, 48x48 at C = 52; there also `splat_scene` forward and
     backward), and the 64x48 training render at C = 52 on the card against
     the CPU;
  the tutorials and the TAPIR converter (phase 24): `examples/
     torch_gs_2d.py` at 256x256 with 10,000 Gaussians all at depth 1.0
     (every tile blends ties: C = 3, R = 11), step 0's render and gradients
     against the CPU, 500 of its 2,000 iterations (PSNR up, depth still
     1.0), two 50-iteration fits `torch.equal` and their first losses
     against the CPU; `examples/torch_gs_3d.py`'s 12 perspective views of
     a 20,000-point torus (C = 4) against the CPU; K1-K4 at both
     tutorials' instances; `scripts/torch_convert_tapir.py` on a random
     state dict, its weights loaded and run on the card against the CPU.
  the production harness (phase 25): `scripts/torch_e2e_480p.py` in the
     flagship's environment (textured clip, growth budget 0.05, lr horizon
     8000, track_grid 2, 100,000 points in 131,072 slots, budget 1 << 20),
     cut to 800 of 20,000 steps so that the production schedule's first
     density events fire at their production steps; its fit and evaluation
     (finite, unsaturated, the JAX script's record keys, PSNR above the
     scene step 1 starts from, the schedule's event count); K1-K4 on the
     fitted scene's frame 0; then `scripts/torch_capability_480p.py` on
     the saved scene at its full sizes and step counts, every section's
     numbers finite. Both write into a temporary directory.

Every kernel check is `torch.equal` against the plain version.

The launch counters are set to 0 just before each of the main paths (the
video render, the ten train steps, the fit, each side path's steps, the DP
steps, the slab render, the wide train steps, the gs_2d fit, the gs_3d
orbit, the production harness and the capability harness) and read just
after; the kernel table's `launches` are the fit's,
one per kernel and step. Each phase
prints one line; any failure ends the run with a non-zero exit and no
result line. The `[times]` lines and the kernel table carry each kernel's
registers per thread, local (spill) bytes per thread and shared bytes per
block at the main path's instance (`rasterize_gpu.kernel_attributes`),
the port's kernels' own times inside the frame and step profiles, and
beside K2 and K4 the PyTorch calls that do part of their work (the owners
alone, a fill of K2's outputs, the gather of K4's rows), as references.
The kernel table's `instances` list the side paths', phase 23's, phase
24's and phase 25's blend instances (K4's beside `index_add_`), and phase
24's and 25's K2. The
line before the last is the kernel table as JSON, the last line
`{"ok": true, "device": {...}}`. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

W, H = 854, 480
CAPACITY, ALIVE, FRAMES = 131_000, 100_000, 48
MAX_INTERSECTIONS = 1 << 20
SATURATED = 1 << 18     # a budget below the flagship frames' ~486k intersections
EXTRA = ("mask_attribute", "pos_poly_feat", "dino_attribute")
TIMES = (0, 1.5, 7, 23, 47)
ATOL = 2e-5             # the 64x48 render on the card against the CPU and the oracle
REPS = 20
DEVICE = "cuda"
TRAIN_T1, TRAIN_T2, TRAIN_STEPS, TRACKS = 7, 23, 10, 4096
TRAIN_MASK = (1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0)   # rgb 3, depth 1 reach opacity; track_gs 3 not
WIDE_C = 32             # the largest channel bucket of K1 (and of K3 above 256 pixels)
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3   # gradients, the bars of tests/test_rasterize.py
PLAIN_REPS = 3          # the plain versions read counts back, so each run waits for the card
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, CUDA cores
# the full-width fit: scripts/e2e_480p.py:54-120 with the textured clip, cut
FIT_STEPS = 300
FIT_CLIP = dict(width=W, height=H, num_frames=FRAMES, num_blobs=6, blob_radius=42.0, track_grid=4, texture=True)
FIT_DENSITY = dict(densify_start_iter=100, duplicate_interval=100, prune_interval=100, opacity_reset_interval=200)
FIT_CUTS = ("300 of 20,000 steps; density schedule moved forward (start 100, interval 100, opacity reset 200: "
            "events at 200 and 300, reset at 201); track_grid 4, not 2")
# phase 15, editing the flagship scene
EDIT_T, EDIT_MASK, EDIT_K = 0.0, (427, 240), 10           # the central 427x240 at t = 0, first-K ids
EDIT_STEPS, EDIT_IMG_STEPS, EDIT_BUSY_STEPS = 20, 5, 2
EDIT_SCALE, EDIT_DELTA = (1.0, 0.6, 0.6), (0.2, 0.0, 0.0)
EDIT_CUTS = "cut from 1000; the whole-frame transfer 5 of 1000"
# phase 16, pose refinement and the joint fit
POSE_FRAMES, POSE_ITERS, POSE_LR, POSE_TWIST = 4, 30, 3e-3, 0.01   # lr: refine_camera_poses's default
POSE_FIT_STEPS, POSE_WARMUP = 30, 10
# phase 17, two atlases cut from the flagship arrays: (name, alive, slots)
ATLAS_SPLIT = (("gs_base", 60_000, 65_536), ("gs_fg", 40_000, 65_536))
ATLAS_STEPS = 10
# phase 18, the perspective engine at the NeRF-synthetic view size
ENGINE_WH, ENGINE_VIEWS, ENGINE_STEPS, ENGINE_SH_INTERVAL = 800, 8, 20, 10
ENGINE_GT, ENGINE_ORBIT = 20_000, 2.5      # ground-truth cluster size, camera orbit radius
# phase 19, data-parallel training in a process group of one rank
DP_STEPS, DP_SMALL_TRACKS, DP_CAM_LR = 10, 16, 1e-3
# phase 20, the flagship frame (rgb, depth: C = 4) as depth slabs
SHARD_SLABS, SHARD_T = 4, 0.0
SHARD_WALL, SHARD_TYPICAL = 1.2e-2, 2e-3   # tests/test_parallel.py:85 and :46
# phase 21, the preprocessing networks at their default configurations, random weights
NETS_SEED, NET_REPS = 0, 3
TAPIR_FRAMES, TAPIR_CHUNK, TAPIR_CHUNKS, TAPIR_CHECK_FRAMES = 48, 128, 4, 8
DA_CHECK_HW, LPIPS_CHECK_HW = (182, 322), (120, 214)   # the card against the CPU (DA: 13 x 23 patches)
DA_TOL, TAPIR_ATOL, TAPIR_RTOL, LPIPS_RTOL = 1e-3, 5e-3, 1e-3, 2e-4
# phase 22, the loss library on the flagship frame and scene, the card against the CPU
HELPERS_T, HELPERS_K, HELPERS_RTOL = 0.0, 10, 1e-4
HELPERS_PATCH, HELPERS_PATCHES, HELPERS_SAMPLES, HELPERS_KNN, HELPERS_BINS = 32, 128, 512, 10, 8
HELPERS_DEPTH_RANGE = (0.8, 1.5)
# C.7, the lbs scene's draws: the card against the CPU at this size (the CPU's kNN of the flagship's
# 100,000 points would take minutes)
LBS_POINTS, LBS_CAPACITY = 8192, 16384
# phase 23, the blend's wide instances: the training shape with a 32-wide DINO attribute (C = 52, R = 60),
# its render (C = 49), and K1 / K3 / K4 at more widths and tiles (16x16 unless given)
WIDE_DINO, WIDE_STEPS = 32, 10
WIDE_TRAIN_C = 20 + WIDE_DINO    # rgb 3, depth 1, track_gs 3, mask 1, pos_poly_feat 12, DINO
WIDE_ATTR_WEIGHT = 20.0          # mask and DINO supervision: the reference's weight (train/trainer.py)
WIDE_CS = (33, 52, 64, 200)      # K1, K3 and K4 on 16x16 tiles
# K3 above 512 pixels and not of whole warps; K1 and K3 above the 1024 threads of a block (64x32, 48x48),
# also through `splat_scene` forward and backward
WIDE_TILES = ((7, (32, 32)), (52, (32, 32)), (7, (12, 12)), (7, (64, 32)), (52, (48, 48)))
# phase 24, the tutorials at their defaults (examples/torch_gs_2d.py, examples/torch_gs_3d.py)
TUT_SIZE, TUT_POINTS, TUT_LR, TUT_LOG_EVERY = 256, 10_000, 0.01, 200
TUT_ITERS = 500         # cut from the tutorial's 2,000 to hold the phase's time (the fit is host-bound)
TUT_MAX_INTERSECTIONS = 1 << 18
TUT_LOSS_ITERS, TUT_LOSS_RTOL = 5, 1e-4    # the first losses of a card fit against a CPU fit
TUT_REPEAT_ITERS = 50                      # two card fits, torch.equal
ORBIT_POINTS, ORBIT_FRAMES, ORBIT_SIZE = 20_000, 12, 256
ORBIT_CPU_WORKERS, ORBIT_CPU_THREADS = 4, 2   # the CPU references of the 12 views, in parallel
# phase 25, the production harness (scripts/torch_e2e_480p.py, scripts/torch_capability_480p.py) in the
# flagship's environment (the recipe of commit c0f714e), cut in steps only
E2E_ENV = {"E480_TEXTURE": "1", "E480_GROWTH_FRAC": "0.05", "E480_LR_STEPS": "8000", "E480_STEPS": "800"}
E2E_CUTS = ("800 of 20,000 steps: the production schedule's first density events fire at their production steps "
            "(600, 700, 800); the opacity reset (3001), the saturation latch and the lr horizon (8000) lie beyond")
E2E_EVENTS = 3          # density events in 800 steps of the production schedule (start 500, interval 100)
CAP_SIZES = None        # the capability harness at its full sizes and step counts (torch_capability_480p.FULL)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def flagship_scene_arrays(seed: int, dino: int = 3):
    """Random flagship scene (positions as bench.py's render bench) with a
    cubic-spline trajectory fitted to a smooth synthetic track and a
    `dino`-wide DINO attribute."""
    from splatter_a_video_tpu_torch.models.trajectory import fit_cubic_spline

    rng = np.random.RandomState(seed)
    n, cap = ALIVE, CAPACITY
    base = np.concatenate(
        [rng.uniform(-1.0, 1.0, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], axis=1
    ).astype(np.float32)
    t = np.arange(FRAMES, dtype=np.float32)[:, None, None] / (FRAMES - 1)
    amp = rng.uniform(0.0, 0.02, (1, n, 3)).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, (1, n, 3)).astype(np.float32)
    track = base[None] + amp * (np.sin(2 * np.pi * t + phase) - np.sin(phase))
    coeff, knots = fit_cubic_spline(track)

    def full(shape, live, dead=0.0):
        a = np.full((cap,) + shape, dead, np.float32)
        a[:n] = live
        return a

    params = {
        "position": full((3,), base),
        "features_dc": full((1, 3), rng.randn(n, 1, 3) * 0.3),
        "features_rest": full((15, 3), rng.randn(n, 15, 3) * 0.3),
        "scaling": full((3,), rng.uniform(-5.5, -4.0, (n, 3)), np.log(1e-3)),
        "rotation": full((4,), rng.randn(n, 4)),
        "opacity": full((1,), np.log(1.0 / (1.0 / rng.uniform(0.3, 0.95, (n, 1)) - 1.0)),
                        np.log(0.01 / 0.99)),
        "pos_poly_feat": full((4, 3), rng.randn(n, 4, 3) * 0.01),
        "pos_fourier_feat": full((8, 3), rng.randn(n, 8, 3) * 0.01),
        "rot_poly_feat": full((4, 4), rng.randn(n, 4, 4) * 0.05),
        "rot_fourier_feat": full((8, 4), rng.randn(n, 8, 4) * 0.05),
        "mask_attribute": full((1,), rng.randn(n, 1)),
        "dino_attribute": full((dino,), rng.randn(n, dino)),
        "pos_cubic_coeff": full(coeff.shape[1:], coeff),
    }
    params["position"][n:] = (0.0, 0.0, -10.0)   # dead slots parked behind the camera
    params["rotation"][n:] = (1.0, 0.0, 0.0, 0.0)
    aux = {"alive": np.arange(cap) < n, "spline_knots": knots}
    cfg = dict(
        capacity=cap, num_frames=FRAMES, traj="cubic_spline",
        render_attributes=(("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", dino)),
    )
    return params, aux, cfg


def small_scene_arrays(seed: int, n: int = 120):
    """A 64x48-sized static scene for the CPU-vs-GPU check of the main path."""
    rng = np.random.RandomState(seed)
    params = {
        "position": np.concatenate(
            [rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], axis=1),
        "features_dc": rng.randn(n, 1, 3) * 0.3,
        "features_rest": rng.randn(n, 15, 3) * 0.3,
        "scaling": rng.uniform(-3.5, -2.0, (n, 3)),
        "rotation": rng.randn(n, 4),
        "opacity": rng.uniform(-2.0, 2.0, (n, 1)),
        "mask_attribute": rng.randn(n, 1),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    cfg = dict(capacity=n, num_frames=1, traj="static", render_attributes=(("mask_attribute", 1),))
    return params, {"alive": np.ones(n, bool)}, cfg


def train_batch_arrays(seed: int):
    """A seeded smooth target frame, depth in [0.5, 2] and TRACKS tracks
    whose TAPIR logits read as visible and confident."""
    rng = np.random.RandomState(seed + 2)
    xx = np.linspace(0.0, 1.0, W, dtype=np.float32)[None, :]
    yy = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None]
    rgb = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx + 0.3 * yy) + ph) for ph in (0.0, 2.0, 4.0)], -1)
    depth = 0.5 + 1.5 * (0.5 + 0.5 * np.cos(np.pi * xx) * np.cos(0.5 * np.pi * yy))
    qp = np.stack([rng.uniform(0, W - 1, TRACKS), rng.uniform(0, H - 1, TRACKS)], 1)
    tracks = np.concatenate([qp + rng.randn(TRACKS, 2) * 2.0, rng.uniform(-6.0, -2.0, (TRACKS, 2))], 1)
    return dict(rgb1=rgb.astype(np.float32), depth1=depth.astype(np.float32),
                query_px=qp.astype(np.float32), target_tracks=tracks.astype(np.float32),
                track_valid=np.ones(TRACKS, bool))


def small_train_scene(seed: int, n: int = 120, dino: int = 0):
    """A 64x48-sized poly_fourier scene from `create_scene` on the CPU, with
    random shapes, opacities below 0.9 and motion, for the gradient check;
    with `dino`, also random mask and `dino`-wide DINO render attributes."""
    import torch

    from splatter_a_video_tpu_torch.models import gaussians

    rng = np.random.RandomState(seed + 3)
    pos = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1)
    attrs = (("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", dino)) if dino else ()
    cfg = gaussians.SceneConfig(capacity=n + 16, num_frames=8, traj="poly_fourier", render_attributes=attrs)
    scene = gaussians.create_scene(cfg, pos.astype(np.float32), rng.uniform(0, 1, (n, 3)),
                                   init_opacity=0.3, device="cpu")
    p = dict(scene.params)
    rand = lambda *shape, s=1.0: torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
    p["scaling"] = p["scaling"].clone()
    p["scaling"][:n] = torch.from_numpy(rng.uniform(-3.5, -2.0, (n, 3)).astype(np.float32))
    p["rotation"] = torch.cat([rand(n, 4), p["rotation"][n:]])
    p["opacity"] = torch.cat([rand(n, 1, s=0.8), p["opacity"][n:]])
    p["features_rest"] = rand(*p["features_rest"].shape, s=0.1)
    p["pos_poly_feat"] = rand(*p["pos_poly_feat"].shape, s=0.01)
    p["rot_fourier_feat"] = rand(*p["rot_fourier_feat"].shape, s=0.05)
    for name, _ in attrs:
        if name != "pos_poly_feat":
            p[name] = rand(*p[name].shape)
    return gaussians.GaussianScene(params=p, aux=scene.aux, cfg=cfg)


def render_grads(scene, dev, seed: int, extra_names=()):
    """The 64x48 training render (rgb, depth, track_gs and the render
    attributes `extra_names`) and the gradients of a fixed random linear
    loss on it with respect to every parameter and both sinks."""
    import torch

    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.models.gaussians import GaussianScene
    from splatter_a_video_tpu_torch.train import losses, optim, trainer

    tcfg = trainer.TrainerConfig(width=64, height=48, num_frames=8, max_intersections=1 << 14)
    extr = torch.as_tensor(camera.canonical_camera(64, 48).extrinsic, dtype=torch.float32, device=dev)
    params = {k: v.detach().to(dev).requires_grad_(True) for k, v in scene.params.items()}
    sc = GaussianScene(params=params, aux={k: v.to(dev) for k, v in scene.aux.items()}, cfg=scene.cfg)
    n = scene.alive.shape[0]
    uv_sink = torch.zeros((n, 2), device=dev, requires_grad=True)
    abs_sink = torch.zeros((n, 2), device=dev, requires_grad=True)
    inp = trainer.scene_render_inputs(sc, 2)
    out = trainer._render_with_sinks(inp, extr, tcfg.raster_cfg(),
                                     {"track_gs": sc.get_position(5), **{k: inp[k] for k in extra_names}}, True,
                                     uv_sink, abs_sink)
    rng = np.random.RandomState(seed + 4)
    loss = sum((v * torch.from_numpy(rng.randn(*v.shape).astype(np.float32)).to(dev)).sum()
               for v in out.features.values())
    names = list(params) + ["uv_sink", "abs_sink"]
    grads = torch.autograd.grad(loss, list(params.values()) + [uv_sink, abs_sink], allow_unused=True)
    return ({k: (torch.zeros(1) if g is None else g.detach().cpu()) for k, g in zip(names, grads)},
            {k: v.detach().cpu() for k, v in out.features.items()})


def sleep_cycles_per_ms() -> float:
    """Clock cycles per ms of `torch.cuda._sleep`, measured with CUDA events."""
    import torch

    cycles = 1 << 24
    torch.cuda._sleep(cycles)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / a.elapsed_time(b)


def cuda_ms(fn, cycles_per_ms: float, reps: int = REPS) -> float:
    """Median device time of fn() in ms over `reps` runs.

    The runs are queued behind a device-side sleep (at most 0.2 s) that
    outlasts their enqueueing, with a CUDA event between each two: the
    device runs them back to back and the host's launch time does not show.
    A fn that waits for the device (each plain version reads a count back)
    is timed with its host time all the same."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 * reps   # an upper bound
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(min(1.5 * enqueue_ms, 200.0) * cycles_per_ms) + 1)
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def wall_ms(fn, reps: int = REPS) -> float:
    """Median host time of fn() + synchronize in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


PORT_KERNELS = ("blend_forward_kernel", "expand_intersections_kernel", "blend_backward_kernel",
                "invert_order_kernel", "reduce_gaussians_kernel")


def device_profile(fn, reps: int):
    """(device busy ms per call, [(kernel, ms per call)] top 8, the same for
    every kernel of the port's CUDA sources) from torch.profiler, or
    (None, [], []) when it records no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    if not per_name:
        return None, [], []
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    ours = sorted((name[name.index(k):].split("(")[0], ms) for name, ms in per_name.items()
                  for k in PORT_KERNELS if k in name)
    return sum(per_name.values()), top, ours


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def widen(feats, bg, seed: int):
    """Features and bg padded to WIDE_C channels with seeded random columns."""
    import torch

    extra = WIDE_C - feats.shape[1]
    gen = torch.Generator(device=feats.device).manual_seed(seed)
    cols = torch.rand((feats.shape[0], extra), generator=gen, device=feats.device)
    return (torch.cat([feats, cols], 1).contiguous(),
            torch.cat([bg, torch.linspace(0.0, 1.0, extra, device=bg.device)]))


def resources(a: dict) -> str:
    return f"{a['regs']} regs, {a['local_bytes']} B local, {a['shared_bytes']} B shared"


def fit_configs(args, steps: int, **fit_kw):
    """(FitConfig, TrainerConfig) of the full-width fit, `steps` long:
    scripts/e2e_480p.py:54-120 with the textured clip, flow weight 2, near
    plane 0.2, and the cuts of FIT_CUTS."""
    from splatter_a_video_tpu_torch.train import density, fit, optim, trainer

    fcfg = fit.FitConfig(**{**dict(num_iters=steps, num_fg_samples=60_000, num_bg_samples=40_000,
                                   num_track_samples=TRACKS, log_every=max(steps // 40, 1), capacity_factor=1.31,
                                   init_num_points=ALIVE, seed=args.seed), **fit_kw})
    tcfg = trainer.TrainerConfig(
        width=W, height=H, num_frames=FRAMES, nearest=0.2, loss_flow_weight=2.0, num_track_samples=TRACKS,
        max_intersections=MAX_INTERSECTIONS, optim=optim.OptimConfig(max_steps=steps),
        densify=density.DensifyConfig(densify_stop_iter=100_000, densify_grad_threshold=0.0002,
                                      size_prune_always=True, **FIT_DENSITY))
    return fcfg, tcfg


def state_digest(snap: dict) -> str:
    """A 64-bit digest of a state snapshot: each tensor's bit patterns
    summed with position weights in wrapping int64 on the card, the sums
    chained in name order."""
    import torch

    h = 0
    for name in sorted(snap):
        b = snap[name].contiguous().view(-1)
        b = b.view(torch.int32).long() if b.dtype in (torch.float32, torch.int32) else b.long()
        w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64) * 2654435761 % 2147483647
        h = (h * 1000003 + int((b * w).sum())) % (1 << 64)
    return f"{h:016x}"


def snapshot(state) -> dict:
    """Clones of a train state's parameters, Adam moments, aux tensors,
    density statistics and key."""
    snap = {}
    for k, v in state.scene.params.items():
        snap[f"param {k}"] = v.detach().clone()
        snap[f"mu {k}"] = state.opt_state.mu[k].clone()
        snap[f"nu {k}"] = state.opt_state.nu[k].clone()
    snap.update({f"aux {k}": v.clone() for k, v in state.scene.aux.items()})
    snap.update({f"densify {i}": v.clone() for i, v in enumerate(state.densify_state)})
    snap["key"] = state.key.clone()
    return snap


def fit_watch(events):
    """A hook that keeps the alive count at the start and after each
    density event, and a snapshot of the state after each event and at
    the end (its cadence puts an after_train_iter site on every event)."""
    from splatter_a_video_tpu_torch.train import hooks

    class Watch(hooks.Hook):
        every = FIT_DENSITY["duplicate_interval"]

        def before_train(self, ctx):
            self.alive, self.capacity = int(ctx.state.scene.num_alive), ctx.state.scene.cfg.capacity
            self.at, self.snaps = {}, {}

        def after_train_iter(self, ctx):
            self.at[ctx.step] = ctx.metrics["alive"]
            if ctx.step in events:
                self.snaps[ctx.step] = snapshot(ctx.state)

        def after_train(self, ctx):
            self.at["end"] = int(ctx.state.scene.num_alive)
            self.snaps["end"] = snapshot(ctx.state)

    return Watch()


def fit_phase(args, dev, card: str):
    """Phase 12: `fit.fit_clip` at full width for FIT_STEPS steps; returns
    the launch counts of the fit, its clip (phase 16 fits it again) and
    its watch hook (the repeat check holds a second fit to it)."""
    import pathlib
    import tempfile

    import torch

    from splatter_a_video_tpu_torch.data import pairs, synthetic
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg
    from splatter_a_video_tpu_torch.train import fit, trainer
    from splatter_a_video_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    clip = synthetic.make_clip(synthetic.SyntheticClipConfig(seed=args.seed, **FIT_CLIP))
    clip_s = time.perf_counter() - t0
    fcfg, tcfg = fit_configs(args, FIT_STEPS)
    events = [s for s in range(1, FIT_STEPS + 1) if trainer.should_densify(tcfg, s)]
    capacity = int(np.ceil(ALIVE * fcfg.capacity_factor / 128) * 128)

    watch = fit_watch(events)
    for k in rg.LAUNCHES:
        rg.LAUNCHES[k] = 0
    state, hist = fit.fit_clip(clip, fcfg, tcfg, hooks=[watch], device=DEVICE)
    fit_launches = dict(rg.LAUNCHES)
    log("fit", f"{W}x{H}, {FRAMES} frames, textured clip of {FIT_CLIP['num_blobs']} blobs of radius "
               f"{FIT_CLIP['blob_radius']}; cuts: {FIT_CUTS}; {FIT_STEPS} steps, launches {fit_launches}")
    require(watch.alive == ALIVE and watch.capacity == capacity,
            f"init alive {watch.alive} of {watch.capacity}, expected {ALIVE} of {capacity}")
    require(fit_launches == {k: FIT_STEPS for k in fit_launches}, f"fit launch counts {fit_launches}")
    for m in hist:
        vals = [v for k, v in m.items() if isinstance(v, (int, float))]
        require(all(np.isfinite(v) for v in vals), f"step {m['step']}: metrics not finite {m}")
        require(m["num_intersections"] <= MAX_INTERSECTIONS, f"step {m['step']} saturated: {m['num_intersections']}")
    first, last = hist[0], hist[-1]
    require(last["loss_rgb"] < first["loss_rgb"], f"fit loss_rgb did not fall: {first['loss_rgb']} -> {last['loss_rgb']}")
    done = last.get("densify_events", [])
    require(len(events) == 2 and [e["step"] for e in done] == events,
            f"density events at {[e['step'] for e in done]}, expected two at {events}")
    for e in done:
        require(watch.at.get(e["step"]) == e["num_alive"],
                f"density at {e['step']}: alive {watch.at.get(e['step'])} != num_alive {e['num_alive']}")
    require(state.step == FIT_STEPS and state.opt_state.count == FIT_STEPS, "fit step counts")
    timing = last["timing"]
    log("fit", f"init alive {watch.alive} of {watch.capacity}; steps {first['step']} -> {last['step']}: loss "
               f"{first['loss']:.5f} -> {last['loss']:.5f}, loss_rgb {first['loss_rgb']:.5f} -> "
               f"{last['loss_rgb']:.5f}, psnr {first['psnr']:.3f} -> {last['psnr']:.3f}; {len(hist)} logged steps "
               f"finite and unsaturated (max {max(int(m['num_intersections']) for m in hist)} intersections); "
               "density events: " + "; ".join(
                   f"step {e['step']}: cloned {e['num_cloned']}, split {e['num_split']}, pruned {e['num_pruned']}, "
                   f"dropped {e['dropped']}, alive {watch.at[e['step']]} == num_alive" for e in done)
               + f"; final alive {last['alive']}")
    log("fit", f"setup {timing['setup_s']} s = clip generation {clip_s:.2f} s (before fit_clip) + lifting "
               f"{timing['lift_s']} s + create_scene {timing['create_scene_s']} s + frame upload and step set-up "
               f"{timing['setup_s'] - timing['lift_s'] - timing['create_scene_s']:.2f} s; first step "
               f"{timing['first_step_s']} s; steady {timing['steady_ms']} ms/step (wall, hooks and logging "
               f"included); total {timing['total_s']} s {card}")

    # three steps of the fitted state, alone: device busy share
    frames = trainer.FrameStore(
        rgb=torch.from_numpy(np.stack(clip.frames)).to(dev),
        depth=torch.from_numpy(np.stack([clip.get_loss_depth(t) for t in range(FRAMES)])).to(dev))
    train_step = trainer.make_train_step(tcfg, camera.canonical_camera(W, H).extrinsic, frames=frames,
                                         device=DEVICE)[0]
    batch = pairs.batch_to_device(pairs.BatchBuilder(clip, TRACKS, seed=args.seed, slim=True).build(TRAIN_T1, TRAIN_T2),
                                  dev)
    step_wall = wall_ms(lambda: train_step(state, batch), reps=3)
    busy, top, ours = device_profile(lambda: train_step(state, batch), reps=3)
    if busy is None:
        log("fit", f"profiler recorded no device kernels; fit busy share not measured {card}")
    else:
        log("fit", f"fitted state, 3 steps alone: {step_wall:.3f} ms/step wall, device busy {busy:.3f} ms/step = "
                   f"{busy / step_wall:.1%} of that wall and {busy / timing['steady_ms']:.1%} of the fit's steady "
                   "ms/step; by kernel ms/step: " + "; ".join(f"{n[:60]} {ms:.4f}" for n, ms in top)
                   + "; the port's kernels: " + "; ".join(f"{n} {ms:.4f}" for n, ms in ours) + f" {card}")

    # the host's cost of a step's random draws: the key split and the ARAP
    # sample (JAX's threefry in numpy, the cumulative sum on the card)
    from splatter_a_video_tpu_torch.train import losses, prng

    def draws():
        key, sub = prng.split(state.key)
        return losses.arap_sample(capacity, tcfg.arap_sample_num, state.scene.alive, sub, dev)

    draws()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        draws()
    draws_ms = (time.perf_counter() - t0) / REPS * 1e3
    torch.cuda.synchronize()
    log("fit", f"random draws of a step (key split, {tcfg.arap_sample_num} ARAP samples of {capacity} slots): "
               f"{draws_ms:.3f} ms of host time per step, mean of {REPS}, = {draws_ms / timing['steady_ms']:.1%} of "
               f"the fit's steady ms/step {card}")

    # checkpoint round trip at full width
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(tmp, state, state.step)
        save_s = time.perf_counter() - t0
        back, step = checkpoint.restore_checkpoint(tmp, state)
        load_s = time.perf_counter() - t0 - save_s
        size = sum(f.stat().st_size for f in pathlib.Path(tmp).rglob("*") if f.is_file())
    same = (all(torch.equal(back.scene.params[k], v) and torch.equal(back.opt_state.mu[k], state.opt_state.mu[k])
                and torch.equal(back.opt_state.nu[k], state.opt_state.nu[k]) for k, v in state.scene.params.items())
            and all(torch.equal(back.scene.aux[k], v) for k, v in state.scene.aux.items())
            and all(torch.equal(a, b) for a, b in zip(back.densify_state, state.densify_state))
            and torch.equal(back.key, state.key))
    require(same and step == FIT_STEPS and back.step == FIT_STEPS and back.opt_state.count == FIT_STEPS,
            "full-width checkpoint round trip differs")
    log("fit", f"checkpoint at step {step}: {size / 2**20:.1f} MiB, saved in {save_s:.2f} s, restored in "
               f"{load_s:.2f} s; every tensor torch.equal, step and Adam count {back.opt_state.count}")
    return fit_launches, clip, watch


def repeat_phase(args, card: str, clip, first) -> None:
    """Phase 12's fit a second time in this process, on the same clip
    object with the same seed and configs, held `torch.equal` to the first
    fit (`first`, its watch hook) after each density event and at the end:
    every parameter, Adam moment, aux tensor, density statistic and the
    key. Fails where the two fits part."""
    import torch

    from splatter_a_video_tpu_torch.train import fit

    fcfg, tcfg = fit_configs(args, FIT_STEPS)
    events = sorted(k for k in first.snaps if k != "end")
    watch = fit_watch(events)
    t0 = time.perf_counter()
    fit.fit_clip(clip, fcfg, tcfg, hooks=[watch], device=DEVICE)
    secs = time.perf_counter() - t0
    parted, sites = None, []
    for site in events + ["end"]:
        a, b = first.snaps[site], watch.snaps[site]
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ and parted is None:
            parted = f"at {'the end' if site == 'end' else f'step {site}'} in {', '.join(differ[:8])}"
        sites.append(f"{'end' if site == 'end' else f'step {site}'}: alive {first.at[site]} / {watch.at[site]}, "
                     f"digest {state_digest(a)} / {state_digest(b)}")
    log("repeat", f"phase 12's fit again ({FIT_STEPS} steps, seed {args.seed}, the same clip object) in {secs:.1f} s; "
                  "first / second fit: " + "; ".join(sites)
                  + f"; every tensor torch.equal at every event and at the end: {parted is None}; "
                  + f"the fits part: {parted or 'nowhere'} {card}")
    require(parted is None, f"the full-width fit does not repeat: it parts {parted}")


def mini_fit_phase(card: str) -> None:
    """Phase 13: `tests/test_quality_gate.py`'s mini-fit through the port
    on the card (`eval.quality_gate`), twice.

    The pinned configuration: a PSNR or alive miss fails the run; AJ and OA
    are printed beside their bands, and a miss is printed, not failed. At
    500 steps they follow the random draws (ARAP samples, split noise) and
    the rounding: the JAX package's own fit misses them with 3 of its 4
    PRNG keys (`tests/test_torch_quality_gate.py`, `PERF.md` §5). The
    tracking of the card's fitted scene is also evaluated on the CPU and
    must agree with the card's.

    The same fit without random draws (ARAP off, zero split noise): every
    value must lie within `quality_gate.NO_DRAWS_TOL` of the JAX package's
    fit (`NO_DRAWS_JAX`) and inside all four pinned bands; a miss fails."""
    from splatter_a_video_tpu_torch.data import synthetic
    from splatter_a_video_tpu_torch.eval import quality_gate as qg
    from splatter_a_video_tpu_torch.eval import tapvid
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize

    clip = synthetic.make_clip(qg.configs()[0])
    fmt = lambda b: "; ".join(
        f"{k} {v:.4f} (band > {lo:.4f}" + ("" if hi is None else f" and < {hi:.4f}, != 3000")
        + f": {'inside' if inside else 'OUTSIDE'})" for k, (v, lo, hi, inside) in b.items())
    head = f"{qg.W}x{qg.H}, {qg.T} frames, textured, {qg.STEPS} steps"

    r = qg.run(DEVICE, clip=clip)
    b = qg.bands(r["values"])
    cam = camera.canonical_camera(qg.W, qg.H)
    rcfg = rasterize.RasterizeConfig(width=qg.W, height=qg.H, max_intersections=qg.MAX_INTERSECTIONS)
    on_cpu = tapvid.evaluate_scene_tracking(r["scene"].to("cpu"), clip, cam, rcfg, num_queries=128, device="cpu")
    log("fit", f"mini-fit ({head}, {r['fit_s']:.1f} s, steady {r['last']['timing']['steady_ms']} ms/step): "
               f"{fmt(b)}; delta_avg {r['delta_avg']:.4f}; densify {r['last'].get('densify_totals')}; the same "
               f"scene tracked on the CPU: aj {on_cpu['average_jaccard']:.4f}, oa "
               f"{on_cpu['occlusion_accuracy']:.4f} {card}")
    for k in ("psnr", "alive"):
        require(b[k][3], f"mini-fit {k} {b[k][0]} outside its band")
    require(abs(on_cpu["average_jaccard"] - r["values"]["aj"]) < qg.NO_DRAWS_TOL["aj"]
            and abs(on_cpu["occlusion_accuracy"] - r["values"]["oa"]) < qg.NO_DRAWS_TOL["oa"],
            "the card's fitted scene tracks otherwise on the CPU")
    missed = [k for k in ("aj", "oa") if not b[k][3]]
    if missed:
        log("fit", f"mini-fit {' and '.join(missed)} outside the pinned band: printed, not failed (the fit "
                   "without random draws below is held to the JAX package's and to all four bands)")

    r = qg.run(DEVICE, draws=False, clip=clip)
    b, near = qg.bands(r["values"]), qg.near_jax_without_draws(r["values"])
    log("fit", f"mini-fit without random draws ({head}, ARAP off, zero split noise, {r['fit_s']:.1f} s): "
               + "; ".join(f"{k} {v:.4f} (JAX {ref:.4f} +- {tol:.4f}: {'inside' if ok else 'OUTSIDE'})"
                           for k, (v, ref, tol, ok) in near.items())
               + f"; pinned bands: {fmt(b)} {card}")
    for k in near:
        require(near[k][3], f"mini-fit without random draws: {k} {near[k][0]} not within {near[k][2]} of JAX's "
                            f"{near[k][1]}")
        require(b[k][3], f"mini-fit without random draws: {k} {b[k][0]} outside its band")


def cli_phase(card: str) -> None:
    """Phase 14: the training CLI on the card: train, checkpoint, resume,
    reload and render."""
    import contextlib
    import io
    import pathlib
    import tempfile

    import torch

    from splatter_a_video_tpu_torch import inference
    from splatter_a_video_tpu_torch.apps import train as train_app
    from splatter_a_video_tpu_torch.apps.train_state_io import load_scene_from_ckpt
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--synthetic", "--i_weight", "10", "--i_print", "10", "--tensorboard", "0", "--out_dir", tmp]
        common += [] if DEVICE == "cuda" else ["--device", DEVICE]   # the CLI's default device is cuda
        t0 = time.perf_counter()
        state = train_app.main(common + ["--num_iters", "20"])
        first_s = time.perf_counter() - t0
        files = sorted(p.name for p in pathlib.Path(tmp).iterdir())
        for f in ("args.json", "ckpt_000010", "ckpt_000020", "scene_cfg.json", "history.json"):
            require(f in files, f"CLI did not write {f}: {files}")
        require(state.step == 20 and state.scene.device.type == DEVICE, "CLI run")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = train_app.main(common + ["--num_iters", "30", "--resume"])
        require(f"resumed from {tmp} at step 20" in out.getvalue(), "CLI --resume did not resume at step 20")
        hist = json.loads((pathlib.Path(tmp) / "history.json").read_text())
        require(hist[-1]["step"] == 30 and state.step == 30, f"resumed run ended at {hist[-1]['step']}")
        scene = load_scene_from_ckpt(tmp, device=DEVICE)
        cam = camera.canonical_camera(64, 48)   # the CLI's synthetic clip
        frame = inference.render_frame(scene, 3.0, cam.extrinsic,
                                       rasterize.RasterizeConfig(width=64, height=48, max_intersections=1 << 19),
                                       device=DEVICE)
        rgb = frame.features["rgb"]
        require(rgb.device.type == DEVICE and bool(torch.isfinite(rgb).all()), "reloaded scene does not render")
    log("cli", f"apps.train --synthetic: 20 steps in {first_s:.1f} s wrote {', '.join(files)}; --resume --num_iters "
               f"30 resumed at step 20 and ended at step {hist[-1]['step']} (loss {hist[-1]['loss']:.4f}); "
               f"load_scene_from_ckpt ({scene.cfg.num_frames} frames, capacity {scene.cfg.capacity}) renders on the "
               f"card {card}")

    # the native track loader, built here with this machine's g++
    from splatter_a_video_tpu_torch.data import native_loader, pairs
    from splatter_a_video_tpu_torch.data.video_flow import VideoFlowData

    t0 = time.perf_counter()
    require(native_loader.available(), "the native track loader did not build")
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(0)
        names, n = [f"{i:05d}" for i in range(4)], 37
        for q in names:
            for t in names:
                np.save(pathlib.Path(tmp) / f"{q}_{t}.npy", (rng.rand(n, 4) * 50).astype(np.float32))
        clip = VideoFlowData(frames=[np.zeros((8, 8, 3), np.float32)] * 4, depths_raw=[np.ones((8, 8), np.float32)] * 4,
                             masks_raw=[np.zeros((8, 8), bool)] * 4, tracks=None, frame_names=names,
                             tracks_dir=tmp).setup()
        builder = pairs.BatchBuilder(clip, 16, slim=True)
        require(builder._native is not None, "BatchBuilder did not engage the native loader on an on-disk clip")
        b = builder.build(1, 3)
        rows = np.load(pathlib.Path(tmp) / f"{names[1]}_{names[3]}.npy")
        require(bool(b.track_valid.all()) and all((np.abs(rows - r) < 1e-6).all(1).any() for r in b.target_tracks),
                "native batch rows are not rows of the track file")
    log("cli", f"native track loader built in {build_s:.2f} s ({native_loader.library_path().name}); BatchBuilder "
               "engages it on a track directory written with np.save; 16 rows of 37, each a row of its file")


def pixel_tests(edges, W: int, H: int, tile) -> int:
    """Slot-pixel tests the blend of this binning needs: each slot of a tile
    against each of the tile's pixels inside the W x H frame (edge tiles
    hold fewer)."""
    import torch

    tw, th = tile
    tgx, tgy = -(-W // tw), -(-H // th)
    wx = torch.clamp(W - torch.arange(tgx, device=edges.device) * tw, max=tw)
    hy = torch.clamp(H - torch.arange(tgy, device=edges.device) * th, max=th)
    slots = (edges[1:tgx * tgy + 1] - edges[:tgx * tgy]).long()
    return int((slots * (hy[:, None] * wx[None, :]).reshape(-1)).sum())


def blend_cost(kernel: str, nint: int, edges, W: int, H: int, tile, N: int, C: int, applied: int, K: int = 0):
    """(bound ms, "bytes" or "operations", bytes, flops) of K1 or K3 on
    these inputs: each input read once and each output written once, and
    the work these inputs need (every pixel of a tile tests every slot of
    the tile, `pixel_tests`; the applied pairs blend C channels, or
    back-propagate them)."""
    R = 8 + C
    pixels, n_edges, tests = W * H, edges.shape[0], pixel_tests(edges, W, H, tile)
    if kernel == "blend_forward":
        nbytes = 4 * nint + 4 * n_edges + N * (8 + 12 + 4 + 4 * C) + 4 * C + pixels * (C + 2 + K) * 4
        ops = tests * 15 + applied * 2 * C
    else:
        nbytes = (4 * nint + 4 * n_edges + N * (8 + 12 + 4 + 4 * C) + 8 * C + pixels * (2 * C + 1) * 4
                  + nint * R * 4)
        ops = tests * 15 + applied * (40 + 5 * C + R)
    by = "operations" if ops / FP32_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S else "bytes"
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3, by, nbytes, ops


def blend_instance(tag: str, pr, rc, cpm: float, seed: int, card: str, K: int = 0, backward: bool = True,
                   plain_reps: int = PLAIN_REPS, splat: bool = False):
    """K1 (and K3, then K4 on K3's rows) at the blend of the projection `pr`
    under `rc`: each `torch.equal` to its plain version, timed, with its
    bound; K4 also beside `index_add_`. With `plain_reps` 0 a plain
    version's time is the wall of its one call (the plain versions read
    counts back, so they wait for the card as they run). With `splat`, also
    `rasterize_gpu.splat_scene` forward and backward (binning, K1, then K3
    and K4 through its autograd Function) on the same inputs, its image
    and gradients `torch.equal` to the kernels' outputs above. Returns
    {kernel: [instance row]} for the kernel table."""
    import torch

    from splatter_a_video_tpu_torch.ops import binning
    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg

    def plain(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def plain_ms(fn, once_ms):
        return cuda_ms(fn, cpm, plain_reps) if plain_reps else once_ms

    dev = pr.uv.device
    Wd, Hd, tile = rc.width, rc.height, rc.block
    feats, bg, mask = blend_arrays(pr)
    C, N = feats.shape[1], feats.shape[0]
    b = binning.bin_intersections(pr.depth, pr.tiles, pr.rect_min, pr.rect_max, Wd, Hd, rc.max_intersections,
                                  rc.max_tiles_per_gaussian, rc.block)
    nint = int(b.num_intersections)
    used = min(nint, rc.max_intersections)
    name = (f"{tag} C={C}" + (f" K_idx={K}" if K else "")
            + ("" if tuple(tile) == (16, 16) else f" {tile[0]}x{tile[1]}"))
    k1a = (b.gid, b.edges, pr.uv, pr.conic, pr.opacity, feats, bg, Wd, Hd, tile, K)
    out = rg.blend_forward(*k1a)
    ref, plain1 = plain(lambda: rg.blend_forward_plain(*k1a))
    same = all(torch.equal(a, r) for a, r in zip(out, ref))
    err = max((out[0] - ref[0]).abs().max().item(), (out[1] - ref[1]).abs().max().item())
    require(same and torch.isfinite(out[0]).all().item(), f"K1 {name} differs from plain")
    applied = int(out[2].sum())
    bound, by, nbytes, ops = blend_cost("blend_forward", used, b.edges, Wd, Hd, tile, N, C, applied, K)
    ms, plain_ms1 = cuda_ms(lambda: rg.blend_forward(*k1a), cpm), plain_ms(lambda: rg.blend_forward_plain(*k1a),
                                                                          plain1)
    attrs = rg.kernel_attributes("blend_forward", C, tile)
    rows = {"blend_forward": [dict(instance=name, ms=ms, plain_ms=plain_ms1, bound_ms=bound, bound_by=by,
                                   max_abs_err=err, **attrs)]}
    log("K1", f"{name} {Wd}x{Hd}: torch.equal on all four outputs: {same}; {nint} intersections of "
              f"{rc.max_intersections}; {ms:.4f} ms, plain {plain_ms1:.3f} ms, bound {bound:.4f} ms ({by}: "
              f"{ops:.3g} flops, {nbytes:.3g} B, {applied} applied pairs); {resources(attrs)} {card}")
    if not backward:
        return rows
    g = torch.randn((Hd, Wd, C), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    k3a = (b.gid, b.edges, pr.uv, pr.conic, pr.opacity, feats, bg, mask, out[0], out[1], g, Wd, Hd, tile, None)
    dg, nc = rg.blend_backward(*k3a, return_ncontrib=True)
    dref, plain3 = plain(lambda: rg.blend_backward_plain(*k3a))
    k4a = (dg, b.order, b.offs, b.tiles)
    red = rg.reduce_gaussians(*k4a)
    red_p, plain4 = plain(lambda: rg.reduce_gaussians_plain(*k4a))
    same3 = torch.equal(dg[:used], dref[:used]) and torch.equal(nc, out[2])
    same4 = torch.equal(red, red_p)
    err3 = (dg[:used] - dref[:used]).abs().max().item()
    require(same3 and torch.isfinite(dg[:used]).all().item(), f"K3 {name} differs from plain")
    require(same4, f"K4 after K3 {name} differs from plain")
    if splat:
        leaves = [v.detach().clone().requires_grad_() for v in (pr.uv, pr.conic, pr.opacity, feats)]
        sink = torch.zeros_like(pr.uv, requires_grad=True)
        with torch.enable_grad():
            img = rg.splat_scene(*leaves, pr.depth, pr.tiles, pr.rect_min, pr.rect_max, W=Wd, H=Hd, bg=bg,
                                 alpha_grad_mask=mask, abs_sink=sink, max_intersections=rc.max_intersections,
                                 max_tiles_per_gaussian=rc.max_tiles_per_gaussian, block=tuple(tile))[0]
            (img * g).sum().backward()
        Cw = feats.shape[1]
        want = (red[:, 0:2], red[:, 2:5], red[:, 5], red[:, 6:6 + Cw], red[:, 6 + Cw:8 + Cw])
        require(torch.equal(img, out[0]) and all(torch.equal(x.grad, r) for x, r in zip(leaves + [sink], want)),
                f"splat_scene {name}: image or gradients differ from the kernels'")
        log("K3", f"{name}: splat_scene forward and backward through binning, K1, K3 and K4 torch.equal to the "
                  f"kernels' image and the gradients of uv, conic, opacity, features and the |duv| sink")
        del leaves, sink, img
    del dref
    R = dg.shape[1]
    bound3, by3, nbytes3, ops3 = blend_cost("blend_backward", used, b.edges, Wd, Hd, tile, N, C, applied)
    ms3 = cuda_ms(lambda: rg.blend_backward(*k3a), cpm)
    plain3 = plain_ms(lambda: rg.blend_backward_plain(*k3a), plain3)
    ms4 = cuda_ms(lambda: rg.reduce_gaussians(*k4a), cpm)
    plain4 = plain_ms(lambda: rg.reduce_gaussians_plain(*k4a), plain4)
    owner, used_rows = b.gid[:used].long(), dg[:used]
    lib4 = cuda_ms(lambda: torch.zeros_like(red).index_add_(0, owner, used_rows), cpm)
    bytes4 = used * (R * 4 + 8) + N * (8 + R * 4)
    bound4 = max(bytes4 / HBM_BYTES_PER_S, used * R / FP32_FLOPS_PER_S) * 1e3
    attrs3 = rg.kernel_attributes("blend_backward", C, tile)
    attrs4 = rg.kernel_attributes("reduce_gaussians", R)
    rows["blend_backward"] = [dict(instance=name, ms=ms3, plain_ms=plain3, bound_ms=bound3, bound_by=by3,
                                   max_abs_err=err3, **attrs3)]
    rows["reduce_gaussians"] = [dict(instance=f"{name} R={R}", ms=ms4, plain_ms=plain4, library_ms=lib4,
                                     bound_ms=bound4, bound_by="bytes", max_abs_err=(red - red_p).abs().max().item(),
                                     **attrs4)]
    log("K3", f"{name} {Wd}x{Hd}: {used} slots x {R} rows torch.equal to plain: {same3} (replay "
              f"ncontrib == K1's); K4 on its rows torch.equal to plain: {same4}; K3 {ms3:.4f} ms, plain "
              f"{plain3:.3f} ms, bound {bound3:.4f} ms ({by3}: {ops3:.3g} flops, {nbytes3:.3g} B); K3 "
              f"{resources(attrs3)}; K4 at R = {R} {ms4:.4f} ms, plain {plain4:.3f} ms, index_add_ {lib4:.4f} ms, "
              f"bound {bound4:.4f} ms (bytes: {bytes4:.3g} B), {bound4 / ms4:.1%} of it; {resources(attrs4)} {card}")
    return rows


def k2_instance(tag: str, pr, rc, cpm: float, card: str) -> dict:
    """K2 at the binning of the projection `pr` under `rc`: keys and owners
    `torch.equal` to its plain version, timed, with its bound (each
    Gaussian's tile count read, offs, rect_min, rect_max.x and depth of
    those with tiles, each of the M slots written). Returns
    {"expand_intersections": [instance row]}."""
    import torch

    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg
    from splatter_a_video_tpu_torch.ops.projection import tile_grid

    N, M = pr.tiles.shape[0], rc.max_intersections
    tiles = pr.tiles.clamp_max(rc.max_tiles_per_gaussian).contiguous()
    offs = (torch.cumsum(tiles, 0, dtype=torch.int32) - tiles).contiguous()
    a = (offs, tiles, pr.rect_min.contiguous(), pr.rect_max.contiguous(), pr.depth.contiguous(), M,
         tile_grid(rc.width, rc.height, rc.block)[0])
    keys, gid = rg.expand_intersections(*a)
    keys_p, gid_p = rg.expand_intersections_plain(*a)
    same = torch.equal(keys, keys_p) and torch.equal(gid, gid_p)
    require(same, f"K2 {tag} differs from plain")
    nint, live = int(tiles.sum()), int((tiles > 0).sum())
    nbytes = 4 * N + live * (4 + 8 + 4 + 4) + M * (8 + 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = cuda_ms(lambda: rg.expand_intersections(*a), cpm)
    plain_ms = cuda_ms(lambda: rg.expand_intersections_plain(*a), cpm, PLAIN_REPS)
    attrs = rg.kernel_attributes("expand_intersections")
    log("K2", f"{tag} {rc.width}x{rc.height}: keys and owners torch.equal to plain: {same}; {nint} intersections "
              f"of {M}; {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes: {nbytes:.3g} B, {live} "
              f"Gaussians with tiles); {resources(attrs)} {card}")
    return {"expand_intersections": [dict(instance=tag, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                                          max_abs_err=float((keys - keys_p).abs().max()), **attrs)]}


def merge_rows(*parts):
    out = {}
    for p in parts:
        for k, v in p.items():
            out.setdefault(k, []).extend(v)
    return out


def reset_launches():
    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg

    for k in rg.LAUNCHES:
        rg.LAUNCHES[k] = 0


def read_launches() -> dict:
    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg

    return dict(rg.LAUNCHES)


def busy_line(tag: str, fn, reps: int, per: int, wall: float, card: str) -> str:
    """Device busy ms per unit of `fn` (which runs `per` units) against the
    unit's wall ms, from torch.profiler."""
    busy, top, ours = device_profile(fn, reps)
    if busy is None:
        return f"{tag}: profiler recorded no device kernels; busy share not measured {card}"
    busy /= per
    return (f"{tag}: device busy {busy:.3f} ms = {busy / wall:.1%} of {wall:.3f} ms wall; by kernel ms: "
            + "; ".join(f"{n[:50]} {ms / per:.4f}" for n, ms in top[:5]) + "; the port's kernels: "
            + ("; ".join(f"{n} {ms / per:.4f}" for n, ms in ours) or "none") + f" {card}")


def edit_phase(args, dev, card: str, scene, cpm: float) -> dict:
    """Phase 15: selection under a mask, appearance optimisation toward an
    edited frame, whole-frame transfer, layers and a moved copy of the
    foreground, on the flagship scene; returns the kernel instances."""
    import torch

    from splatter_a_video_tpu_torch import inference
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize

    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS)
    mw, mh = EDIT_MASK
    mask = np.zeros((H, W), np.float32)
    mask[(H - mh) // 2:(H - mh) // 2 + mh, (W - mw) // 2:(W - mw) // 2 + mw] = 1.0
    with torch.no_grad():
        inp, _ = inference._scene_inputs(scene, EDIT_T, ())
        pr = rasterize.project_gaussians(inp["position"], inp["scaling"], inp["rotation"], inp["opacity"],
                                         inp["shs"], torch.as_tensor(cam.extrinsic, device=dev), rcfg)
        rows = merge_rows(blend_instance("selection", pr, rcfg, cpm, args.seed + 9, card, K=EDIT_K, backward=False),
                          blend_instance("appearance", pr, rcfg, cpm, args.seed + 9, card))

    t0 = time.perf_counter()
    sel = inference.select_gaussians_by_mask(scene, mask, cam, rcfg, t=EDIT_T, K_idx=EDIT_K, device=DEVICE)
    sel_ms = (time.perf_counter() - t0) * 1e3
    require(0 < len(sel) < int(scene.num_alive) and bool(scene.alive[torch.from_numpy(sel).to(dev)].all()),
            f"selection of {len(sel)} Gaussians")
    with torch.no_grad():
        frame0 = inference.render_frame(scene, EDIT_T, cam.extrinsic, rcfg, device=DEVICE).features["rgb"]
        m = torch.from_numpy(mask).to(dev)[..., None]
        target = torch.where(m > 0, frame0 * torch.tensor(EDIT_SCALE, device=dev), frame0).cpu().numpy()

    def mse(sc):
        out = inference.render_frame(sc, EDIT_T, cam.extrinsic, rcfg, device=DEVICE).features["rgb"]
        return float(torch.mean((out - torch.from_numpy(target).to(dev)) ** 2))

    loss0 = mse(scene)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    edited = inference.optimize_appearance(scene, sel, target, cam, rcfg, t=EDIT_T, steps=EDIT_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    app_ms = (time.perf_counter() - t0) * 1e3 / EDIT_STEPS
    launches = read_launches()
    require(launches == {k: EDIT_STEPS for k in launches}, f"appearance launch counts {launches}")
    loss1 = mse(edited)
    require(loss1 < loss0, f"appearance loss did not fall: {loss0} -> {loss1}")
    other = torch.ones(scene.alive.shape[0], dtype=torch.bool, device=dev)
    other[torch.from_numpy(sel).to(dev)] = False
    for k, v in scene.params.items():
        same = torch.equal(edited.params[k][other], v[other]) if k in ("features_dc", "features_rest") \
            else torch.equal(edited.params[k], v)
        require(same, f"appearance changed {k} outside the selected rows")
    log("edit", f"select_gaussians_by_mask under the central {mw}x{mh} at t={EDIT_T}: {len(sel)} Gaussians "
                f"(K_idx {EDIT_K}) in {sel_ms:.1f} ms; optimize_appearance {EDIT_STEPS} steps ({EDIT_CUTS}): "
                f"{app_ms:.3f} ms/step wall, loss {loss0:.6f} -> {loss1:.6f}, launches {launches}; every "
                f"unselected row and every other attribute bit-identical {card}")
    log("edit", busy_line(f"optimize_appearance, {EDIT_BUSY_STEPS} steps", lambda: inference.optimize_appearance(
        scene, sel, target, cam, rcfg, t=EDIT_T, steps=EDIT_BUSY_STEPS, device=DEVICE), 2, EDIT_BUSY_STEPS,
        app_ms, card))

    t0 = time.perf_counter()
    whole = inference.optimize_appearance_from_img(scene, target, cam, rcfg, t=EDIT_T, steps=EDIT_IMG_STEPS,
                                                   device=DEVICE)
    torch.cuda.synchronize()
    img_ms = (time.perf_counter() - t0) * 1e3 / EDIT_IMG_STEPS
    loss2 = mse(whole)
    require(loss2 < loss0, f"whole-frame appearance loss did not fall: {loss0} -> {loss2}")
    fg, bgl = inference.split_layers(scene)
    n_fg, n_bg = int(fg.num_alive), int(bgl.num_alive)
    require(n_fg > 0 and n_bg > 0 and n_fg + n_bg == int(scene.num_alive), f"layers {n_fg} + {n_bg}")
    dup = inference.add_fg_copy(scene, np.asarray(EDIT_DELTA))
    n_copy = int(dup.num_alive) - int(scene.num_alive)
    require(n_copy == min(n_fg, scene.alive.shape[0] - int(scene.num_alive)), f"add_fg_copy wrote {n_copy}")
    video = inference.render_video(dup, cam, rcfg, [0, 1, 2], device=DEVICE)
    require(video["rgb"].shape == (3, H, W, 3) and np.isfinite(video["rgb"]).all(), "the copy's video")
    log("edit", f"optimize_appearance_from_img over {int(scene.num_alive)} alive, {EDIT_IMG_STEPS} steps: "
                f"{img_ms:.3f} ms/step wall, loss {loss0:.6f} -> {loss2:.6f}; split_layers fg {n_fg} + bg {n_bg}; "
                f"add_fg_copy {EDIT_DELTA}: {n_copy} copies (truncated to the free slots), 3 frames rendered, "
                f"finite {card}")
    return rows


def pose_phase(args, dev, card: str, scene, clip) -> None:
    """Phase 16: pose refinement against the fixed flagship scene from
    frames rendered at known twists, then the joint fit on phase 12's clip
    with a checkpoint and a resume that restores the twists."""
    import os
    import tempfile

    import torch

    from splatter_a_video_tpu_torch.data import pairs
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize
    from splatter_a_video_tpu_torch.train import camera_refine, fit, hooks, trainer
    from splatter_a_video_tpu_torch.utils.pose import apply_se3_to_extrinsic

    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS)
    rng = np.random.RandomState(args.seed + 7)
    xi_true = np.zeros((POSE_FRAMES, 6), np.float32)
    for t in range(POSE_FRAMES):
        v = rng.randn(3)
        v[2] = 0.0   # an orthographic image does not see a move along z
        w = rng.randn(3)
        xi_true[t] = np.concatenate([v / np.linalg.norm(v), w / np.linalg.norm(w)]) * POSE_TWIST
    extr0 = torch.as_tensor(cam.extrinsic, dtype=torch.float32, device=dev)
    with torch.no_grad():
        frames = torch.stack([rasterize.render_gaussians(
            scene.get_position(float(t)), scene.get_scaling(), scene.get_rotation(float(t)), scene.get_opacity(),
            scene.get_shs(), apply_se3_to_extrinsic(extr0, torch.from_numpy(xi_true[t]).to(dev)), rcfg,
        ).features["rgb"] for t in range(POSE_FRAMES)])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    xi, info = camera_refine.refine_camera_poses(scene, frames, cam.extrinsic, rcfg, num_iters=POSE_ITERS,
                                                 lr=POSE_LR, device=DEVICE)
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) * 1e3 / POSE_ITERS
    launches = read_launches()
    require(launches == {k: POSE_ITERS * POSE_FRAMES for k in launches}, f"pose launch counts {launches}")
    # the error over the components an orthographic image sees: v_z moves no
    # pixel (only through the small coupling in exp's V), so Adam, which
    # normalises its gradient, walks it by up to lr a step
    seen = [0, 1, 3, 4, 5]
    err0, err1 = float(np.linalg.norm(xi_true[:, seen])), float(np.linalg.norm((xi - xi_true)[:, seen]))
    full = float(np.linalg.norm(xi - xi_true))
    require(np.isfinite(xi).all() and err1 < 0.5 * err0, f"twist error {err0:.5f} -> {err1:.5f}")
    log("pose", f"refine_camera_poses, {POSE_FRAMES} frames at known twists (|v| = |w| = {POSE_TWIST}, v_z = 0), "
                f"{POSE_ITERS} iterations, lr {POSE_LR}: twist error over v_x, v_y, w {err0:.5f} -> {err1:.5f} "
                f"(with v_z: {full:.5f}; max |v_z| {np.abs(xi[:, 2]).max():.5f}), loss "
                f"{info['loss_first']:.6f} -> {info['loss_last']:.6f}; {it_ms:.3f} ms/iteration wall "
                f"({POSE_FRAMES} renders); launches {launches} {card}")
    log("pose", busy_line("refine_camera_poses, 1 iteration", lambda: camera_refine.refine_camera_poses(
        scene, frames, cam.extrinsic, rcfg, num_iters=1, lr=POSE_LR, device=DEVICE), 2, 1, it_ms, card))

    fcfg, tcfg = fit_configs(args, POSE_FIT_STEPS, refine_camera=True, camera_warmup=POSE_WARMUP,
                             log_every=POSE_FIT_STEPS // 2)
    every = POSE_FIT_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        state, hist = fit.fit_clip(clip, fcfg, tcfg, hooks=[hooks.CheckPointHook(every=every)], out_dir=tmp,
                                   device=DEVICE)
        launches = read_launches()
        require(launches == {k: POSE_FIT_STEPS for k in launches}, f"joint fit launch counts {launches}")
        for m in hist:
            require(all(np.isfinite(v) for v in m.values() if isinstance(v, (int, float))), f"joint fit {m}")
        saved = torch.load(os.path.join(tmp, "camera_refine.pt"), map_location=dev, weights_only=True)
        xi_fit = np.load(os.path.join(tmp, "camera_xi.npy"))
        require(saved["count"] == POSE_FIT_STEPS and np.array_equal(xi_fit, saved["xi"].cpu().numpy())
                and np.abs(xi_fit).max() > 0, "joint fit twists")
        os.remove(os.path.join(tmp, "camera_xi.npy"))
        fit.fit_clip(clip, fcfg, tcfg, hooks=[hooks.CheckPointHook(every=every)], out_dir=tmp, resume=True,
                     device=DEVICE)
        back = torch.load(os.path.join(tmp, "camera_refine.pt"), map_location=dev, weights_only=True)
        restored = torch.from_numpy(np.load(os.path.join(tmp, "camera_xi.npy"))).to(dev)
        require(torch.equal(restored, saved["xi"]) and back["count"] == saved["count"]
                and all(torch.equal(back[k], saved[k]) for k in ("xi", "mu", "nu")),
                "the resumed twists differ from the saved ones")
    timing = hist[-1]["timing"]
    log("pose", f"fit_clip(refine_camera=True, camera_warmup={POSE_WARMUP}) on phase 12's clip, {POSE_FIT_STEPS} "
                f"steps: loss {hist[0]['loss']:.5f} -> {hist[-1]['loss']:.5f}, |xi| {hist[-1]['cam_xi_norm']:.5f}, "
                f"steady {timing['steady_ms']} ms/step wall, setup {timing['setup_s']} s; launches {launches}; "
                f"checkpoint at {POSE_FIT_STEPS}, --resume restored the twists and their Adam state torch.equal "
                f"{card}")
    frames_store = trainer.FrameStore(
        rgb=torch.from_numpy(np.stack(clip.frames)).to(dev),
        depth=torch.from_numpy(np.stack([clip.get_loss_depth(t) for t in range(FRAMES)])).to(dev))
    jstep = camera_refine.make_joint_train_step(tcfg, cam.extrinsic, cam_lr=fcfg.camera_lr,
                                                cam_prior_weight=fcfg.camera_prior, frames=frames_store,
                                                device=DEVICE)
    cs = camera_refine.CamTrainState(state, torch.from_numpy(xi_fit).to(dev),
                                     camera_refine.make_cam_optimizer(fcfg.camera_lr).init(
                                         torch.from_numpy(xi_fit).to(dev)))
    batch = pairs.batch_to_device(pairs.BatchBuilder(clip, TRACKS, seed=args.seed, slim=True).build(
        TRAIN_T1, TRAIN_T2), dev)
    jwall = wall_ms(lambda: jstep(cs, batch), reps=3)
    log("pose", busy_line("joint train step of the fitted state, 3 steps alone", lambda: jstep(cs, batch), 3, 1,
                          jwall, card))


def atlas_model(args):
    """The two atlases of ATLAS_SPLIT cut from the flagship arrays, on the card."""
    from splatter_a_video_tpu_torch import convert

    params, aux, cfg = flagship_scene_arrays(args.seed)
    atlases, lo = {}, 0
    for name, n, cap in ATLAS_SPLIT:
        p = {}
        for k, v in params.items():
            a = np.repeat(v[-1:], cap, axis=0)   # every slot a dead one, then the live rows
            a[:n] = v[lo:lo + n]
            p[k] = a
        atlases[name] = {"params": p, "aux": {"alive": np.arange(cap) < n, "spline_knots": aux["spline_knots"]},
                         "cfg": {**cfg, "capacity": cap}}
        lo += n
    return convert.atlas_from_numpy(atlases, device=DEVICE)


def atlas_phase(args, dev, card: str) -> None:
    """Phase 17: two atlases cut from the flagship arrays, ATLAS_STEPS steps
    of `make_atlas_train_step` at full width and a density step."""
    import torch

    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.train import atlas_trainer, trainer

    model = atlas_model(args)
    cam = camera.canonical_camera(W, H)
    tcfg = trainer.TrainerConfig(width=W, height=H, num_frames=FRAMES, max_intersections=MAX_INTERSECTIONS)
    step, dstep, _ = atlas_trainer.make_atlas_train_step(tcfg, cam.extrinsic, device=DEVICE)
    st0 = st = atlas_trainer.init_atlas_train_state(tcfg, model, seed=args.seed, device=DEVICE)
    batch = trainer.Batch(t1=TRAIN_T1, t2=TRAIN_T2, **{
        k: torch.from_numpy(v).to(dev) for k, v in train_batch_arrays(args.seed).items()})
    torch.cuda.synchronize()
    reset_launches()
    hist, step_ms = [], []
    for _ in range(ATLAS_STEPS):
        t0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        hist.append({k: float(v) for k, v in m.items()})
    launches = read_launches()
    require(launches == {k: ATLAS_STEPS for k in launches}, f"atlas launch counts {launches}")
    require(all(np.isfinite(v) for m in hist for v in m.values()), "atlas metrics not finite")
    require(hist[-1]["loss_rgb"] < hist[0]["loss_rgb"], "atlas loss_rgb did not fall")
    require(all(int(st.opt_states[n].count) == ATLAS_STEPS for n, _, _ in ATLAS_SPLIT), "atlas Adam counts")
    dense, infos = dstep(st)
    for name, n, cap in ATLAS_SPLIT:
        alive = int(dense.model.atlases[name].alive.sum())
        require(alive == int(infos[name].num_alive), f"atlas {name}: alive {alive} != {int(infos[name].num_alive)}")
    med = statistics.median(step_ms[1:])
    log("atlas", f"{len(ATLAS_SPLIT)} atlases ({', '.join(f'{nm} {n} in {c}' for nm, n, c in ATLAS_SPLIT)}), "
                 f"{ATLAS_STEPS} steps of make_atlas_train_step at {W}x{H}, C=7: loss_rgb {hist[0]['loss_rgb']:.5f} "
                 f"-> {hist[-1]['loss_rgb']:.5f}, max {max(int(m['num_intersections']) for m in hist)} intersections; "
                 f"{med:.3f} ms/step wall (median of steps 2-{ATLAS_STEPS}); launches {launches}; density step: "
                 + "; ".join(f"{nm} cloned {int(infos[nm].num_cloned)}, split {int(infos[nm].num_split)}, pruned "
                             f"{int(infos[nm].num_pruned)}, alive {int(infos[nm].num_alive)} == its mask"
                             for nm, _, _ in ATLAS_SPLIT) + f" {card}")
    log("atlas", busy_line("atlas step, 3 steps", lambda: step(st0, batch), 3, 1, med, card))


def engine_phase(args, dev, card: str, cpm: float) -> dict:
    """Phase 18: the perspective engine at EngineConfig's defaults on
    ENGINE_VIEWS orbit views of a ground-truth cluster fed in memory;
    returns the kernel instances of its blend."""
    import tempfile

    import torch

    from splatter_a_video_tpu_torch.data import readers
    from splatter_a_video_tpu_torch.models import camera, gaussians, legacy_render
    from splatter_a_video_tpu_torch.ops import rasterize
    from splatter_a_video_tpu_torch.train import engine

    S = ENGINE_WH
    rng = np.random.RandomState(args.seed + 8)
    gt = gaussians.create_scene(
        gaussians.SceneConfig(capacity=ENGINE_GT, num_frames=1, traj="static"),
        rng.uniform(-0.8, 0.8, (ENGINE_GT, 3)).astype(np.float32), rng.uniform(0.1, 0.9, (ENGINE_GT, 3)),
        init_opacity=0.8, device=DEVICE)
    vcfg = rasterize.RasterizeConfig(width=S, height=S, ortho=False, max_intersections=MAX_INTERSECTIONS, nearest=0.2)
    cams, imgs, n_gt = [], [], []
    with torch.no_grad():
        for i in range(ENGINE_VIEWS):
            a = 2 * np.pi * i / ENGINE_VIEWS
            p = np.array([ENGINE_ORBIT * np.sin(a), 0.3 * np.sin(2 * a), -ENGINE_ORBIT * np.cos(a)], np.float32)
            R = camera.look_at_rotation(p, np.zeros(3))
            c = camera.Camera(width=S, height=S, R=R, t=-R @ p)
            out = rasterize.render_gaussians(
                gt.get_position(0.0), gt.get_scaling(), gt.get_rotation(0.0), gt.get_opacity(), gt.get_shs(),
                torch.from_numpy(c.extrinsic).to(dev), vcfg, intr=torch.from_numpy(c.intrinsic).to(dev),
                bg_color=1.0, view_dir_z=False)
            cams.append(c)
            imgs.append(np.clip(out.features["rgb"].cpu().numpy(), 0, 1))
            n_gt.append(int(out.num_intersections))
    frames = readers.SceneFrames(cameras=tuple(cams), image_paths=(), backgrounds=(1.0,) * ENGINE_VIEWS,
                                 images=tuple(imgs))
    cfg = engine.EngineConfig(width=S, height=S, sh_degree_interval=ENGINE_SH_INTERVAL)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        eng = engine.Engine(cfg, frames, out_dir=tmp, seed=args.seed, device=DEVICE)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    require(int(eng.state.scene.num_alive) == min(cfg.random_init_points, cfg.capacity), "engine init")
    rc = eng.cfg.raster_cfg()
    with torch.no_grad():
        zeros = torch.zeros((cfg.capacity, 2), device=dev)
        pr = engine.project_persp_for_training(eng.state.scene, rc, eng.train_batches[0], 0, zeros, eng.bg)
        rows = blend_instance("engine perspective", pr, rc, cpm, args.seed + 10, card)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng.train(num_steps=1)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    loss_first, nint_first = eng.metrics["loss"], int(eng.metrics["num_intersections"])
    t0 = time.perf_counter()
    m = eng.train(num_steps=ENGINE_STEPS - 1)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) * 1e3 / (ENGINE_STEPS - 1)
    launches = read_launches()
    require(launches == {k: ENGINE_STEPS for k in launches}, f"engine launch counts {launches}")
    require(all(np.isfinite(v) for v in m.values()) and int(eng.state.step) == ENGINE_STEPS, f"engine {m}")
    require(eng.active_sh_degree(ENGINE_STEPS - 1) == (ENGINE_STEPS - 1) // ENGINE_SH_INTERVAL, "SH degree")
    eng.state, info = eng._density_step(eng.state)
    require(int(info.num_alive) == int(eng.state.scene.alive.sum()), "engine density: alive != num_alive")
    log("engine", f"EngineConfig defaults at {S}x{S} (capacity {cfg.capacity}, {cfg.random_init_points} random "
                  f"init points, budget {cfg.max_intersections}, near {cfg.nearest}), {ENGINE_VIEWS} orbit views of a "
                  f"{ENGINE_GT}-Gaussian cluster fed in memory (their renders {min(n_gt)}-{max(n_gt)} intersections); "
                  f"setup {setup_s:.2f} s; {ENGINE_STEPS} steps, SH interval {ENGINE_SH_INTERVAL}: loss "
                  f"{loss_first:.5f} (step 1) -> {m['loss']:.5f} (step {ENGINE_STEPS}), psnr {m['psnr']:.3f}, "
                  f"intersections {nint_first} -> {int(m['num_intersections'])} of {cfg.max_intersections}"
                  f"{' (saturated)' if int(m['num_intersections']) > cfg.max_intersections else ''}; first step "
                  f"{first_ms:.1f} ms, then {steady:.3f} ms/step wall; launches {launches}; density step: cloned "
                  f"{int(info.num_cloned)}, split {int(info.num_split)}, pruned {int(info.num_pruned)}, alive "
                  f"{int(info.num_alive)} == its mask {card}")
    batch = eng.train_batches[0]
    log("engine", busy_line("engine step, 3 steps", lambda: eng._train_step(eng.state, batch, 1), 3, 1,
                            wall_ms(lambda: eng._train_step(eng.state, batch, 1), reps=3), card))
    c = cams[0]
    wvt = np.eye(4, dtype=np.float32)
    wvt[:3, :4] = c.extrinsic
    sc = eng.state.scene
    r = legacy_render.GaussianSplattingRender()
    with torch.no_grad():
        out = r.render_iter(FovX=c.fovx, FovY=camera.focal2fov(c.focal_y, S), height=S, width=S,
                            world_view_transform=torch.from_numpy(wvt.T.copy()).to(dev), full_proj_transform=None,
                            camera_center=torch.from_numpy(c.camera_center).to(dev), position=sc.get_position(0.0),
                            opacity=sc.get_opacity(), scaling=sc.get_scaling(), rotation=sc.get_rotation(0.0),
                            shs=sc.get_shs())
    require(out["rgb"].shape == (S, S, 3) and bool(torch.isfinite(out["rgb"]).all()), "render_iter")
    log("engine", f"GaussianSplattingRender.render_iter at {S}x{S}: finite, {int(out['visibility'].sum())} visible "
                  f"{card}")
    return rows


def small_batch_arrays(seed: int, w: int = 64, h: int = 48, n: int = DP_SMALL_TRACKS):
    """`train_batch_arrays` at w x h with n tracks."""
    rng = np.random.RandomState(seed + 9)
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    rgb = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx + 0.3 * yy) + ph) for ph in (0.0, 2.0, 4.0)], -1)
    depth = 0.5 + 1.5 * (0.5 + 0.5 * np.cos(np.pi * xx) * np.cos(0.5 * np.pi * yy))
    qp = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1)
    tracks = np.concatenate([qp + rng.randn(n, 2) * 2.0, rng.uniform(-6.0, -2.0, (n, 2))], 1)
    return dict(rgb1=rgb.astype(np.float32), depth1=depth.astype(np.float32), query_px=qp.astype(np.float32),
                target_tracks=tracks.astype(np.float32), track_valid=np.ones(n, bool))


def dp_phase(args, dev, card: str, scene) -> dict:
    """Phase 19: a process group of one rank (NCCL, a FileStore in a temp
    dir); DP_STEPS steps of `make_dp_train_step` at the flagship training
    shape; one DP step on the card against the same step on the CPU at
    64x48 (a gloo group of the same rank), at the gradient bars; one atlas
    and one joint DP step at full width. One card shows no DP speedup: the
    times are what one rank costs. Returns the DP steps' launch counts."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.parallel import dp, mesh
    from splatter_a_video_tpu_torch.train import atlas_trainer, camera_refine, trainer

    tmp = tempfile.mkdtemp()
    mesh.init_process_group("nccl", store_path=os.path.join(tmp, "store"), rank=0, world_size=1)
    require(mesh.world_size() == 1 and dist.get_backend() == "nccl", "the NCCL group of one rank")
    cam = camera.canonical_camera(W, H)
    tcfg = trainer.TrainerConfig(width=W, height=H, num_frames=FRAMES, max_intersections=MAX_INTERSECTIONS)
    step = dp.make_dp_train_step(tcfg, cam.extrinsic, device=DEVICE)
    state0 = state = trainer.init_train_state(tcfg, scene, seed=args.seed, device=DEVICE)
    batch = dp.stack_batches([trainer.Batch(t1=TRAIN_T1, t2=TRAIN_T2, **train_batch_arrays(args.seed))])
    torch.cuda.synchronize()
    reset_launches()
    hist, step_ms = [], []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        hist.append({k: float(v) for k, v in m.items()})
    launches = read_launches()
    require(launches == {k: DP_STEPS for k in launches}, f"DP launch counts {launches}")
    require(all(np.isfinite(v) for m in hist for v in m.values()), "DP metrics not finite")
    require(hist[-1]["loss_rgb"] < hist[0]["loss_rgb"], "DP loss_rgb did not fall")
    require(state.step == DP_STEPS and state.opt_state.count == DP_STEPS, "DP step counts")
    med = statistics.median(step_ms[1:])
    log("dp", f"NCCL group of 1 rank (FileStore); {DP_STEPS} steps of make_dp_train_step at {W}x{H}, {ALIVE} alive in "
              f"{CAPACITY}, C={len(TRAIN_MASK)}, {TRACKS} tracks: loss {hist[0]['loss']:.5f} -> {hist[-1]['loss']:.5f}, "
              f"loss_rgb {hist[0]['loss_rgb']:.5f} -> {hist[-1]['loss_rgb']:.5f}; {med:.3f} ms/step wall (median of "
              f"steps 2-{DP_STEPS}; all: {', '.join(f'{t:.1f}' for t in step_ms)}); launches {launches} {card}")
    log("dp", busy_line("DP train step, 3 steps", lambda: step(state0, batch), 3, 1, med, card))

    # one DP step on the card against the same step on the CPU (a gloo group of the same rank)
    small = small_train_scene(args.seed)
    scfg = trainer.TrainerConfig(width=64, height=48, num_frames=8, max_intersections=1 << 14,
                                 num_track_samples=DP_SMALL_TRACKS)
    scam = camera.canonical_camera(64, 48)
    sbatch = dp.stack_batches([trainer.Batch(t1=2, t2=5, **small_batch_arrays(args.seed))])
    gloo = mesh.make_mesh(backend="gloo")
    outs = {}
    for d, group in ((DEVICE, None), ("cpu", gloo)):
        st = trainer.init_train_state(scfg, small, seed=args.seed, device=d)
        outs[d] = dp.make_dp_train_step(scfg, scam.extrinsic, group=group, device=d)(st, sbatch)
    (sg, mg), (sc, mc) = outs[DEVICE], outs["cpu"]
    worst = 0.0
    for k in sc.scene.params:   # the first Adam moment is 0.1 g
        g_gpu, g_cpu = sg.opt_state.mu[k].cpu() / 0.1, sc.opt_state.mu[k] / 0.1
        require(torch.isfinite(g_gpu).all().item(), f"DP gradient of {k} not finite")
        worst = max(worst, ((g_gpu - g_cpu).abs() / (GRAD_ATOL + GRAD_RTOL * g_cpu.abs())).max().item())
    loss_rel = abs(float(mg["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
    require(worst <= 1.0 and loss_rel <= 1e-4, f"DP step GPU vs CPU: {worst:.3g} of the bar, loss rel {loss_rel:.3g}")
    log("dp", f"64x48 DP step, NCCL on the card vs gloo on the CPU: {len(sc.scene.params)} averaged gradients worst "
              f"|diff| / (atol {GRAD_ATOL} + rtol {GRAD_RTOL} |cpu|) = {worst:.3g}; loss rel diff {loss_rel:.3g}")

    # one atlas and one joint (camera-refine) DP step at full width
    astep = dp.make_dp_atlas_step(tcfg, cam.extrinsic, device=DEVICE)
    ast = atlas_trainer.init_atlas_train_state(tcfg, atlas_model(args), seed=args.seed, device=DEVICE)
    ast1, am = astep(ast, batch)
    require(ast1.step == 1 and all(np.isfinite(float(v)) for v in am.values()), "atlas DP step")
    atlas_ms = wall_ms(lambda: astep(ast, batch), reps=3)
    cs = camera_refine.init_cam_train_state(tcfg, scene, seed=args.seed, cam_lr=DP_CAM_LR, device=DEVICE)
    jstep = dp.make_dp_joint_step(tcfg, cam.extrinsic, cam_lr=DP_CAM_LR, device=DEVICE)
    cs1, jm = jstep(cs, batch)
    moved = int((cs1.cam_xi[[TRAIN_T1, TRAIN_T2]] != 0).sum())
    require(all(np.isfinite(float(v)) for v in jm.values()) and moved > 0, f"joint DP step (twists moved {moved})")
    joint_ms = wall_ms(lambda: jstep(cs, batch), reps=3)
    log("dp", f"make_dp_atlas_step ({len(ATLAS_SPLIT)} atlases) loss {float(am['loss']):.5f}, {atlas_ms:.3f} ms; "
              f"make_dp_joint_step loss {float(jm['loss']):.5f}, {moved} of 12 twist entries of frames {TRAIN_T1} "
              f"and {TRAIN_T2} moved, {joint_ms:.3f} ms (wall, median of 3) {card}")
    return launches


def shard_phase(args, dev, card: str, scene) -> dict:
    """Phase 20: the flagship frame (C = 4) rendered as SHARD_SLABS depth
    slabs in sequence on one card and folded, against the single render;
    then the collective path at world size 1 over NCCL, `torch.equal` to
    the fold of one slab. Returns the slabs' launch counts."""
    import torch
    import torch.distributed as dist

    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize
    from splatter_a_video_tpu_torch.parallel import render_shard

    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS)
    extr = torch.as_tensor(cam.extrinsic, dtype=torch.float32, device=dev)
    with torch.no_grad():
        inp = (scene.get_position(SHARD_T), scene.get_scaling(), scene.get_rotation(SHARD_T), scene.get_opacity(),
               scene.get_shs())

        def slabs():
            parts = [render_shard.render_slab(*inp, extr, rcfg, r, SHARD_SLABS) for r in range(SHARD_SLABS)]
            return render_shard.composite(*render_shard.fold_partials(*zip(*parts)))

        torch.cuda.synchronize()
        reset_launches()
        out = slabs()
        torch.cuda.synchronize()
        launches = read_launches()
        forward_only = {k: SHARD_SLABS if k in ("blend_forward", "expand_intersections") else 0 for k in launches}
        require(launches == forward_only, f"slab launch counts {launches}")
        ref = rasterize.render_gaussians(*inp, extr, rcfg)
        d = torch.maximum((out["rgb"] - ref.features["rgb"]).abs().max(-1).values,
                          (out["final_T"][..., 0] - ref.final_T).abs())
        dmax, share = d.max().item(), (d > SHARD_TYPICAL).float().mean().item()
        require(all(torch.isfinite(v).all().item() for v in out.values()), "slab render not finite")
        require(dmax <= SHARD_WALL, f"{SHARD_SLABS} slabs vs the single render: {dmax:.3g} > {SHARD_WALL}")
        seq_ms = wall_ms(slabs, reps=5)
        single_ms = wall_ms(lambda: rasterize.render_gaussians(*inp, extr, rcfg), reps=5)
        coll = render_shard.render_gaussians_sharded(*inp, extr, rcfg)
        one = render_shard.composite(*render_shard.render_slab(*inp, extr, rcfg, 0, 1))
        require(all(torch.equal(coll[k], one[k]) for k in one), "collective render != the fold of one slab")
        coll_ms = wall_ms(lambda: render_shard.render_gaussians_sharded(*inp, extr, rcfg), reps=5)
    dist.destroy_process_group()
    log("shard", f"flagship frame t={SHARD_T} (C=4) as {SHARD_SLABS} depth slabs in sequence, folded: max |diff| vs "
                 f"the single render {dmax:.3g} (bar {SHARD_WALL}), {share:.3%} of pixels above {SHARD_TYPICAL}; "
                 f"launches {launches}; walls: {SHARD_SLABS} slabs {seq_ms:.3f} ms, single render {single_ms:.3f} ms; "
                 f"render_gaussians_sharded over NCCL at world size 1 torch.equal to the fold of one slab, "
                 f"{coll_ms:.3f} ms {card}")
    return launches


def nets_phase(args, dev, card: str) -> None:
    """Phase 21: Depth-Anything-V2-small on an 854x480 frame (resized to
    518x924), TAPIR at 256x256 over 48 frames in 4 chunks of 128 queries,
    LPIPS and the VGG perceptual loss on an 854x480 pair, all random
    weights (seed NETS_SEED) at the default configurations; each timed,
    and held against the port's CPU path on smaller inputs at the JAX
    package's bars."""
    import torch

    from splatter_a_video_tpu_torch import convert
    from splatter_a_video_tpu_torch.eval import metrics
    from splatter_a_video_tpu_torch.nets import depth_anything as da
    from splatter_a_video_tpu_torch.nets import tapir

    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, "TF32 pins")
    rng = np.random.RandomState(args.seed + 11)
    xx = np.linspace(0.0, 1.0, W, dtype=np.float32)[None, :, None]
    yy = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None, None]
    frame = np.clip(0.5 + 0.4 * np.sin(2 * np.pi * (3 * xx + 2 * yy) + np.array([0.0, 2.0, 4.0]))
                    + 0.05 * rng.randn(H, W, 3), 0, 1).astype(np.float32)

    # Depth-Anything-V2-small
    dcfg = da.DepthAnythingConfig()
    dparams = da.random_params(dcfg, NETS_SEED)
    dm, dm_cpu = (convert.depth_anything_from_numpy(dparams, dcfg, device=d) for d in (DEVICE, "cpu"))
    img = (frame * 255).astype(np.uint8)
    disp = da.infer_disparity(dm, img)
    require(disp.shape == (H, W) and np.isfinite(disp).all(), "infer_disparity")
    x = torch.from_numpy(rng.randn(1, *DA_CHECK_HW, 3).astype(np.float32))
    d_gpu, d_cpu = dm(x.to(dev)).cpu(), dm_cpu(x)
    d_err = (d_gpu - d_cpu).abs().max().item()
    require(torch.allclose(d_gpu, d_cpu, atol=DA_TOL, rtol=DA_TOL), f"DA card vs CPU: {d_err:.3g}")
    da_ms = wall_ms(lambda: da.infer_disparity(dm, img), reps=NET_REPS)
    log("nets", f"Depth-Anything-V2-small (random weights, seed {NETS_SEED}): {W}x{H} frame -> "
                f"{da._fit_size(H, W)} -> disparity {disp.shape}, finite, range {disp.min():.4g}..{disp.max():.4g}; "
                f"{da_ms:.3f} ms/frame (infer_disparity, wall); card vs CPU at {DA_CHECK_HW}: max |diff| {d_err:.3g} "
                f"(bar {DA_TOL}, CPU max {d_cpu.abs().max().item():.4g}) {card}")
    log("nets", busy_line("Depth-Anything frame", lambda: da.infer_disparity(dm, img), NET_REPS, 1, da_ms, card))

    # TAPIR at 256x256, 48 frames, 4 chunks of 128 queries
    tcfg = tapir.TapirConfig()
    tparams = tapir.random_params(tcfg, NETS_SEED)
    tm, tm_cpu = (convert.tapir_from_numpy(tparams, tcfg, device=d) for d in (DEVICE, "cpu"))
    res = tcfg.initial_resolution
    video = (np.clip(np.stack([frame[(np.arange(res[0]) * H) // res[0]][:, (np.arange(res[1]) * W) // res[1]]
                               * (0.9 + 0.1 * np.cos(0.2 * t)) for t in range(TAPIR_FRAMES)]), 0, 1)
             * 255).astype(np.uint8)
    nq = TAPIR_CHUNK * TAPIR_CHUNKS
    qp = np.stack([rng.randint(0, TAPIR_FRAMES, nq), rng.uniform(0, res[0] - 1, nq),
                   rng.uniform(0, res[1] - 1, nq)], 1).astype(np.float32)
    out = tapir.track_points(tm, video, qp, chunk=TAPIR_CHUNK)
    require(out["tracks"].shape == (nq, TAPIR_FRAMES, 2) and all(np.isfinite(v).all() for v in out.values()),
            "track_points")
    tapir_ms = wall_ms(lambda: tapir.track_points(tm, video, qp, chunk=TAPIR_CHUNK), reps=1) / TAPIR_CHUNKS
    q8 = qp[:TAPIR_CHUNK].copy()
    q8[:, 0] = q8[:, 0] % TAPIR_CHECK_FRAMES
    g8 = tapir.track_points(tm, video[:TAPIR_CHECK_FRAMES], q8, chunk=TAPIR_CHUNK)
    t0 = time.perf_counter()
    c8 = tapir.track_points(tm_cpu, video[:TAPIR_CHECK_FRAMES], q8, chunk=TAPIR_CHUNK)
    cpu_s = time.perf_counter() - t0
    errs = {k: np.abs(g8[k] - c8[k]).max() for k in c8}
    require(all(np.allclose(g8[k], c8[k], atol=TAPIR_ATOL, rtol=TAPIR_RTOL) for k in c8),
            f"TAPIR card vs CPU: {errs}")
    log("nets", f"TAPIR (random weights, seed {NETS_SEED}) at {res[0]}x{res[1]}, {TAPIR_FRAMES} frames, "
                f"{TAPIR_CHUNKS} chunks of {TAPIR_CHUNK} queries: finite; {tapir_ms:.3f} ms/chunk (track_points, "
                f"wall; each chunk recomputes the {TAPIR_FRAMES} frames' feature grids); card vs CPU on "
                f"{TAPIR_CHECK_FRAMES} frames, one chunk: max |diff| "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (bars atol {TAPIR_ATOL}, rtol {TAPIR_RTOL}; CPU {cpu_s:.1f} s) {card}")
    log("nets", busy_line("TAPIR chunk", lambda: tapir.track_points(tm, video, qp[:TAPIR_CHUNK], chunk=TAPIR_CHUNK),
                          1, 1, tapir_ms, card))

    # LPIPS and the VGG perceptual loss
    other = np.clip(frame + 0.1 * rng.randn(H, W, 3), 0, 1).astype(np.float32)
    mask = (rng.rand(H, W) > 0.3).astype(np.float32)
    lp = metrics.lpips(frame, other, device=DEVICE)
    vg = metrics.vgg_perceptual_loss(frame, other, mask, device=DEVICE)
    require(np.isfinite(lp) and lp > 0 and np.isfinite(vg) and vg > 0, f"lpips {lp}, vgg {vg}")
    lp_ms = wall_ms(lambda: metrics.lpips(frame, other, device=DEVICE), reps=NET_REPS)
    vg_ms = wall_ms(lambda: metrics.vgg_perceptual_loss(frame, other, mask, device=DEVICE), reps=NET_REPS)
    h, w = LPIPS_CHECK_HW
    pair = (frame[:h, :w], other[:h, :w])
    rel = max(abs(f(*pair, device=DEVICE) - f(*pair, device="cpu")) / abs(f(*pair, device="cpu"))
              for f in (metrics.lpips, lambda a, b, device: metrics.vgg_perceptual_loss(a, b, mask[:h, :w], device)))
    require(rel <= LPIPS_RTOL, f"LPIPS / VGG loss card vs CPU rel {rel:.3g}")
    log("nets", f"LPIPS (random VGG16 trunk, seed 0) {lp:.5f}, {lp_ms:.3f} ms/pair; vgg_perceptual_loss (masked) "
                f"{vg:.5f}, {vg_ms:.3f} ms/pair ({W}x{H}, wall); card vs CPU at {w}x{h}: rel diff {rel:.3g} "
                f"(bar {LPIPS_RTOL}) {card}")
    log("nets", busy_line("LPIPS pair", lambda: metrics.lpips(frame, other, device=DEVICE), NET_REPS, 1, lp_ms, card))


def helpers_phase(args, dev, card: str, scene) -> None:
    """Phase 22: the loss library on the card at the flagship shapes,
    against the port's CPU path on the same inputs: the first-K entropy
    and blend on the ids of the flagship frame at t = 0 (K1 at K_idx 10),
    the depth correlation, scale-shift-invariant and range losses on its
    rendered depth, the feature smoothness over the scene's positions and
    the distortion loss. Values to rel HELPERS_RTOL, gradients to the
    gradient bars, each gradient run twice on the card and held
    `torch.equal`; the smoothness loss's neighbours must be equal on both
    sides before its values are compared."""
    import torch

    from splatter_a_video_tpu_torch import inference
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize, sh
    from splatter_a_video_tpu_torch.train import losses, prng

    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS, K_idx=HELPERS_K)
    with torch.no_grad():
        out = inference.render_frame(scene, HELPERS_T, cam.extrinsic, rcfg, device=DEVICE)
        gs_idx, depth = out.gs_idx, out.features["depth"][..., 0].contiguous()
        opacity = scene.get_opacity().reshape(-1).contiguous()
        rgb = sh.sh_to_rgb(scene.params["features_dc"][:, 0]).contiguous()
        positions = scene.get_position(HELPERS_T).contiguous()
    require(gs_idx.shape == (H, W, HELPERS_K) and bool((gs_idx >= 0).any()),
            f"first-K ids of shape {tuple(gs_idx.shape)}")
    rng = np.random.RandomState(args.seed + 22)
    seeded = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    target = seeded(depth.cpu().numpy() * 1.3 + 0.1 + rng.randn(H, W) * 0.05)
    key = prng.key(args.seed + 22)
    edges = seeded(np.sort(rng.rand(H * W, HELPERS_BINS + 1), axis=-1))
    cases = [   # name, fn, inputs, the inputs whose gradients are taken
        ("entropy_loss", losses.entropy_loss, (opacity, gs_idx), (0,)),
        ("alpha_blending_firstK", losses.alpha_blending_firstK,
         (rgb, gs_idx, seeded(rng.rand(H, W, HELPERS_K))), (0, 2)),
        ("depth_correlation_loss", lambda g, d: losses.depth_correlation_loss(g, d, HELPERS_PATCH, HELPERS_PATCHES,
                                                                               key), (target, depth), (1,)),
        ("scale_shift_invariant_depth_loss", losses.scale_shift_invariant_depth_loss, (depth, target), (0,)),
        ("depth_range_loss", lambda d: losses.depth_range_loss(d, *HELPERS_DEPTH_RANGE), (depth,), (0,)),
        ("smoothness_loss", lambda p, a: losses.smoothness_loss(p, key, None, HELPERS_KNN, HELPERS_SAMPLES, a),
         (positions, scene.alive), (0,)),
        ("distortion_loss", losses.distortion_loss, (edges, seeded(rng.rand(H * W, HELPERS_BINS))), (0, 1)),
    ]

    # the smoothness loss's neighbours first: the same samples and kNN on both sides
    idx_dev = losses.arap_sample(CAPACITY, HELPERS_SAMPLES, scene.alive, key, dev)
    idx_cpu = losses.arap_sample(CAPACITY, HELPERS_SAMPLES, scene.alive.cpu(), key, "cpu")
    nn_dev = losses.arap_connectivity(positions, k=HELPERS_KNN, query_idx=idx_dev, alive=scene.alive)
    nn_cpu = losses.arap_connectivity(positions.cpu(), k=HELPERS_KNN, query_idx=idx_cpu, alive=scene.alive.cpu())
    bad_rows = int((nn_dev[0].cpu() != nn_cpu[0]).any(1).sum())
    require(torch.equal(idx_dev.cpu(), idx_cpu), "smoothness_loss: the samples differ between the card and the CPU")
    require(bad_rows == 0 and torch.equal(nn_dev[2].cpu(), nn_cpu[2]),
            f"smoothness_loss: the neighbours of {bad_rows} of {HELPERS_SAMPLES} samples differ between the card and "
            "the CPU (distances rounded, or equal ones ordered, otherwise)")

    def run(fn, inputs, grad_of, seed):
        """fn's output and the gradients of a seeded weighting of it."""
        leaves = [x.detach().clone().requires_grad_(i in grad_of) for i, x in enumerate(inputs)]
        v = fn(*leaves)
        wt = torch.from_numpy(np.asarray(np.random.RandomState(seed).rand(*v.shape), np.float32)).to(v.device)
        grads = torch.autograd.grad((v * wt).sum(), [leaves[i] for i in grad_of])
        return v.detach(), [g.detach() for g in grads]

    parts = []
    for i, (name, fn, inputs, grad_of) in enumerate(cases):
        seed = args.seed + 220 + i
        v1, g1 = run(fn, inputs, grad_of, seed)
        v2, g2 = run(fn, inputs, grad_of, seed)
        vc, gc = run(fn, [x.cpu() for x in inputs], grad_of, seed)
        torch.cuda.synchronize()
        same = torch.equal(v1, v2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
        rel = (v1.cpu() - vc).abs().max().item() / max(vc.abs().max().item(), 1e-30)
        worst = max(((a.cpu() - b).abs() / (GRAD_ATOL + GRAD_RTOL * b.abs())).max().item() for a, b in zip(g1, gc))
        finite = bool(torch.isfinite(v1).all()) and all(bool(torch.isfinite(g).all()) for g in g1)
        require(finite, f"{name}: not finite on the card")
        require(rel <= HELPERS_RTOL, f"{name}: the card against the CPU at rel {rel:.3g} > {HELPERS_RTOL}")
        require(worst <= 1.0, f"{name}: gradients, the card against the CPU at {worst:.3g} of the bar")
        require(same, f"{name}: two runs on the card differ")
        ms = wall_ms(lambda: run(fn, inputs, grad_of, seed), reps=REPS)
        parts.append(f"{name} {ms:.3f} ms (value rel {rel:.2g}, gradients {worst:.2g} of the bar, repeat "
                     "torch.equal)")
    log("helpers", f"flagship frame t={HELPERS_T} at K_idx {HELPERS_K} ({int((gs_idx >= 0).sum())} of "
                   f"{gs_idx.numel()} first-K ids set, the rest -1), {int(scene.num_alive)} alive of {CAPACITY}; the smoothness "
                   f"loss's {HELPERS_SAMPLES} samples x {HELPERS_KNN} neighbours equal on the card and the CPU; "
                   f"value + gradients, median wall of {REPS} with a synchronize: " + "; ".join(parts) + f" {card}")


def lbs_draws_check(card: str) -> None:
    """C.7: `create_scene(traj="lbs")` with neither key nor generator draws
    its colours and skinning logits from JAX's PRNGKey(0) on the host:
    twice on the card at the flagship size, every parameter `torch.equal`;
    at LBS_POINTS points, the drawn parameters on the card `torch.equal` to
    the CPU call's."""
    import torch

    from splatter_a_video_tpu_torch.models import gaussians, init_points

    def scene(n, cap, dev):
        cfg = gaussians.SceneConfig(capacity=cap, num_frames=FRAMES, traj="lbs")
        return gaussians.create_scene(cfg, init_points.positive_z_random(n), device=dev)

    a, b = scene(ALIVE, CAPACITY, DEVICE), scene(ALIVE, CAPACITY, DEVICE)
    twice = all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    drawn = ("features_dc", "pos_lbs_logits")
    card_s, cpu_s = scene(LBS_POINTS, LBS_CAPACITY, DEVICE), scene(LBS_POINTS, LBS_CAPACITY, "cpu")
    as_cpu = all(torch.equal(card_s.params[k].cpu(), cpu_s.params[k]) for k in drawn)
    spread = float(a.params["pos_lbs_logits"].std())
    require(twice and as_cpu and 0.005 < spread < 0.02,
            f"lbs draws: twice equal {twice}, as the CPU's {as_cpu}, logits std {spread:.4g}")
    log("lbs", f"create_scene(traj='lbs') without a key, {ALIVE} points in {CAPACITY} slots, twice on the card: "
               f"all {len(a.params)} parameters torch.equal; {', '.join(drawn)} at {LBS_POINTS} points "
               f"torch.equal to the CPU's; logits std {spread:.5f} (0.01 N(0, 1)) {card}")


def wide_training_config():
    """Phase 23's trainer: the training shape with the render attributes
    blended (C = WIDE_TRAIN_C with a WIDE_DINO-wide DINO attribute) and the
    mask and DINO attributes supervised."""
    from splatter_a_video_tpu_torch.train import trainer

    return trainer.TrainerConfig(width=W, height=H, num_frames=FRAMES, max_intersections=MAX_INTERSECTIONS,
                                 train_render_attributes=True, mask_attr_weight=WIDE_ATTR_WEIGHT,
                                 dino_attr_weight=WIDE_ATTR_WEIGHT)


def wide_blends(scene, tcfg, extr, seed: int):
    """Phase 23's blends of the training frame TRAIN_T1, one at a time (run
    it under torch.no_grad): (projection, raster config) for each C of
    WIDE_CS on 16x16 tiles, whose first 7 channels are rgb, depth and
    track_gs and the rest the render attributes at C = WIDE_TRAIN_C (the
    wide training blend) or random from `seed`; then for each (C, tile) of
    WIDE_TILES the wide training blend or, at C = 7, rgb, depth and
    track_gs."""
    import torch

    from splatter_a_video_tpu_torch.train import trainer

    inp = trainer.scene_render_inputs(scene, TRAIN_T1)
    extra = {"track_gs": scene.get_position(TRAIN_T2), **{k: inp[k] for k in EXTRA}}

    def project(tile, names):
        rc = dataclasses.replace(tcfg, block_x=tile[0], block_y=tile[1]).raster_cfg()
        pr = trainer.project_for_training(inp, extr, rc, {k: extra[k] for k in names}, True, 0.0, tcfg.depth_bg)
        return pr, rc, sum(v.shape[1] for v, _, _ in pr.feature_groups.values())

    pr, rc16, C = project((16, 16), extra)
    require(C == WIDE_TRAIN_C, f"the wide training blend carries {C} channels, expected {WIDE_TRAIN_C}")
    base = {k: pr.feature_groups[k] for k in ("rgb", "depth", "track_gs")}
    gen = torch.Generator(device=pr.uv.device).manual_seed(seed)
    for Cw in WIDE_CS:
        groups = dict(pr.feature_groups) if Cw == C else {
            **base, "random": (torch.rand((pr.uv.shape[0], Cw - 7), generator=gen, device=pr.uv.device), 0.5, False)}
        yield pr._replace(feature_groups=groups), rc16
    del pr
    for Cw, tile in WIDE_TILES:
        pr_t, rc_t, Ct = project(tile, extra if Cw == C else ("track_gs",))
        require(Ct == Cw, f"{tile} carries {Ct} channels, expected {Cw}")
        yield pr_t, rc_t
        del pr_t


def blend_arrays(pr):
    """Features [N, C], bg [C] and alpha_grad_mask [C] of a projection's
    feature groups, as the blend takes them."""
    import torch

    groups = list(pr.feature_groups.values())
    dev = pr.uv.device
    feats = torch.cat([v for v, _, _ in groups], dim=1).contiguous()
    bg = torch.tensor([b for v, b, _ in groups for _ in range(v.shape[1])], dtype=torch.float32, device=dev)
    mask = torch.tensor([1.0 if og else 0.0 for v, _, og in groups for _ in range(v.shape[1])], device=dev)
    return feats, bg, mask


def wide_phase(args, dev, card: str, cpm: float):
    """Phase 23: the blend's wide instances. WIDE_STEPS `make_train_step`
    steps and a density step at the flagship training shape with a
    WIDE_DINO-wide DINO attribute blended and supervised (C = 52: rgb 3,
    depth 1, track_gs 3, mask 1, pos_poly_feat 12, DINO 32; R = 60 rows into
    K4); one `inference.render_frame` with the three render attributes
    (C = 49), and K1 on that frame's projection; K1, K3 and K4 at C in
    WIDE_CS and at the tiles of WIDE_TILES on the training frame, each
    `torch.equal` to its plain version and timed (with `splat_scene` too
    above 1024 pixels); and the 64x48 training render at C = 52 on the card
    against the CPU (render atol ATOL, gradients GRAD_ATOL / GRAD_RTOL).
    Returns (the kernel instances, the train steps' launch counts)."""
    import torch

    from splatter_a_video_tpu_torch import convert, inference
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize
    from splatter_a_video_tpu_torch.train import trainer

    scene = convert.scene_from_numpy(*flagship_scene_arrays(args.seed, dino=WIDE_DINO), device=DEVICE)
    cam = camera.canonical_camera(W, H)
    extr = torch.as_tensor(cam.extrinsic, dtype=torch.float32, device=dev)
    tcfg = wide_training_config()
    arrays = train_batch_arrays(args.seed)
    rng = np.random.RandomState(args.seed + 12)
    arrays["mask1"] = (rng.rand(H, W) < 0.5).astype(np.float32)
    arrays["dino1"] = rng.uniform(0.0, 1.0, (H, W, WIDE_DINO)).astype(np.float32)
    batch = trainer.Batch(t1=TRAIN_T1, t2=TRAIN_T2, **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})

    # ---- the train steps and a density step at C = 52 ----
    train_step, density_step, _ = trainer.make_train_step(tcfg, cam.extrinsic, device=DEVICE)
    state = state0 = trainer.init_train_state(tcfg, scene, seed=args.seed, device=DEVICE)
    torch.cuda.synchronize()
    reset_launches()
    history, step_ms = [], []
    for _ in range(WIDE_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    launches = read_launches()
    require(launches == {k: WIDE_STEPS for k in launches}, f"wide train launch counts {launches}")
    for i, m in enumerate(history):
        require(all(np.isfinite(v) for v in m.values()), f"wide step {i}: metrics not finite {m}")
        require(m["num_intersections"] <= MAX_INTERSECTIONS, f"wide step {i} saturated")
    first, last = history[0], history[-1]
    for k in ("loss", "loss_rgb", "loss_dino_attr"):
        require(last[k] < first[k], f"wide {k} did not fall: {first[k]} -> {last[k]}")
    dense, info = density_step(state)
    alive_after = int(dense.scene.alive.sum())
    require(alive_after == int(info.num_alive), f"wide density: alive {alive_after} != {int(info.num_alive)}")
    require(all(torch.isfinite(v).all().item() for v in dense.scene.params.values()), "wide density: not finite")
    med = statistics.median(step_ms[1:])
    log("wide", f"{WIDE_STEPS} steps of make_train_step at {W}x{H}, {ALIVE} alive, C={WIDE_TRAIN_C} (DINO "
                f"{WIDE_DINO} blended and supervised, mask too, weight {WIDE_ATTR_WEIGHT:g}), {TRACKS} tracks: "
                f"{med:.3f} ms/step wall "
                f"(median of steps 2-{WIDE_STEPS}; all: {', '.join(f'{t:.1f}' for t in step_ms)}); launches "
                f"{launches}; loss {first['loss']:.5f} -> {last['loss']:.5f}, loss_dino_attr "
                f"{first['loss_dino_attr']:.5f} -> {last['loss_dino_attr']:.5f}; density step: cloned "
                f"{int(info.num_cloned)}, split {int(info.num_split)}, pruned {int(info.num_pruned)}, alive "
                f"{alive_after} == num_alive {card}")
    log("wide", busy_line(f"wide train step (C={WIDE_TRAIN_C}), 3 steps", lambda: train_step(state0, batch), 3, 1,
                          med, card))
    del dense, state

    # ---- one frame with the three render attributes: C = 49 ----
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS)
    with torch.no_grad():
        reset_launches()
        out = inference.render_frame(scene, TRAIN_T1, cam.extrinsic, rcfg, EXTRA, device=DEVICE)
        torch.cuda.synchronize()
        r_launches = read_launches()
        widths = {k: (v.shape[-1] if v.dim() == 3 else 1) for k, v in out.features.items()}
        require(sum(widths.values()) == 49 and widths["dino_attribute"] == WIDE_DINO, f"render widths {widths}")
        require(r_launches == {k: int(k in ("blend_forward", "expand_intersections")) for k in r_launches},
                f"render launch counts {r_launches}")
        require(all(torch.isfinite(v).all().item() for v in out.features.values()), "the C = 49 frame")
        covered = (out.final_T < 0.5).float().mean().item()
        require(covered > 0.01, f"the C = 49 frame covers {covered:.3%}")
        frame_ms = wall_ms(lambda: inference.render_frame(scene, TRAIN_T1, cam.extrinsic, rcfg, EXTRA, device=DEVICE),
                           reps=5)
    log("wide", f"render_frame at t={TRAIN_T1} with {', '.join(EXTRA)}: C=49 ({widths}), finite, "
                f"{covered:.1%} covered, launches {r_launches}; {frame_ms:.3f} ms/frame wall {card}")

    # ---- each wide instance against its plain version: first K1 at C = 49
    # on the render's own projection, then the training frame's ----
    with torch.no_grad():
        r_inp, r_extra = inference._scene_inputs(scene, TRAIN_T1, EXTRA)
        pr_r = rasterize.project_gaussians(r_inp["position"], r_inp["scaling"], r_inp["rotation"],
                                           r_inp["opacity"], r_inp["shs"], extr, rcfg, extra_features=r_extra)
        Cr = sum(v.shape[1] for v, _, _ in pr_r.feature_groups.values())
        require(Cr == 49, f"the render's projection carries {Cr} channels, expected 49")
        rows = blend_instance("wide render", pr_r, rcfg, cpm, args.seed + 14, card, backward=False, plain_reps=0)
        del pr_r, r_inp, r_extra
        for pr, rc in wide_blends(scene, tcfg, extr, args.seed + 13):
            big = rc.block[0] * rc.block[1] > 1024
            rows = merge_rows(rows, blend_instance("wide", pr, rc, cpm, args.seed + 14, card, plain_reps=0, splat=big))
            del pr
    torch.cuda.empty_cache()

    # ---- the 64x48 training render at C = 52, card against CPU ----
    small = small_train_scene(args.seed, dino=WIDE_DINO)
    (g_gpu, f_gpu), (g_cpu, f_cpu) = (render_grads(small, d, args.seed, EXTRA) for d in (dev, "cpu"))
    Cs = sum(v.shape[-1] if v.dim() == 3 else 1 for v in f_cpu.values())
    d_img = max((f_gpu[k] - f_cpu[k]).abs().max().item() for k in f_cpu)
    worst = max(((g_gpu[k] - g_cpu[k]).abs() / (GRAD_ATOL + GRAD_RTOL * g_cpu[k].abs())).max().item()
                for k in g_cpu)
    require(Cs == 52, f"the 64x48 wide render carries {Cs} channels")
    require(all(torch.isfinite(v).all().item() for v in g_gpu.values()), "64x48 C = 52 gradients not finite")
    require(d_img <= ATOL and worst <= 1.0, f"64x48 C = 52: render {d_img:.3g}, gradients {worst:.3g} of the bar")
    log("wide", f"64x48 training render at C={Cs}: card vs CPU render max |diff| {d_img:.3g} (atol {ATOL}); "
                f"{len(g_cpu)} gradients worst |diff| / (atol {GRAD_ATOL} + rtol {GRAD_RTOL} |cpu|) = {worst:.3g}")
    return rows, launches


def load_example(name: str, folder: str = "examples"):
    """The tutorial `examples/<name>.py` (or `<folder>/<name>.py`) of this
    checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet():
    """Silences a tutorial's per-iteration prints (the checks print their own lines)."""
    import contextlib
    import io

    return contextlib.redirect_stdout(io.StringIO())


def gs_2d_check(args, card: str, cpm: float):
    """Phase 24, gs_2d at its defaults: TUT_POINTS Gaussians at TUT_SIZE^2,
    every one at depth 1.0, so each tile blends ties alone. Step 0's render
    and five gradients on the card against the CPU; K1-K4 at the blend of
    step 0 and of the end `torch.equal` to their plain versions; the fit of
    TUT_ITERS iterations (launch counts, depth still exactly 1.0, PSNR up),
    ms per iteration and busy share; two card fits of TUT_REPEAT_ITERS
    `torch.equal`, their first TUT_LOSS_ITERS losses against a CPU fit.
    Returns (kernel instances, the fit's launch counts)."""
    import torch

    from splatter_a_video_tpu_torch.ops import rasterize
    from splatter_a_video_tpu_torch.train import optim, prng

    g2 = load_example("torch_gs_2d")
    target = g2.make_target(TUT_SIZE)
    cfg = rasterize.RasterizeConfig(width=TUT_SIZE, height=TUT_SIZE, max_intersections=TUT_MAX_INTERSECTIONS)

    def inputs(d):
        return (g2.init_params(prng.key(args.seed), TUT_POINTS, d), torch.eye(3, 4, device=d),
                torch.as_tensor(target, device=d))

    def fit(iters, log_every, device=DEVICE):
        with quiet():
            return g2.fit(target, TUT_POINTS, iters, TUT_LR, seed=args.seed, log_every=log_every,
                          max_intersections=TUT_MAX_INTERSECTIONS, device=device)

    # ---- step 0: the render and the five gradients, card against CPU ----
    (p0, extr, gt), (p0_cpu, extr_cpu, gt_cpu) = inputs(DEVICE), inputs("cpu")
    _, img_g, grads_g = g2.loss_and_grads(p0, cfg, extr, gt)
    _, img_c, grads_c = g2.loss_and_grads(p0_cpu, cfg, extr_cpu, gt_cpu)
    d_img = (img_g.cpu() - img_c).abs().max().item()
    worst = max(((grads_g[k].cpu() - grads_c[k]).abs() / (GRAD_ATOL + GRAD_RTOL * grads_c[k].abs())).max().item()
                for k in grads_c)
    require(d_img <= ATOL and worst <= 1.0, f"gs_2d step 0: render {d_img:.3g}, gradients {worst:.3g} of the bar")
    with torch.no_grad():
        pr = g2.project_2d(p0, cfg, extr)
    depths = torch.unique(pr.depth[pr.radius > 0]).tolist()
    require(depths == [1.0], f"gs_2d: visible depths {depths[:4]}, expected only 1.0")
    log("tutorials", f"gs_2d step 0 at {TUT_SIZE}x{TUT_SIZE}, {TUT_POINTS} points (JAX's draws, seed {args.seed}; "
                     f"{int((pr.radius > 0).sum())} visible, all at depth 1.0): card vs CPU render max |diff| "
                     f"{d_img:.3g} (atol {ATOL}); 5 gradients worst |diff| / (atol {GRAD_ATOL} + rtol {GRAD_RTOL} "
                     f"|cpu|) = {worst:.3g}")
    rows = merge_rows(blend_instance("gs_2d step 0", pr, cfg, cpm, args.seed + 15, card, plain_reps=0),
                      k2_instance("gs_2d step 0", pr, cfg, cpm, card))
    del pr, grads_g, img_g

    # ---- the fit at its defaults ----
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params, img, hist = fit(TUT_ITERS, TUT_LOG_EVERY)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    renders = TUT_ITERS + len(hist) + 1    # a blend a step, a PSNR render a log line, the final image
    want = {"blend_forward": renders, "expand_intersections": renders, "blend_backward": TUT_ITERS,
            "reduce_gaussians": TUT_ITERS}
    require(launches == want, f"gs_2d fit launch counts {launches}, expected {want}")
    require(all(bool(torch.isfinite(v).all()) for v in params.values()) and bool(torch.isfinite(img).all()),
            "gs_2d fit not finite")
    require(bool((params["xyz"][:, 2] == 1.0).all()), "gs_2d: a depth left 1.0 during the fit")
    require(hist[-1][2] > hist[0][2], f"gs_2d: PSNR {hist[0][2]:.3f} -> {hist[-1][2]:.3f} did not rise")
    with torch.no_grad():
        pr = g2.project_2d(params, cfg, extr)
    rows = merge_rows(rows, blend_instance("gs_2d end", pr, cfg, cpm, args.seed + 16, card, plain_reps=0),
                      k2_instance("gs_2d end", pr, cfg, cpm, card))
    del pr
    state, lr = optim.adam_init(params), torch.tensor(TUT_LR)
    it = lambda: g2.step(params, state, cfg, extr, gt, lr)
    it_ms = wall_ms(it)
    log("tutorials", f"gs_2d fit, {TUT_ITERS} iterations (cut from the tutorial's 2,000) at lr {TUT_LR}: l1 "
                     f"{hist[0][1]:.5f} -> {hist[-1][1]:.5f}, PSNR {hist[0][2]:.4f} (iteration 0) -> "
                     f"{hist[-1][2]:.4f} (iteration {hist[-1][0]}); every xyz[:, 2] still exactly 1.0; {fit_s:.2f} s, "
                     f"{fit_s * 1e3 / TUT_ITERS:.3f} ms/iteration with the {len(hist)} PSNR renders; one iteration "
                     f"alone {it_ms:.3f} ms (wall); launches {launches} {card}")
    log("tutorials", busy_line("gs_2d iteration", it, 5, 1, it_ms, card))

    # ---- two card fits torch.equal; their first losses against the CPU ----
    runs = [fit(TUT_REPEAT_ITERS, 1) for _ in range(2)]
    t0 = time.perf_counter()
    on_cpu = fit(TUT_LOSS_ITERS, 1, device="cpu")
    cpu_s = time.perf_counter() - t0
    (pa, ia, ha), (pb, ib, hb) = runs
    same = all(torch.equal(pa[k], pb[k]) for k in pa) and torch.equal(ia, ib) and ha == hb
    require(same, "gs_2d: two card fits differ")
    rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(ha, on_cpu[2]))
    require(rel <= TUT_LOSS_RTOL, f"gs_2d: the first {TUT_LOSS_ITERS} losses card vs CPU rel {rel:.3g}")
    log("tutorials", f"gs_2d: two card fits of {TUT_REPEAT_ITERS} iterations torch.equal (parameters, image, every "
                     f"loss and PSNR): {same}; their first {TUT_LOSS_ITERS} losses against a CPU fit: max rel diff "
                     f"{rel:.3g} (rtol {TUT_LOSS_RTOL}; CPU {cpu_s:.1f} s)")
    return rows, launches


def orbit_inputs(g3, f: int, points: int, frames: int, size: int, dev) -> dict:
    """`render_iter`'s arguments for view f of the tutorial's orbit
    (`torch_gs_3d.render_orbit`: the rotations of views 0..f drawn in turn)."""
    import math

    import torch

    from splatter_a_video_tpu_torch.ops.quaternion import quat_normalize

    pos, col = g3.make_torus(points)
    rng = np.random.RandomState(1)
    for _ in range(f + 1):
        rot = rng.randn(points, 4).astype(np.float32)
    return dict(FovX=g3.FOV, FovY=g3.FOV, height=size, width=size,
                world_view_transform=torch.from_numpy(g3.orbit_world_view(2 * math.pi * f / frames)).to(dev),
                full_proj_transform=None, camera_center=torch.zeros(3, device=dev),
                position=torch.from_numpy(pos).to(dev), opacity=torch.full((points,), 0.8, device=dev),
                scaling=torch.full((points, 3), 0.02, device=dev),
                rotation=quat_normalize(torch.from_numpy(rot).to(dev)),
                shs=torch.from_numpy(g3.colors_to_shs(col)).to(dev))


def orbit_views_on_cpu(job):
    """(rgb, radii) as numpy of the orbit views `job[0]` rendered on the CPU,
    in a worker process of `gs_3d_check`'s pool; job = (views, points,
    frames, size)."""
    import torch

    from splatter_a_video_tpu_torch.models import legacy_render

    views, points, frames, size = job
    torch.set_num_threads(ORBIT_CPU_THREADS)
    g3 = load_example("torch_gs_3d")
    render = legacy_render.GaussianSplattingRender()
    out = []
    with torch.no_grad():
        for f in views:
            o = render.render_iter(**orbit_inputs(g3, f, points, frames, size, "cpu"))
            out.append((o["rgb"].numpy(), o["radii"].numpy()))
    return out


def gs_3d_check(args, dev, card: str, cpm: float):
    """Phase 24, gs_3d at its defaults: ORBIT_FRAMES views of an
    ORBIT_POINTS torus at ORBIT_SIZE^2 through `render_iter` (perspective,
    rgb and depth: C = 4), each frame against the CPU (rgb atol ATOL, radii
    equal; the CPU frames in ORBIT_CPU_WORKERS processes), K1 and K2 on the
    first view `torch.equal` to their plain versions, and the tutorial's own
    asserts. Returns (kernel instances, the orbit's launch counts)."""
    import multiprocessing

    import torch

    from splatter_a_video_tpu_torch.ops import rasterize

    P, F, S = ORBIT_POINTS, ORBIT_FRAMES, ORBIT_SIZE
    g3 = load_example("torch_gs_3d")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = g3.render_orbit(P, F, S, DEVICE)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / F
    launches = read_launches()
    want = {"blend_forward": F, "expand_intersections": F, "blend_backward": 0, "reduce_gaussians": 0}
    require(launches == want, f"gs_3d launch counts {launches}, expected {want}")
    t0 = time.perf_counter()
    jobs = [(list(range(F))[w::ORBIT_CPU_WORKERS], P, F, S) for w in range(ORBIT_CPU_WORKERS)]
    with multiprocessing.get_context("spawn").Pool(ORBIT_CPU_WORKERS) as pool:
        parts = pool.map(orbit_views_on_cpu, jobs)
    on_cpu = {f: r for (views, *_), part in zip(jobs, parts) for f, r in zip(views, part)}
    cpu_s = time.perf_counter() - t0
    err = max(np.abs(outs[f]["rgb"].cpu().numpy() - on_cpu[f][0]).max() for f in range(F))
    radii = all(np.array_equal(outs[f]["radii"].cpu().numpy(), on_cpu[f][1]) for f in range(F))
    require(err <= ATOL and radii, f"gs_3d card vs CPU: rgb {err:.3g}, radii equal {radii}")
    visible = [int(o["visibility"].sum()) for o in outs]
    with torch.no_grad():
        kw = orbit_inputs(g3, 0, P, F, S, dev)
        rc = rasterize.RasterizeConfig(width=S, height=S, ortho=False, sh_degree=0)
        f = S / (2.0 * np.tan(g3.FOV / 2.0))
        intr = torch.tensor([f, f, S / 2.0, S / 2.0], dtype=torch.float32, device=dev)
        pr = rasterize.project_gaussians(kw["position"], kw["scaling"], kw["rotation"], kw["opacity"], kw["shs"],
                                         kw["world_view_transform"].T[:3, :4], rc, intr, None, 1.0, False)
        require(torch.equal(rasterize.rasterize(*pr, rc).features["rgb"], outs[0]["rgb"]),
                "gs_3d: the first view's projection does not give render_iter's frame")
        rows = merge_rows(blend_instance("gs_3d view 0", pr, rc, cpm, args.seed + 17, card, backward=False,
                                         plain_reps=0),
                          k2_instance("gs_3d view 0", pr, rc, cpm, card))
    del pr, outs
    with quiet():
        g3.main(["--points", str(P), "--frames", str(F), "--size", str(S), "--out", "", "--device", DEVICE])
    log("tutorials", f"gs_3d: {F} orbit views of a {P}-point torus at {S}x{S} (render_iter, perspective, C = 4), "
                     f"visible {min(visible)}-{max(visible)}; card vs CPU rgb max |diff| {err:.3g} (atol {ATOL}), "
                     f"radii equal in every view (CPU {cpu_s:.1f} s in {ORBIT_CPU_WORKERS} processes of "
                     f"{ORBIT_CPU_THREADS} threads); {frame_ms:.3f} ms/frame (wall, with the host's inputs); launches "
                     f"{launches}; the tutorial's two asserts pass {card}")
    return rows, launches


def converter_check(args, card: str) -> None:
    """Phase 24: `scripts/torch_convert_tapir.py` on this machine, without
    JAX: a random TAPIR state dict in the reference's layout (the default
    widths), converted in a subprocess, loaded through `nets.tapir.get_model`
    with SPLAT_TAPIR_WEIGHTS set, and one chunk of queries over
    TAPIR_CHECK_FRAMES frames on the card against the CPU at phase 21's
    bars."""
    import tempfile

    import torch

    from splatter_a_video_tpu_torch.nets import tapir

    tcfg = tapir.TapirConfig()
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_convert_tapir.py")
    saved = os.environ.get("SPLAT_TAPIR_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, npz = os.path.join(tmp, "tapir.pt"), os.path.join(tmp, "tapir.npz")
        sd = tapir.random_state_dict(tcfg, NETS_SEED)
        torch.save(sd, ckpt)
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, script, "--ckpt", ckpt, "--out", npz], capture_output=True, text=True)
        conv_s = time.perf_counter() - t0
        require(done.returncode == 0, f"torch_convert_tapir.py failed: {done.stderr[-2000:]}")
        os.environ["SPLAT_TAPIR_WEIGHTS"] = npz
        try:
            tm, tm_cpu = (tapir.get_model(tcfg, device=d) for d in (DEVICE, "cpu"))
        finally:
            if saved is None:
                os.environ.pop("SPLAT_TAPIR_WEIGHTS")
            else:
                os.environ["SPLAT_TAPIR_WEIGHTS"] = saved
    require(tm is not None and tm.pretrained and tm_cpu is not None, "get_model did not load the converted weights")
    res = tcfg.initial_resolution
    yy, xx = np.mgrid[0:res[0], 0:res[1]] / np.array(res, np.float64)[:, None, None]
    video = np.stack([np.clip(0.5 + 0.4 * np.sin(2 * np.pi * (3 * (xx + 0.02 * t) + 2 * yy)[..., None]
                                               + np.array([0.0, 2.0, 4.0])), 0, 1)
                      for t in range(TAPIR_CHECK_FRAMES)])
    video = (video * 255).astype(np.uint8)
    rng = np.random.RandomState(args.seed + 18)
    qp = np.stack([rng.randint(0, TAPIR_CHECK_FRAMES, TAPIR_CHUNK), rng.uniform(0, res[0] - 1, TAPIR_CHUNK),
                   rng.uniform(0, res[1] - 1, TAPIR_CHUNK)], 1).astype(np.float32)
    g = tapir.track_points(tm, video, qp, chunk=TAPIR_CHUNK)
    c = tapir.track_points(tm_cpu, video, qp, chunk=TAPIR_CHUNK)
    errs = {k: float(np.abs(g[k] - c[k]).max()) for k in c}
    require(all(np.isfinite(v).all() for v in g.values()), "converted TAPIR on the card: not finite")
    require(all(np.allclose(g[k], c[k], atol=TAPIR_ATOL, rtol=TAPIR_RTOL) for k in c),
            f"converted TAPIR card vs CPU: {errs}")
    log("tutorials", f"scripts/torch_convert_tapir.py on a random {len(sd)}-tensor TAPIR state dict (reference "
                     f"layout, default widths, seed {NETS_SEED}) in {conv_s:.1f} s, loaded by nets.tapir.get_model "
                     f"through SPLAT_TAPIR_WEIGHTS; {TAPIR_CHECK_FRAMES} frames at {res[0]}x{res[1]}, "
                     f"{TAPIR_CHUNK} queries, card vs CPU max |diff| "
                     + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                     + f" (bars atol {TAPIR_ATOL}, rtol {TAPIR_RTOL}); scripts/torch_convert_depth_anything.py is "
                       f"not run here: its test checkpoint comes from transformers, which this machine lacks (the "
                       f"CPU tests hold it) {card}")


def tutorials_phase(args, dev, card: str, cpm: float):
    """Phase 24: the tutorials and the TAPIR converter (`gs_2d_check`,
    `gs_3d_check`, `converter_check`). Returns (kernel instances, the gs_2d
    fit's launch counts, the gs_3d orbit's)."""
    t0 = time.perf_counter()
    rows2, fit_launches = gs_2d_check(args, card, cpm)
    rows3, orbit_launches = gs_3d_check(args, dev, card, cpm)
    converter_check(args, card)
    log("tutorials", f"phase 24 in {time.perf_counter() - t0:.1f} s")
    return merge_rows(rows2, rows3), fit_launches, orbit_launches


def jax_record_keys() -> list:
    """The keys of the record `scripts/e2e_480p.py` builds (its module-level
    `out = {...}`), read with ast: the JAX script is not imported."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "e2e_480p.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise RuntimeError(f"no record dict in {path}")


def density_card_check(state, dcfg, seed: int) -> None:
    """One density event on a fitted production state, on the card and on
    the CPU from the same tensors: statistics drawn from `seed` as a few
    hundred (sum, visit count) pairs, four times larger for Gaussians past
    the clone / split boundary, so that `grads` ties exactly, splits are
    placed and the growth budget binds. Every count, mask,
    parameter and moment `torch.equal`; the split children's positions
    within 1e-6 (their offsets' exp and products round otherwise on the
    card, as in XLA's CPU code: `tests/test_torch_density_production.py`)."""
    import torch

    from splatter_a_video_tpu_torch.train import density, optim, prng

    rng = np.random.RandomState(seed)
    sc = state.scene
    cap = sc.cfg.capacity
    pool_d = rng.randint(1, 60, 300).astype(np.float32)
    pool_g = np.exp(rng.normal(np.log(4e-5), 1.0, 300)).astype(np.float32)
    pick = rng.randint(0, 300, cap)
    denom = pool_d[pick]
    # large Gaussians collect larger gradients, as in a fit: both classes are hot
    big = torch.exp(sc.params["scaling"]).max(-1).values.cpu().numpy() > dcfg.percent_dense * dcfg.cameras_extent
    stats = [np.zeros(cap, np.float32), (pool_g[pick] * denom * np.where(big, 4, 1)).astype(np.float32), denom]
    key = prng.key(seed)
    out = []
    for dev in (sc.alive.device, torch.device("cpu")):
        scene = dataclasses.replace(sc, params={k: v.detach().to(dev) for k, v in sc.params.items()},
                                    aux={k: v.to(dev) for k, v in sc.aux.items()})
        opt = optim.AdamState(state.opt_state.count, {k: v.to(dev) for k, v in state.opt_state.mu.items()},
                              {k: v.to(dev) for k, v in state.opt_state.nu.items()})
        ds = density.DensifyState(*(torch.from_numpy(a).to(dev) for a in stats))
        t0 = time.perf_counter()
        res = density.densify_and_prune(scene, opt, ds, state.step, dcfg, key=key)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append((res, time.perf_counter() - t0))
    ((gs, go, _, gi), g_s), ((cs, co, _, ci), c_s) = out
    info = {f: int(getattr(ci, f)) for f in density.DensifyInfo._fields}
    require({f: int(getattr(gi, f)) for f in density.DensifyInfo._fields} == info,
            f"density on the card {gi} != on the CPU {ci}")
    alive0 = sc.alive.cpu()
    require(torch.equal(gs.alive.cpu(), cs.alive), "density: alive masks differ between the card and the CPU")
    kids = ~alive0 & cs.alive
    require(info["num_split"] > 0 and info["dropped"] > 0, f"density: splits placed under a binding budget {info}")
    for k, v in cs.params.items():
        g = gs.params[k].cpu()
        if k == "position":
            same = torch.equal(g[~kids], v[~kids]) and float((g[kids] - v[kids]).abs().max()) <= 1e-6
        else:
            same = torch.equal(g, v)
        require(same, f"density: {k} differs between the card and the CPU")
    for kind in ("mu", "nu"):
        for k, v in getattr(co, kind).items():
            require(torch.equal(getattr(go, kind)[k].cpu(), v), f"density: {kind}[{k}] differs")
    pos_err = float((gs.params["position"].cpu()[kids] - cs.params["position"][kids]).abs().max())
    log("e2e", f"density event on the fitted state ({int(alive0.sum())} alive of {cap}, seeded statistics with "
               f"ties): card == CPU, info {info}, children {int(kids.sum())}, split children's positions max "
               f"|card - CPU| {pos_err:.3g}; {g_s * 1e3:.1f} ms on the card, {c_s * 1e3:.1f} ms on the CPU")


def e2e_phase(args, dev, card: str, cpm: float):
    """Phase 25: the production harness. `scripts/torch_e2e_480p.py` fits
    the flagship clip (E2E_ENV, cut by E2E_CUTS) and evaluates it through
    its own entry points; K1-K4 on the fitted scene's frame 0 (the training
    blend, C = 7, and the eval render, C = 4) `torch.equal` to their plain
    versions; then `scripts/torch_capability_480p.py` on the scene the fit
    saved. Outputs go to a temporary directory, never into the checkout.
    Returns (kernel instances, the harness's launches, the capability's)."""
    import contextlib
    import io
    import tempfile

    import torch

    from splatter_a_video_tpu_torch import inference
    from splatter_a_video_tpu_torch.eval import metrics
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import rasterize
    from splatter_a_video_tpu_torch.train import hooks, trainer

    t_phase = time.perf_counter()
    e2e, cap = load_example("torch_e2e_480p", "scripts"), load_example("torch_capability_480p", "scripts")
    s = e2e.read_env(E2E_ENV)
    fcfg, tcfg = e2e.fit_configs(s)
    events = [st for st in range(1, s.steps + 1) if trainer.should_densify(tcfg, st)]
    require(len(events) == E2E_EVENTS, f"the schedule puts {events} in {s.steps} steps")

    class FirstScene(hooks.Hook):
        """The scene step 1 starts from."""

        def before_train(self, ctx):
            sc = ctx.state.scene
            self.scene = dataclasses.replace(sc, params={k: v.detach().clone() for k, v in sc.params.items()},
                                             aux={k: v.clone() for k, v in sc.aux.items()})

    first = FirstScene()
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            record, state, hist, clip = e2e.run(s, device=DEVICE, hooks=[first], write=True, root=tmp)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = read_launches()
        for line in out.getvalue().splitlines():
            if not line.startswith(("step ", "{")):
                log("e2e", line)
        T, sub = s.frames, len(range(0, s.frames, max(s.frames // 6, 1)))
        renders = s.steps + T + sub + 2 * T   # the steps, render_video, the audit, the tracking eval (2 a frame)
        want = {"blend_forward": renders, "expand_intersections": renders, "blend_backward": s.steps,
                "reduce_gaussians": s.steps}
        require(launches == want, f"harness launch counts {launches}, expected {want}")
        for m in hist:
            vals = [v for v in m.values() if isinstance(v, (int, float))]
            require(all(np.isfinite(v) for v in vals), f"step {m['step']}: metrics not finite {m}")
        require(not record["eval_num_intersections"]["overflow"], f"eval overflow {record['eval_num_intersections']}")
        require(list(record) == jax_record_keys(), f"record keys {list(record)} != {jax_record_keys()}")
        cam = camera.canonical_camera(s.width, s.height)
        rcfg = rasterize.RasterizeConfig(width=s.width, height=s.height, max_intersections=s.maxi)
        res0 = inference.render_video(first.scene, cam, rcfg, list(range(T)), device=DEVICE)
        psnr0 = float(np.mean([metrics.psnr(res0["rgb"][t], clip.frames[t]) for t in range(T)]))
        del first.scene, res0
        require(record["recon"]["psnr"] > psnr0, f"recon PSNR {record['recon']['psnr']} <= {psnr0:.2f} at step 1")
        dt = record["densify_totals"] or {}
        require(dt.get("events", 0) == len(events) and "stopped_at_step" not in dt, f"density totals {dt}")
        timing = record["timing"]
        log("e2e", f"torch_e2e_480p with {E2E_ENV}: {s.width}x{s.height}, {T} frames, track_grid {s.grid}, "
                   f"{record['scale']['init_points']} points in {record['scale']['capacity']} slots, budget "
                   f"{s.maxi}; cuts: {E2E_CUTS}; {e2e_s:.1f} s: clip {timing['clip_s']} s, setup "
                   f"{timing['setup_s']} s (lifting {timing['lift_s']}), steady {timing['steady_ms']} ms/step, "
                   f"evaluation {timing['eval']}, host peak RSS {timing['host_peak_rss_gib']} GiB; launches "
                   f"{launches} {card}")
        log("e2e", f"recon PSNR {record['recon']['psnr']} (the scene step 1 starts from: {psnr0:.2f}), SSIM "
                   f"{record['recon']['ssim']}, LPIPS {record['recon']['lpips_fallback']} (pretrained "
                   f"{record['recon']['lpips_is_pretrained']}); AJ {record['tapvid']['average_jaccard']}, OA "
                   f"{record['tapvid']['occlusion_accuracy']}; alive {record['scale']['init_points']} -> "
                   f"{record['final_alive']}, density totals {dt}; eval intersections "
                   f"{record['eval_num_intersections']}; {len(hist)} logged steps finite; record keys == "
                   f"scripts/e2e_480p.py's")
        fired = hist[-1]["densify_events"]
        require([ev["step"] for ev in fired] == events, f"density events at {fired}, expected {events}")
        for ev in fired:
            log("e2e", f"density event at step {ev['step']}: cloned {ev['num_cloned']}, split {ev['num_split']}, "
                       f"pruned {ev['num_pruned']}, dropped {ev['dropped']}, alive {ev['num_alive']}")

        # K1-K4 on the fitted scene's frame 0: the first blend after production-schedule density events
        scene = state.scene
        extr = torch.as_tensor(cam.extrinsic, device=dev)
        with torch.no_grad():
            rc = tcfg.raster_cfg()
            pr = trainer.project_for_training(trainer.scene_render_inputs(scene, 0), extr, rc,
                                              {"track_gs": scene.get_position(1)}, True, 0.0, tcfg.depth_bg)
            rows = blend_instance("e2e training frame 0", pr, rc, cpm, args.seed + 25, card)
            del pr
            inp, _ = inference._scene_inputs(scene, 0.0, ())
            pe = rasterize.project_gaussians(inp["position"], inp["scaling"], inp["rotation"], inp["opacity"],
                                             inp["shs"], extr, rcfg)
            rows = merge_rows(rows, blend_instance("e2e eval frame 0", pe, rcfg, cpm, args.seed + 25, card,
                                                   backward=False),
                              k2_instance("e2e eval frame 0", pe, rcfg, cpm, card))
            del pe
        density_card_check(state, tcfg.densify, args.seed + 25)
        del state, scene, clip

        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            report = cap.run(device=DEVICE, scene_path=e2e.scene_path(s, tmp), outdir=os.path.join(tmp, "capability"),
                             report_path=None, sizes=CAP_SIZES)
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        cap_launches = read_launches()
    for name in ("tracking", "edit", "interp", "layers"):
        require(name in report, f"capability section {name} missing")
    numbers = [v for sec in ("tracking", "edit", "interp", "layers") for v in report[sec].values()]
    numbers += [report["recon_psnr_f0"], *report["timings_s"].values()]
    require(all(np.isfinite(v) for v in numbers), f"capability numbers not finite: {report}")
    require({"nvs", "stereo"} <= set(report["timings_s"]), f"capability sections run: {report['timings_s']}")
    log("capability", f"torch_capability_480p on the fitted scene ({'full sizes and step counts' if CAP_SIZES is None else CAP_SIZES}): "
                      f"{cap_s:.1f} s; frame-0 PSNR {report['recon_psnr_f0']}; tracking {report['tracking']}; "
                      f"edit {report['edit']}; interp {report['interp']}; layers {report['layers']}; seconds "
                      f"{report['timings_s']}; launches {cap_launches} {card}")
    log("e2e", f"phase 25 in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, cap_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"
    dev = torch.device(DEVICE)
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from splatter_a_video_tpu_torch import convert, inference
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import _build, binning, rasterize
    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg
    from splatter_a_video_tpu_torch.ops import rasterize_ref
    from splatter_a_video_tpu_torch.ops.projection import tile_grid

    # ---- 2. build ---------------------------------------------------------
    secs = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    log("build", f"{', '.join(_build.KERNELS)} built and loaded in {secs:.1f} s")

    # ---- 3. flagship scene ------------------------------------------------
    t0 = time.perf_counter()
    scene = convert.scene_from_numpy(*flagship_scene_arrays(args.seed), device=DEVICE)
    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS)
    log("scene", f"capacity {CAPACITY}, alive {int(scene.num_alive)}, cubic_spline over "
                 f"{FRAMES} frames, made in {time.perf_counter() - t0:.1f} s")

    def project(t, cfg):
        inp, extra = inference._scene_inputs(scene, t, EXTRA)
        return rasterize.project_gaussians(
            inp["position"], inp["scaling"], inp["rotation"], inp["opacity"], inp["shs"],
            torch.as_tensor(cam.extrinsic, device=dev), cfg, extra_features=extra,
        )

    def blend_inputs(pr):
        feats = torch.cat([v for v, _, _ in pr.feature_groups.values()], dim=1).contiguous()
        bg = torch.tensor(
            [b for v, b, _ in pr.feature_groups.values() for _ in range(v.shape[1])],
            dtype=torch.float32, device=dev,
        )
        return pr.uv, pr.conic, pr.opacity, feats, bg

    # ---- 4. K2 against its plain version ------------------------------------
    with torch.no_grad():
        pr = project(0.0, rcfg)
        tiles = pr.tiles.clamp_max(rcfg.max_tiles_per_gaussian).contiguous()
        offs = (torch.cumsum(tiles, 0, dtype=torch.int32) - tiles).contiguous()
        tgx, tgy = tile_grid(W, H, rcfg.block)
        k2_args = (offs, tiles, pr.rect_min.contiguous(), pr.rect_max.contiguous(),
                   pr.depth.contiguous(), MAX_INTERSECTIONS, tgx)
        keys, sgid = rg.expand_intersections(*k2_args)
        keys_p, sgid_p = rg.expand_intersections_plain(*k2_args)
        torch.cuda.synchronize()
        require(torch.equal(keys, keys_p) and torch.equal(sgid, sgid_p), "K2 keys/gid differ from plain")
        b = binning.bin_intersections(pr.depth, pr.tiles, pr.rect_min, pr.rect_max, W, H,
                                      MAX_INTERSECTIONS, rcfg.max_tiles_per_gaussian, rcfg.block)
        sk, order = torch.sort(keys_p, stable=True)
        gid_p = sgid_p[order]
        edges_p = torch.searchsorted(
            sk, torch.arange(tgx * tgy + 1, dtype=torch.int64, device=dev) << 32).to(torch.int32)
        nint = int(b.num_intersections)
        require(torch.equal(b.gid, gid_p) and torch.equal(b.edges, edges_p), "binning differs from plain")
        require(nint == int(tiles.sum()), "num_intersections is not the true count")
        require(nint <= MAX_INTERSECTIONS, f"frame 0 saturated: {nint} > {MAX_INTERSECTIONS}")
        log("K2", f"expand_intersections == plain: keys, gid, sorted gid, edges equal; "
                  f"{nint} intersections of {MAX_INTERSECTIONS}")
        k2_sat = k2_args[:5] + (SATURATED, tgx)
        keys_s, sgid_s = rg.expand_intersections(*k2_sat)
        keys_sp, sgid_sp = rg.expand_intersections_plain(*k2_sat)
        torch.cuda.synchronize()
        require(nint > SATURATED, f"frame 0 does not saturate {SATURATED}: {nint} intersections")
        require(torch.equal(keys_s, keys_sp) and torch.equal(sgid_s, sgid_sp),
                "K2 at the saturated budget differs from plain")
        g_end = int(sgid_s[-1])
        end_j, end_n = SATURATED - 1 - int(offs[g_end]), int(tiles[g_end])
        log("K2", f"saturated budget M = {SATURATED} < {nint}: keys, gid equal to plain; the last slot "
                  f"is slot {end_j} of Gaussian {g_end}'s {end_n}")

        # ---- 5. K1 against its plain version --------------------------------
        uv, conic, opac, feats, bg = blend_inputs(pr)
        C = feats.shape[1]
        require(C == 20, f"flagship blend carries {C} channels, expected 20")

        def k1_check(tag, bb, tile, K=0, bias=None, fb=None):
            f, g = (feats, bg) if fb is None else fb
            out = rg.blend_forward(bb.gid, bb.edges, uv, conic, opac, f, g, W, H, tile, K, bias)
            ref = rg.blend_forward_plain(bb.gid, bb.edges, uv, conic, opac, f, g, W, H, tile, K, bias)
            torch.cuda.synchronize()
            err = max((out[0] - ref[0]).abs().max().item(), (out[1] - ref[1]).abs().max().item())
            bad_nc = int((out[2] != ref[2]).sum())
            bad_gs = int((out[3] != ref[3]).sum())
            same = all(torch.equal(a, r) for a, r in zip(out, ref))
            log("K1", f"{tag}: image/final_T max abs diff {err:.3g}, ncontrib mismatches {bad_nc}, "
                      f"gs_idx mismatches {bad_gs}; torch.equal on all four outputs: {same}")
            require(same, f"K1 {tag} differs from plain")
            require(torch.isfinite(out[0]).all().item(), f"K1 {tag} not finite")
            return err, out

        k1_err, k1_out = k1_check("16x16 C=20", b, (16, 16))
        k1_check("16x16 K_idx=8", b, (16, 16), K=8)
        bias = torch.from_numpy(
            np.random.RandomState(args.seed + 1).uniform(0.0, 0.1, CAPACITY).astype(np.float32)).to(dev)
        k1_check("16x16 opacity_bias", b, (16, 16), bias=bias)
        k1_check(f"16x16 C={WIDE_C}", b, (16, 16), fb=widen(feats, bg, args.seed + 5))
        rcfg32 = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAX_INTERSECTIONS,
                                           block_x=32, block_y=16)
        pr32 = project(0.0, rcfg32)
        b32 = binning.bin_intersections(pr32.depth, pr32.tiles, pr32.rect_min, pr32.rect_max, W, H,
                                        MAX_INTERSECTIONS, rcfg32.max_tiles_per_gaussian, rcfg32.block)
        uv, conic, opac, feats, bg = blend_inputs(pr32)
        k1_check("32x16 C=20", b32, (32, 16))
        uv, conic, opac, feats, bg = blend_inputs(pr)

        # ---- 6. main path -----------------------------------------------------
        pre = [inference.render_frame(scene, t, cam.extrinsic, rcfg, EXTRA, device=DEVICE) for t in TIMES]
        for t, o in zip(TIMES, pre):
            n_t = int(o.num_intersections)
            require(n_t <= MAX_INTERSECTIONS, f"t={t} saturated: {n_t} > {MAX_INTERSECTIONS}")
            covered = (o.final_T < 0.5).float().mean().item()
            require(covered > 0.01, f"t={t}: only {covered:.3%} of pixels covered")
        for k in rg.LAUNCHES:
            rg.LAUNCHES[k] = 0
        video = inference.render_video(scene, cam, rcfg, TIMES, extra_names=EXTRA, device=DEVICE)
        launches = dict(rg.LAUNCHES)
        forward_only = {k: (len(TIMES) if k in ("blend_forward", "expand_intersections") else 0)
                        for k in launches}   # rendering takes no gradient
        require(launches == forward_only, f"launch counts {launches}")
        shapes = {"rgb": (5, H, W, 3), "depth": (5, H, W), "mask_attribute": (5, H, W, 1),
                  "pos_poly_feat": (5, H, W, 12), "dino_attribute": (5, H, W, 3)}
        for k, shape in shapes.items():
            require(video[k].shape == shape, f"{k} shape {video[k].shape} != {shape}")
            require(np.isfinite(video[k]).all(), f"{k} not finite")
        require(video["rgb"].min() >= 0.0 and video["rgb"].max() <= 1.0, "rgb outside [0, 1]")
        for i, o in enumerate(pre):
            require(np.array_equal(video["rgb"][i], np.clip(o.features["rgb"].cpu().numpy(), 0, 1)),
                    "render_video differs from render_frame")
        log("main", f"render_video {len(TIMES)} frames at t={list(TIMES)}: finite, rgb in [0,1], "
                    f"covered, unsaturated (max {max(int(o.num_intersections) for o in pre)} "
                    f"intersections); launches {launches}")
        nvs = inference.render_nvs(scene, cam, rcfg, [0, 10], device=DEVICE)
        st = inference.render_stereo(scene, cam, rcfg, [0, 10], device=DEVICE)
        require(nvs.shape == (2, H, W, 3) and np.isfinite(nvs).all(), "render_nvs")
        require(st.shape == (2, H, W, 3) and np.isfinite(st).all(), "render_stereo")
        log("main", "render_nvs and render_stereo: 2 frames each, finite")

        small = convert.scene_from_numpy(*small_scene_arrays(args.seed), device=DEVICE)
        scfg = rasterize.RasterizeConfig(width=64, height=48, max_intersections=1 << 14)
        scam = camera.canonical_camera(64, 48)
        on_gpu = inference.render_video(small, scam, scfg, [0], ("mask_attribute",), device=DEVICE)
        on_cpu = inference.render_video(small, scam, scfg, [0], ("mask_attribute",), device="cpu")
        pr_s = inference._scene_inputs(small, 0, ("mask_attribute",))
        sp = rasterize.project_gaussians(
            *(pr_s[0][k] for k in ("position", "scaling", "rotation", "opacity", "shs")),
            torch.as_tensor(scam.extrinsic, device=dev), scfg, extra_features=pr_s[1])
        sfeat = torch.cat([v for v, _, _ in sp.feature_groups.values()], dim=1)
        oracle = rasterize_ref.splat_reference(
            sp.uv, sp.conic, sp.opacity, sfeat, sp.depth, sp.radius, sp.rect_min, sp.rect_max,
            64, 48, torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], device=dev))
        d_cpu = max(np.abs(on_gpu[k] - on_cpu[k]).max() for k in on_gpu)
        d_ref = np.abs(on_gpu["rgb"][0] - np.clip(oracle.image[..., :3].cpu().numpy(), 0, 1)).max()
        require(d_cpu <= ATOL and d_ref <= ATOL, f"small scene: gpu-cpu {d_cpu}, gpu-oracle {d_ref}")
        log("main", f"64x48 scene: GPU render vs CPU render max diff {d_cpu:.3g}, "
                    f"vs sequential oracle {d_ref:.3g} (tol {ATOL})")

        # ---- 7. times ---------------------------------------------------------
        frame = lambda: inference.render_frame(scene, 7.0, cam.extrinsic, rcfg, EXTRA, device=DEVICE)
        frame_ms = wall_ms(frame)
        project_ms = wall_ms(lambda: project(7.0, rcfg))
        bin_ms = wall_ms(lambda: binning.bin_intersections(
            pr.depth, pr.tiles, pr.rect_min, pr.rect_max, W, H, MAX_INTERSECTIONS))
        cpm = sleep_cycles_per_ms()
        k1_ms = cuda_ms(lambda: rg.blend_forward(b.gid, b.edges, uv, conic, opac, feats, bg, W, H), cpm)
        k1_plain_ms = cuda_ms(
            lambda: rg.blend_forward_plain(b.gid, b.edges, uv, conic, opac, feats, bg, W, H), cpm)
        k2_ms = cuda_ms(lambda: rg.expand_intersections(*k2_args), cpm)
        k2_plain_ms = cuda_ms(lambda: rg.expand_intersections_plain(*k2_args), cpm)
        # references beside K2, not its yardstick: the owners alone, with no
        # keys; and a plain fill of its two outputs, the writes alone
        ar, tiles_l = torch.arange(CAPACITY, device=dev), tiles.long()
        rep_ms = cuda_ms(lambda: torch.repeat_interleave(ar, tiles_l, output_size=nint), cpm)
        fill_ms = cuda_ms(lambda: (torch.full((MAX_INTERSECTIONS,), rg.INT64_MAX, device=dev),
                                   torch.full((MAX_INTERSECTIONS,), -1, dtype=torch.int32, device=dev)), cpm)
        sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), cpm)
        busy_ms, top, ours = device_profile(frame, reps=5)
    N = CAPACITY
    applied = int(k1_out[2].sum())
    k1_bound, k1_by, k1_bytes, k1_ops = blend_cost("blend_forward", nint, b.edges, W, H, rcfg.block, N, C, applied)
    # K2 must read every Gaussian's tile count, and offs, rect_min,
    # rect_max.x and depth of those with tiles; it writes every slot once
    k2_live = int((tiles > 0).sum())
    k2_bytes = 4 * N + k2_live * (4 + 8 + 4 + 4) + MAX_INTERSECTIONS * (8 + 4)
    k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
    log("times", f"render_frame {frame_ms:.3f} ms/frame (wall): projection {project_ms:.3f} ms, "
                 f"binning {bin_ms:.3f} ms (wall, each with a synchronize) {card}")
    if busy_ms is None:
        log("times", f"profiler recorded no device kernels; device busy share not measured {card}")
    else:
        log("times", f"device busy {busy_ms:.3f} ms/frame = {busy_ms / frame_ms:.1%} of the wall time "
                     f"(torch.profiler, 5 frames); by kernel ms/frame: "
                     + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top) + f" {card}")
        log("times", "the port's kernels in that profile, ms/frame: "
                     + "; ".join(f"{name} {ms:.4f}" for name, ms in ours) + f" {card}")
    log("times", f"K1 blend_forward {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms "
                 f"({k1_by}: {k1_ops:.3g} flops, {k1_bytes:.3g} B, {applied} applied pairs) {card}")
    log("times", f"K2 expand_intersections {k2_ms:.4f} ms, plain {k2_plain_ms:.3f} ms, "
                 f"bound {k2_bound:.4f} ms (bytes: {k2_bytes:.3g} B, {k2_live} Gaussians with tiles); "
                 f"torch.repeat_interleave "
                 f"of the owners alone {rep_ms:.4f} ms; two torch.full of its outputs {fill_ms:.4f} ms "
                 f"{card}")
    log("times", f"torch.sort of {MAX_INTERSECTIONS} int64 keys (stable) {sort_ms:.4f} ms {card}")

    # ---- 8. training blend: K3 and K4 against their plain versions ---------
    from splatter_a_video_tpu_torch.train import losses, optim, trainer

    tcfg = trainer.TrainerConfig(width=W, height=H, num_frames=FRAMES, max_intersections=MAX_INTERSECTIONS)
    extr = torch.as_tensor(cam.extrinsic, dtype=torch.float32, device=dev)
    mask_t = torch.tensor(TRAIN_MASK, device=dev)

    def train_blend_inputs(tile, bias=None, wide=False, M=MAX_INTERSECTIONS):
        """Binning at budget M, K1 outputs (held to K1's plain version) and
        K3 arguments of the training render of frame TRAIN_T1 at `tile`,
        with a seeded dL/dimage; `wide` pads the features to WIDE_C channels
        (the extra ones reach opacity)."""
        rc = dataclasses.replace(tcfg, block_x=tile[0], block_y=tile[1]).raster_cfg()
        inp = trainer.scene_render_inputs(scene, TRAIN_T1)
        tp = trainer.project_for_training(inp, extr, rc, {"track_gs": scene.get_position(TRAIN_T2)},
                                          True, 0.0, tcfg.depth_bg)
        tb = binning.bin_intersections(tp.depth, tp.tiles, tp.rect_min, tp.rect_max, W, H,
                                       M, rc.max_tiles_per_gaussian, rc.block)
        tu, tc, to, tf, tbg = blend_inputs(tp)
        require(tf.shape[1] == len(TRAIN_MASK), f"training blend carries {tf.shape[1]} channels")
        tmask = mask_t
        if wide:
            tf, tbg = widen(tf, tbg, args.seed + 6)
            tmask = torch.cat([mask_t, torch.ones(WIDE_C - len(TRAIN_MASK), device=dev)])
        k1a = (tb.gid, tb.edges, tu, tc, to, tf, tbg, W, H, tile, 0, bias)
        fwd = rg.blend_forward(*k1a)
        ref = rg.blend_forward_plain(*k1a)
        torch.cuda.synchronize()
        same = all(torch.equal(a, r) for a, r in zip(fwd, ref))
        log("K1", f"training blend {tile[0]}x{tile[1]} C={tf.shape[1]}"
                  + ("" if bias is None else " opacity_bias")
                  + ("" if M == MAX_INTERSECTIONS else f" M={M}")
                  + f": torch.equal on all four outputs: {same}")
        require(same, f"K1 at the training blend {tile} C={tf.shape[1]} differs from plain")
        g = torch.randn((H, W, tf.shape[1]), generator=torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
        return tb, fwd, (tb.gid, tb.edges, tu, tc, to, tf, tbg, tmask, fwd[0], fwd[1], g, W, H, tile, bias)

    def rel_err(a, ref):
        return (a - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)

    def k3_check(tag, tile, bias=None, wide=False):
        tb, fwd, k3a = train_blend_inputs(tile, bias, wide)
        n = int(tb.edges[-1])
        dg, nc = rg.blend_backward(*k3a, return_ncontrib=True)
        ref, ref_nc = rg.blend_backward_plain(*k3a, return_ncontrib=True)
        torch.cuda.synchronize()
        err, abs_err = rel_err(dg[:n], ref[:n]), (dg[:n] - ref[:n]).abs().max().item()
        bad_k1, bad_plain = int((nc != fwd[2]).sum()), int((ref_nc != fwd[2]).sum())
        same = torch.equal(dg[:n], ref[:n])
        log("K3", f"{tag}: {n} slots x {dg.shape[1]} rows, max abs diff / max |plain| {err:.3g}, "
                  f"max abs diff {abs_err:.3g}, torch.equal {same}; "
                  f"replay ncontrib vs K1 mismatches {bad_k1}, plain vs K1 {bad_plain}")
        require(torch.isfinite(dg[:n]).all().item(), f"K3 {tag} not finite")
        require(same and bad_k1 == 0 and bad_plain == 0, f"K3 {tag} differs")
        return tb, fwd, k3a, dg, abs_err

    with torch.no_grad():
        tb, tfwd, k3_args, dgrad, k3_err = k3_check(f"16x16 C={len(TRAIN_MASK)} masked", (16, 16))
        t_nint = int(tb.num_intersections)
        require(t_nint <= MAX_INTERSECTIONS, f"training frame saturated: {t_nint} > {MAX_INTERSECTIONS}")
        k3_check("16x16 opacity_bias", (16, 16), bias)
        k3_check("32x16", (32, 16))
        k3_check(f"16x16 C={WIDE_C}", (16, 16), wide=True)

        def k4_check(tag, b4, k3a, rows):
            red = rg.reduce_gaussians(rows, b4.order, b4.offs, b4.tiles)
            red_p = rg.reduce_gaussians_plain(rows, b4.order, b4.offs, b4.tiles)
            runs = [rg.reduce_gaussians(rg.blend_backward(*k3a), b4.order, b4.offs, b4.tiles)
                    for _ in range(2)]
            torch.cuda.synchronize()
            same = torch.equal(red, red_p)
            log("K4", f"{tag}: reduce_gaussians [{red.shape[0]}, {red.shape[1]}] torch.equal to plain: "
                      f"{same} (max abs diff {(red - red_p).abs().max().item():.3g}); "
                      f"K3 + K4 run twice more: bit-identical")
            require(torch.isfinite(red).all().item() and same, f"K4 {tag} differs from plain")
            require(torch.equal(runs[0], runs[1]) and torch.equal(runs[0], red),
                    f"K3 + K4 {tag} not deterministic")
            return red, red_p

        k4_args = (dgrad, tb.order, tb.offs, tb.tiles)
        red, red_p = k4_check(f"16x16 C={len(TRAIN_MASK)}", tb, k3_args, dgrad)
        tb_s, _, k3_args_s = train_blend_inputs((16, 16), M=SATURATED)
        require(int(tb_s.num_intersections) > SATURATED, "the training frame does not saturate")
        k4_check(f"saturated budget M = {SATURATED} < {int(tb_s.num_intersections)}", tb_s, k3_args_s,
                 rg.blend_backward(*k3_args_s))

    # ---- 9. gradients on the card against the CPU ----------------------------
    small_t = small_train_scene(args.seed)
    g_gpu, g_cpu = render_grads(small_t, dev, args.seed)[0], render_grads(small_t, "cpu", args.seed)[0]
    worst = max(((g_gpu[k] - g_cpu[k]).abs() / (GRAD_ATOL + GRAD_RTOL * g_cpu[k].abs())).max().item()
                for k in g_cpu)
    require(all(torch.isfinite(v).all().item() for v in g_gpu.values()), "64x48 gradients not finite")
    require(worst <= 1.0, f"64x48 gradients: GPU vs CPU at {worst:.3g} of the bar")
    log("grad", f"64x48 training render, {len(g_cpu)} gradients (every parameter, uv and abs sinks): "
                f"GPU vs CPU worst |diff| / (atol {GRAD_ATOL} + rtol {GRAD_RTOL} |cpu|) = {worst:.3g}")

    # ---- 10. main path: ten train steps, a density step, an opacity reset ---
    train_step, density_step, reset_step = trainer.make_train_step(tcfg, cam.extrinsic, device=DEVICE)
    state = trainer.init_train_state(tcfg, scene, seed=args.seed, device=DEVICE)
    batch = trainer.Batch(t1=TRAIN_T1, t2=TRAIN_T2, **{
        k: torch.from_numpy(v).to(dev) for k, v in train_batch_arrays(args.seed).items()})
    state0 = state
    for k in rg.LAUNCHES:
        rg.LAUNCHES[k] = 0
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    train_launches = dict(rg.LAUNCHES)
    require(train_launches == {k: TRAIN_STEPS for k in train_launches}, f"train launch counts {train_launches}")
    for i, m in enumerate(history):
        require(all(np.isfinite(v) for v in m.values()), f"step {i}: metrics not finite {m}")
        require(m["num_intersections"] <= MAX_INTERSECTIONS, f"step {i} saturated: {m['num_intersections']}")
    first, last = history[0], history[-1]
    require(last["loss_rgb"] < first["loss_rgb"], f"loss_rgb did not fall: {first['loss_rgb']} -> {last['loss_rgb']}")
    require(state.step == TRAIN_STEPS and state.opt_state.count == TRAIN_STEPS, "step counts")
    log("train", f"{TRAIN_STEPS} steps of make_train_step at {W}x{H}, {ALIVE} alive, C={len(TRAIN_MASK)}, "
                 f"{TRACKS} tracks: finite, unsaturated (max "
                 f"{max(int(m['num_intersections']) for m in history)} intersections); launches "
                 f"{train_launches}; loss {first['loss']:.5f} -> {last['loss']:.5f}, loss_rgb "
                 f"{first['loss_rgb']:.5f} -> {last['loss_rgb']:.5f}, psnr {first['psnr']:.3f} -> "
                 f"{last['psnr']:.3f}; last flow {last['loss_flow']:.4f}, depth {last['loss_depth']:.4f}, "
                 f"arap {last['loss_arap']:.3g}")
    dense, info = density_step(state)
    alive_after = int(dense.scene.alive.sum())
    require(alive_after == int(info.num_alive), f"alive {alive_after} != num_alive {int(info.num_alive)}")
    require(all(torch.isfinite(v).all().item() for v in dense.scene.params.values()), "density: not finite")
    reset = reset_step(dense)
    op = torch.sigmoid(reset.scene.params["opacity"])
    require(torch.isfinite(op).all().item() and op.max().item() <= 0.01 + 1e-6, "opacity reset")
    require(float(reset.opt_state.mu["opacity"].abs().sum()) == 0.0, "opacity moments not reset")
    log("train", f"density step: cloned {int(info.num_cloned)}, split {int(info.num_split)}, pruned "
                 f"{int(info.num_pruned)}, dropped {int(info.dropped)}, alive {alive_after} == num_alive; "
                 f"opacity reset: max opacity {op.max().item():.4g}, opacity moments 0")

    # ---- 11. training times ----------------------------------------------------
    train_ms = statistics.median(step_ms[1:])
    t_busy, t_top, t_ours = device_profile(lambda: train_step(state0, batch), reps=3)
    # the step's parts, each timed alone from the same state (wall, with a synchronize)
    leaves = {k: v.detach().requires_grad_(True) for k, v in state0.scene.params.items()}
    sinks = [torch.zeros((CAPACITY, 2), device=dev, requires_grad=True) for _ in range(2)]
    arap_idx = losses.arap_sample(CAPACITY, tcfg.arap_sample_num, scene.alive, state0.key, dev)
    fwd = lambda: trainer.compute_losses(tcfg, tcfg.raster_cfg(), state0.scene, batch, arap_idx, 0,
                                         leaves, *sinks, extr)[0]
    grads = dict(zip(leaves, torch.autograd.grad(fwd(), list(leaves.values()), allow_unused=True)))
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
    fwd_ms = wall_ms(fwd, reps=5)
    fwd_bwd_ms = wall_ms(lambda: torch.autograd.grad(fwd(), list(leaves.values()) + sinks,
                                                     allow_unused=True), reps=5)
    adam_ms = wall_ms(lambda: optim.adam_update(tcfg.optim, state0.scene.params, grads, state0.opt_state),
                      reps=5)
    with torch.no_grad():
        k1_train_args = k3_args[:7] + (W, H)
        k1_train_ms = cuda_ms(lambda: rg.blend_forward(*k1_train_args), cpm)
        k3_ms = cuda_ms(lambda: rg.blend_backward(*k3_args), cpm)
        k3_plain_ms = cuda_ms(lambda: rg.blend_backward_plain(*k3_args), cpm, PLAIN_REPS)
        k4_ms = cuda_ms(lambda: rg.reduce_gaussians(*k4_args), cpm)
        k4_plain_ms = cuda_ms(lambda: rg.reduce_gaussians_plain(*k4_args), cpm, PLAIN_REPS)
        owner = tb.gid[:t_nint].long()
        rows = dgrad[:t_nint]
        k4_lib_ms = cuda_ms(lambda: torch.zeros_like(red).index_add_(0, owner, rows), cpm)
        # the gather alone: the used rows in pre-sort order, through the
        # inverse permutation (a reference beside K4, not its yardstick)
        inv = torch.empty_like(tb.order)
        inv[tb.order] = torch.arange(inv.shape[0], device=dev)
        inv_used = inv[:t_nint].contiguous()
        gather_ms = cuda_ms(lambda: dgrad.index_select(0, inv_used), cpm)
    R = dgrad.shape[1]
    Ct = len(TRAIN_MASK)
    attrs = {"blend_forward": rg.kernel_attributes("blend_forward", C, (16, 16)),
             "expand_intersections": rg.kernel_attributes("expand_intersections"),
             "blend_backward": rg.kernel_attributes("blend_backward", Ct, (16, 16)),
             "reduce_gaussians": rg.kernel_attributes("reduce_gaussians", R)}
    k1_train_attrs = rg.kernel_attributes("blend_forward", Ct, (16, 16))
    t_applied = int(tfwd[2].sum())
    k3_bound, k3_by, k3_bytes, k3_ops = blend_cost("blend_backward", t_nint, tb.edges, W, H, (16, 16), N, Ct, t_applied)
    k4_bytes = t_nint * (R * 4 + 8) + N * (8 + R * 4)
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, t_nint * R / FP32_FLOPS_PER_S) * 1e3
    log("times", f"train step {train_ms:.3f} ms wall (median of steps 2-{TRAIN_STEPS}; all: "
                 + ", ".join(f"{t:.1f}" for t in step_ms) + f") {card}")
    log("times", f"train step parts (wall, median of 5): render + losses {fwd_ms:.3f} ms, "
                 f"with the backward {fwd_bwd_ms:.3f} ms, Adam over {len(grads)} attributes "
                 f"{adam_ms:.3f} ms {card}")
    if t_busy is None:
        log("times", f"profiler recorded no device kernels; train-step busy share not measured {card}")
    else:
        log("times", f"train step device busy {t_busy:.3f} ms/step = {t_busy / train_ms:.1%} of the wall time "
                     f"(torch.profiler, 3 steps); by kernel ms/step: "
                     + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in t_top) + f" {card}")
        log("times", "the port's kernels in that profile, ms/step: "
                     + "; ".join(f"{name} {ms:.4f}" for name, ms in t_ours) + f" {card}")
    log("times", f"K3 blend_backward {k3_ms:.4f} ms, plain {k3_plain_ms:.3f} ms, bound {k3_bound:.4f} ms "
                 f"({k3_by}: {k3_ops:.3g} flops, {k3_bytes:.3g} B, {t_nint} slots, {t_applied} applied "
                 f"pairs), {train_launches['blend_backward'] / TRAIN_STEPS:g} launch/step; "
                 f"{resources(attrs['blend_backward'])} (C={Ct}, 16x16) {card}")
    log("times", f"K4 reduce_gaussians {k4_ms:.4f} ms, plain {k4_plain_ms:.3f} ms, index_add_ "
                 f"{k4_lib_ms:.4f} ms, bound {k4_bound:.4f} ms (bytes: {k4_bytes:.3g} B); "
                 f"index_select of the rows through the inverse permutation {gather_ms:.4f} ms; "
                 f"{train_launches['reduce_gaussians'] / TRAIN_STEPS:g} launch/step; "
                 f"{resources(attrs['reduce_gaussians'])} {card}")
    log("times", f"K1 blend_forward at the training blend (C={Ct}, 16x16) {k1_train_ms:.4f} ms, "
                 f"{train_launches['blend_forward'] / TRAIN_STEPS:g} launch/step; "
                 f"{resources(k1_train_attrs)} {card}")
    log("times", f"K1 blend_forward (C={C}, 16x16): {resources(attrs['blend_forward'])}; "
                 f"K2 expand_intersections: {resources(attrs['expand_intersections'])} {card}")

    # ---- 12-14. the fit at full width, the mini-fit bands, the CLI -----------
    fit_launches, fit_clip_data, fit_watch_first = fit_phase(args, dev, card)
    repeat_phase(args, card, fit_clip_data, fit_watch_first)
    del fit_watch_first
    mini_fit_phase(card)
    cli_phase(card)

    # ---- 15-18. editing, camera refinement, atlases, the perspective engine ---
    instances = merge_rows(edit_phase(args, dev, card, scene, cpm))
    pose_phase(args, dev, card, scene, fit_clip_data)
    atlas_phase(args, dev, card)
    instances = merge_rows(instances, engine_phase(args, dev, card, cpm))

    # ---- 19-21. data-parallel steps, the depth-slab render, the networks ----
    dp_launches = dp_phase(args, dev, card, scene)
    shard_launches = shard_phase(args, dev, card, scene)
    nets_phase(args, dev, card)

    # ---- 22. the loss library on the card ------------------------------------
    helpers_phase(args, dev, card, scene)
    lbs_draws_check(card)

    # ---- 23. the blend's wide instances: C = 52 train steps, C = 49 render ----
    wide_rows, wide_launches = wide_phase(args, dev, card, cpm)
    instances = merge_rows(instances, wide_rows)

    # ---- 24. the tutorials at their defaults, the TAPIR converter -------------
    tut_rows, tut_fit_launches, tut_orbit_launches = tutorials_phase(args, dev, card, cpm)
    instances = merge_rows(instances, tut_rows)

    # ---- 25. the production harness: torch_e2e_480p, then torch_capability_480p --
    e2e_rows, e2e_launches, cap_launches = e2e_phase(args, dev, card, cpm)
    instances = merge_rows(instances, e2e_rows)

    kernels = [
        {"name": "blend_forward", "route": "cuda",
         "source": "splatter_a_video_tpu_torch/csrc/blend_forward.cu",
         "replaces": "splatter_a_video_tpu/ops/rasterize_tpu.py:240",
         "launches": launches["blend_forward"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by,
         "library_ms": None},
        {"name": "expand_intersections", "route": "cuda",
         "source": "splatter_a_video_tpu_torch/csrc/expand_intersections.cu",
         "replaces": "splatter_a_video_tpu/ops/binning.py:130",
         "launches": launches["expand_intersections"],
         "max_abs_err": float((keys - keys_p).abs().max().item()),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "blend_backward", "route": "cuda",
         "source": "splatter_a_video_tpu_torch/csrc/blend_backward.cu",
         "replaces": "splatter_a_video_tpu/ops/rasterize_tpu.py:414",
         "launches": train_launches["blend_backward"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None},
        {"name": "reduce_gaussians", "route": "cuda",
         "source": "splatter_a_video_tpu_torch/csrc/reduce_gaussians.cu",
         "replaces": "splatter_a_video_tpu/ops/rasterize_tpu.py:865",
         "launches": train_launches["reduce_gaussians"], "max_abs_err": float((red - red_p).abs().max()),
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": "bytes",
         "library_ms": k4_lib_ms},
    ]
    for k in kernels:
        k.update(attrs[k["name"]])
        # `launches` counts the main path, the full-width fit; the render
        # and the ten train steps keep their own counts beside it
        k["render_launches"], k["step_launches"] = launches[k["name"]], train_launches[k["name"]]
        k["launches"] = fit_launches[k["name"]]
        # the blend instances of phases 15, 18, 23 and 24 (K2: 24), each held torch.equal
        k["instances"] = instances.get(k["name"], [])
        # the DP steps', the depth slabs' and the wide train steps' launches (phases 19, 20, 23)
        k["dp_launches"], k["shard_launches"] = dp_launches[k["name"]], shard_launches[k["name"]]
        k["wide_launches"] = wide_launches[k["name"]]
        # the gs_2d fit's and the gs_3d orbit's launches (phase 24)
        k["gs_2d_launches"], k["gs_3d_launches"] = tut_fit_launches[k["name"]], tut_orbit_launches[k["name"]]
        # the production harness's fit and evaluation, and the capability harness (phase 25)
        k["e2e_launches"], k["capability_launches"] = e2e_launches[k["name"]], cap_launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
