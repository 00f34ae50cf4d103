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
     opacity reset.

Every kernel check is `torch.equal` against the plain version.

The launch counters are set to 0 just before each of the two main paths
(the video render, the ten train steps) and read just after. Each phase
prints one line; any failure ends the run with a non-zero exit and no
result line. The `[times]` lines and the kernel table carry each kernel's
registers per thread, local (spill) bytes per thread and shared bytes per
block at the main path's instance (`rasterize_gpu.kernel_attributes`),
the port's kernels' own times inside the frame and step profiles, and
beside K2 and K4 the PyTorch calls that do part of their work (the owners
alone, a fill of K2's outputs, the gather of K4's rows), as references.
The line before the last is the kernel table as JSON, the last line
`{"ok": true, "device": {...}}`. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
WIDE_C = 32             # the largest channel bucket of K1 and K3
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3   # gradients, the bars of tests/test_rasterize.py
PLAIN_REPS = 3          # the plain versions read counts back, so each run waits for the card
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, CUDA cores


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def flagship_scene_arrays(seed: int):
    """Random flagship scene (positions as bench.py's render bench) with a
    cubic-spline trajectory fitted to a smooth synthetic track."""
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
        "dino_attribute": full((3,), rng.randn(n, 3)),
        "pos_cubic_coeff": full(coeff.shape[1:], coeff),
    }
    params["position"][n:] = (0.0, 0.0, -10.0)   # dead slots parked behind the camera
    params["rotation"][n:] = (1.0, 0.0, 0.0, 0.0)
    aux = {"alive": np.arange(cap) < n, "spline_knots": knots}
    cfg = dict(
        capacity=cap, num_frames=FRAMES, traj="cubic_spline",
        render_attributes=(("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", 3)),
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


def small_train_scene(seed: int, n: int = 120):
    """A 64x48-sized poly_fourier scene from `create_scene` on the CPU, with
    random shapes, opacities below 0.9 and motion, for the gradient check."""
    import torch

    from splatter_a_video_tpu_torch.models import gaussians

    rng = np.random.RandomState(seed + 3)
    pos = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1)
    cfg = gaussians.SceneConfig(capacity=n + 16, num_frames=8, traj="poly_fourier")
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
    return gaussians.GaussianScene(params=p, aux=scene.aux, cfg=cfg)


def render_grads(scene, dev, seed: int):
    """Gradients of a fixed random linear loss on the 64x48 training render
    (rgb, depth, track_gs) with respect to every parameter and both sinks."""
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
    out = trainer._render_with_sinks(trainer.scene_render_inputs(sc, 2), extr, tcfg.raster_cfg(),
                                     {"track_gs": sc.get_position(5)}, True, uv_sink, abs_sink)
    rng = np.random.RandomState(seed + 4)
    loss = sum((v * torch.from_numpy(rng.randn(*v.shape).astype(np.float32)).to(dev)).sum()
               for v in out.features.values())
    names = list(params) + ["uv_sink", "abs_sink"]
    grads = torch.autograd.grad(loss, list(params.values()) + [uv_sink, abs_sink], allow_unused=True)
    return {k: (torch.zeros(1) if g is None else g.detach().cpu()) for k, g in zip(names, grads)}


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
    k1_bytes = 4 * nint + 4 * (tgx * tgy + 1) + N * (8 + 12 + 4 + 4 * C) + 4 * C + H * W * (C + 2) * 4
    k1_ops = 256 * nint * 15 + applied * 2 * C
    k1_by = "operations" if k1_ops / FP32_FLOPS_PER_S > k1_bytes / HBM_BYTES_PER_S else "bytes"
    # K2 must read every Gaussian's tile count, and offs, rect_min,
    # rect_max.x and depth of those with tiles; it writes every slot once
    k2_live = int((tiles > 0).sum())
    k2_bytes = 4 * N + k2_live * (4 + 8 + 4 + 4) + MAX_INTERSECTIONS * (8 + 4)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOPS_PER_S) * 1e3
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
    g_gpu, g_cpu = render_grads(small_t, dev, args.seed), render_grads(small_t, "cpu", args.seed)
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
    arap_idx = losses.arap_sample(CAPACITY, tcfg.arap_sample_num, scene.alive, state0.generator, dev)
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
    k3_bytes = (4 * t_nint + 4 * (tgx * tgy + 1) + N * (8 + 12 + 4 + 4 * Ct) + 8 * Ct
                + H * W * (2 * Ct + 1) * 4 + t_nint * R * 4)
    k3_ops = 256 * t_nint * 15 + t_applied * (40 + 5 * Ct + R)
    k3_by = "operations" if k3_ops / FP32_FLOPS_PER_S > k3_bytes / HBM_BYTES_PER_S else "bytes"
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP32_FLOPS_PER_S) * 1e3
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
