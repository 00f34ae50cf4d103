#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from `splatter_a_video_tpu_torch/csrc/`,
holds each against its plain PyTorch version at the flagship shapes
(854x480, 131,000 Gaussians of which 100,000 alive, degree-3 SH, the
mask / pos_poly_feat / dino render attributes: C = 20 blended channels),
renders a 5-frame video through `inference.render_video` with the launch
counters reset just before, checks the frames, and times the kernels.
Each phase prints one line; any failure ends the run with a non-zero exit
and no result line. The line before the last is the kernel table as JSON,
the last line `{"ok": true, "device": {...}}`. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H = 854, 480
CAPACITY, ALIVE, FRAMES = 131_000, 100_000, 48
MAX_INTERSECTIONS = 1 << 20
EXTRA = ("mask_attribute", "pos_poly_feat", "dino_attribute")
TIMES = (0, 1.5, 7, 23, 47)
ATOL = 2e-5             # image and final_T, as the port's CPU tests hold the blend
REPS = 20
DEVICE = "cuda"
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


def device_profile(fn, reps: int):
    """(device busy ms per call, [(kernel, ms per call)] top 6) from
    torch.profiler, or (None, []) when it records no device kernels."""
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
        return None, []
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return sum(per_name.values()), top


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
        feats = torch.cat([v for v, _ in pr.feature_groups.values()], dim=1).contiguous()
        bg = torch.tensor(
            [b for v, b in pr.feature_groups.values() for _ in range(v.shape[1])],
            dtype=torch.float32, device=dev,
        )
        return pr.uv.contiguous(), pr.conic.contiguous(), pr.opacity.contiguous(), feats, bg

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

        # ---- 5. K1 against its plain version --------------------------------
        uv, conic, opac, feats, bg = blend_inputs(pr)
        C = feats.shape[1]
        require(C == 20, f"flagship blend carries {C} channels, expected 20")

        def k1_check(tag, bb, tile, K=0, bias=None):
            out = rg.blend_forward(bb.gid, bb.edges, uv, conic, opac, feats, bg, W, H, tile, K, bias)
            ref = rg.blend_forward_plain(bb.gid, bb.edges, uv, conic, opac, feats, bg, W, H, tile, K, bias)
            torch.cuda.synchronize()
            err = max((out[0] - ref[0]).abs().max().item(), (out[1] - ref[1]).abs().max().item())
            bad_nc = int((out[2] != ref[2]).sum())
            bad_gs = int((out[3] != ref[3]).sum())
            log("K1", f"{tag}: image/final_T max abs diff {err:.3g} (tol {ATOL}), "
                      f"ncontrib mismatches {bad_nc}, gs_idx mismatches {bad_gs}")
            require(err <= ATOL and bad_nc == 0 and bad_gs == 0, f"K1 {tag} differs from plain")
            require(torch.isfinite(out[0]).all().item(), f"K1 {tag} not finite")
            return err, out

        k1_err, k1_out = k1_check("16x16 C=20", b, (16, 16))
        k1_check("16x16 K_idx=8", b, (16, 16), K=8)
        bias = torch.from_numpy(
            np.random.RandomState(args.seed + 1).uniform(0.0, 0.1, CAPACITY).astype(np.float32)).to(dev)
        k1_check("16x16 opacity_bias", b, (16, 16), bias=bias)
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
        require(launches == {k: len(TIMES) for k in launches}, f"launch counts {launches}")
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
        sfeat = torch.cat([v for v, _ in sp.feature_groups.values()], dim=1)
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
        sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), cpm)
        busy_ms, top = device_profile(frame, reps=5)
    N = CAPACITY
    applied = int(k1_out[2].sum())
    k1_bytes = 4 * nint + 4 * (tgx * tgy + 1) + N * (8 + 12 + 4 + 4 * C) + 4 * C + H * W * (C + 2) * 4
    k1_ops = 256 * nint * 15 + applied * 2 * C
    k1_by = "operations" if k1_ops / FP32_FLOPS_PER_S > k1_bytes / HBM_BYTES_PER_S else "bytes"
    k2_bytes = N * (4 + 4 + 8 + 8 + 4) + MAX_INTERSECTIONS * (8 + 4)
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
    log("times", f"K1 blend_forward {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms "
                 f"({k1_by}: {k1_ops:.3g} flops, {k1_bytes:.3g} B, {applied} applied pairs) {card}")
    log("times", f"K2 expand_intersections {k2_ms:.4f} ms, plain {k2_plain_ms:.3f} ms, "
                 f"bound {k2_bound:.4f} ms (bytes: {k2_bytes:.3g} B) {card}")
    log("times", f"torch.sort of {MAX_INTERSECTIONS} int64 keys (stable) {sort_ms:.4f} ms {card}")

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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
