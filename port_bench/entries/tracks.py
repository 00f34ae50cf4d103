"""The tracks entry: dense point tracking through the program's
`nets.tapir.track_points`, as `data/preprocess.compute_tracks` calls it for
every query frame of a clip before the clip is fitted.

Set-up makes, from the run's seed:

  * the clip (`clip.py`'s textured clip at the configuration's `clip` size),
    as 8-bit frames, resized on the card to the model's resolution and cut
    back to 8 bits as `compute_tracks` does;
  * the queries, in `compute_tracks`' order: for each query frame upwards,
    every point of a `grid_size` grid on the clip's raster (the masks are
    taken to cover the whole frame), row-major, mapped to the model's raster;
  * the weights (`reference/tapir.draw_params`, on the card), handed to the
    program's `Tapir` as loaded weights.

Each call is `track_points(model, video, queries, chunk)` on the next
`queries_per_call` queries. `warm_calls` calls are set-up; the window then
runs whole calls until `seconds` have passed, a synchronize at both ends.
`preprocess_ms_per_frame` is the window's wall time over the queries it
tracked, times the queries of one query frame: the card time the tracking
of a clip costs per frame. With a trace, calls [trace_skip, trace_skip +
trace_calls) of the window run under `torch.profiler`.

After the window the program's model is freed and the reference
(`reference/tapir.py`) tracks `check_queries` of the window's queries, drawn
from the seed, on the same video and weights; `numbers` compares its
tracks, occlusion and expected-distance logits with the program's.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import clip as _clip
from port_bench import trace as _trace
from port_bench.reference import tapir as _ref

TRAFFIC_KEYS = ("queries_per_call", "warm_calls", "check_queries", "trace_skip", "trace_calls")
LIMIT_KEYS = ("tracks_gap_px", "occlusion_gap", "expected_dist_gap")


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def make_video(cfg: dict, seed: int, dev) -> torch.Tensor:
    """The clip as 8-bit frames [T, rh, rw, 3] at the model's resolution, on `dev`."""
    W, H = cfg["clip"]["frame_size"]
    spec = _clip.ClipSpec(width=W, height=H, num_frames=cfg["clip"]["num_frames"],
                          num_blobs=cfg["clip"]["num_blobs"], blob_radius=cfg["clip"]["blob_radius"],
                          track_grid=max(W, H))          # its ground-truth tracks are not used here
    c = _clip.make_clip(spec, seed, dev)
    frames = torch.from_numpy(np.stack(c.frames)).to(dev)
    u8 = torch.round(frames * 255.0).clamp(0, 255)                         # as read from 8-bit files
    rh, rw = cfg["model"]["initial_resolution"]
    r = F.interpolate(u8.permute(0, 3, 1, 2), size=(rh, rw), mode="bilinear", align_corners=False)
    return r.permute(0, 2, 3, 1).to(torch.uint8).contiguous()              # cut as numpy's astype cuts


def make_queries(cfg: dict) -> np.ndarray:
    """Every query `compute_tracks` asks of the clip, [T x per frame, 3] (t, y, x)
    in the model's raster, float32."""
    W, H = cfg["clip"]["frame_size"]
    rh, rw = cfg["model"]["initial_resolution"]
    g = cfg["grid_size"]
    y, x = np.mgrid[0:H:g, 0:W:g]
    yx = np.stack([y.reshape(-1) / (H - 1) * (rh - 1), x.reshape(-1) / (W - 1) * (rw - 1)], -1)
    T = cfg["clip"]["num_frames"]
    t = np.repeat(np.arange(T, dtype=np.float64), len(yx))[:, None]
    return np.concatenate([t, np.tile(yx, (T, 1))], 1).astype(np.float32)


def queries_per_frame(cfg: dict) -> int:
    W, H = cfg["clip"]["frame_size"]
    g = cfg["grid_size"]
    return (-(-H // g)) * (-(-W // g))


def to_clip_px(cfg: dict, tracks: torch.Tensor) -> torch.Tensor:
    """Tracks (x, y) in the model's raster to the clip's, as `compute_tracks` maps them."""
    W, H = cfg["clip"]["frame_size"]
    rh, rw = cfg["model"]["initial_resolution"]
    return tracks * torch.tensor([(W - 1) / (rw - 1), (H - 1) / (rh - 1)], dtype=tracks.dtype,
                                 device=tracks.device)


def program_model(cfg: dict, params: dict, dev):
    """The program's `Tapir` with the configuration's widths and the given weights."""
    from splatter_a_video_tpu_torch.nets import tapir

    m = cfg["model"]
    tcfg = tapir.TapirConfig(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items()})
    return tapir.Tapir(tcfg, {k: v.cpu() for k, v in params.items()}).to(dev)


def _gaps(cfg: dict, prog: dict, ref: dict):
    """Per track point: its distance in the clip's pixels, and each logit's gap."""
    d = torch.linalg.vector_norm(to_clip_px(cfg, prog["tracks"].double()) - to_clip_px(cfg, ref["tracks"].double()),
                                 dim=-1)
    return d, {k: (prog[k].double() - ref[k].double()).abs() for k in ("occlusion", "expected_dist")}


def numbers(cfg: dict, prog: dict, ref: dict) -> dict:
    """The program's answers [N, T] against the reference's, each the 90th
    percentile over the sampled track points: `tracks_gap_px`, of the
    distance in the clip's pixels; `occlusion_gap` and `expected_dist_gap`,
    of each logit's gap. Not the largest: a point whose cost-volume argmax
    sits on a near-tie jumps cells on rounding alone, in sound runs too (up
    to 11 of 24,576 points, PERF.md), and no limit could hold the widest gap."""
    d, logit = _gaps(cfg, prog, ref)
    p90 = lambda v: float(torch.quantile(v.reshape(-1), 0.9))
    return {"tracks_gap_px": p90(d), "occlusion_gap": p90(logit["occlusion"]),
            "expected_dist_gap": p90(logit["expected_dist"])}


def readings(cfg: dict, prog: dict, ref: dict) -> dict:
    """Quantiles of each gap over the track points, for setting limits
    (`control_tracks.py`)."""
    d, logit = _gaps(cfg, prog, ref)
    out = {}
    for name, v in (("tracks_px", d), ("occlusion", logit["occlusion"]), ("expected_dist", logit["expected_dist"])):
        v = v.reshape(-1)
        qs = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=v.dtype, device=v.device))
        out[name] = {"p50": float(qs[0]), "p90": float(qs[1]), "p99": float(qs[2]), "p999": float(qs[3]),
                     "max": float(v.max()), "over_1": float((v > 1.0).double().mean())}
    return out


def verdict(nums: dict, limits: dict) -> list:
    return [{"name": k, "value": nums[k], "limit": limits[k], "ok": nums[k] <= limits[k]} for k in sorted(nums)]


def run(cfg, traffic, limits, seed, seconds, trace, device, t_start, readers, keep=False):
    from splatter_a_video_tpu_torch.nets import tapir

    dev = torch.device(device)
    m = cfg["model"]
    per_call, chunk = traffic["queries_per_call"], cfg["query_chunk"]
    phases = {}

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0
        _say(f"[phase] {name} {phases[name]!r}")

    t = time.perf_counter()
    video = make_video(cfg, seed, dev)
    video_np = video.cpu().numpy()
    phase("clip_s", t)
    t = time.perf_counter()
    queries = make_queries(cfg)
    phase("queries_s", t)
    t = time.perf_counter()
    params = _ref.draw_params(m, seed, dev)
    model = program_model(cfg, params, dev)
    _sync(dev)
    phase("weights_s", t)
    calls_total = len(queries) // per_call
    warm, skip, count = traffic["warm_calls"], traffic["trace_skip"], traffic["trace_calls"]

    def call(k):
        return tapir.track_points(model, video_np, queries[k * per_call:(k + 1) * per_call], chunk=chunk)

    for k in range(warm):
        t = time.perf_counter()
        call(k)
        phase(f"warm_call{k}_s", t)

    tmp = tempfile.mkdtemp(prefix="port_bench_")
    trace_path = os.path.join(tmp, "trace.json")
    prof = None
    outs = []
    _sync(dev)
    t_open = time.perf_counter()
    k = warm
    while True:
        if k >= calls_total:
            raise RuntimeError(f"the clip's {len(queries)} queries ran out before the window closed")
        i = k - warm
        if trace and i == skip:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
        if prof is not None:
            with torch.profiler.record_function(_trace.STEP_MARK):
                outs.append(call(k))
        else:
            outs.append(call(k))
        k += 1
        if prof is not None and i == skip + count - 1:
            _sync(dev)
            prof.stop()
            prof.export_chrome_trace(trace_path)
            prof = None
        if time.perf_counter() - t_open >= seconds and (not trace or i >= skip + count - 1):
            break
    _sync(dev)
    t_close = time.perf_counter()
    calls = k - warm
    tracked = calls * per_call
    ms_per_frame = (t_close - t_open) / tracked * queries_per_frame(cfg) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    _say(f"[window] calls {calls} queries {tracked} seconds {t_close - t_open!r} "
         f"preprocess_ms_per_frame {ms_per_frame!r}")
    _say(f"[setup] setup_s {t_open - t_start!r} memory_peak_bytes {peak}")
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {"metrics": {"preprocess_ms_per_frame": ms_per_frame, "setup_s": t_open - t_start},
           "attempted": tracked, "failed": 0, "memory_peak_bytes": peak, "phases": phases}
    if trace:
        summary = _trace.summarize(trace_path, count, cfg)
        ctx = {"summary": summary, "cfg": cfg, "calls": count, "queries_per_call": per_call,
               "queries_total": len(queries), "frames": cfg["clip"]["num_frames"]}
        out["per_layer"] = {}
        for name, rd in readers.items():
            v = rd.read(ctx)
            if v is not None:
                out["per_layer"][name] = v
        out["busy_s"], out["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = summary["breakdown"]
        with contextlib.suppress(OSError):
            os.remove(trace_path)
    with contextlib.suppress(OSError):
        os.rmdir(tmp)

    # the check: a sample of the window's answers, drawn from the seed
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(tracked, size=min(traffic["check_queries"], tracked), replace=False))
    prog = {key: torch.from_numpy(np.concatenate([o[key] for o in outs])[pick]).to(dev) for key in outs[0]}
    q = torch.from_numpy(queries[warm * per_call + pick]).to(dev)
    ref = _ref.run(m, params, video, q, block=chunk)
    nums = numbers(cfg, prog, ref)
    out["check"] = verdict(nums, limits)
    phases["reference_s"] = time.perf_counter() - t
    if keep:
        out["kept"] = {"params": params, "video": video, "queries": q, "prog": prog, "ref": ref}
    return out
