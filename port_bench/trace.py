"""Reading a traced stretch of the window (a `torch.profiler` Chrome trace).

`summarize` reduces the trace to what the per-layer readers take:

  * the traced steps' host spans (`STEP_MARK`, opened by the window hook at
    each step), the window from the first span's start to the end of the
    last device activity;
  * the device's busy intervals (kernels, copies, sets), their union within
    the window, the idle gaps and what the host was doing in each;
  * kernel launches of the traced steps, device time by kernel name, the
    binning's kernels (those launched on the host between the prefix sum of
    tile counts before each K2 launch and the `searchsorted` of tile edges
    after it: K2, the sort of the intersection keys, the gather of owners),
    K1 and K3 by name;
  * the host's own time: the step spans less the time spent blocked in
    synchronising CUDA calls.

`blend_counts` replays the traced steps' renders with the reference's plain
blend to count the slot-pixel tests and the applied pairs that K1 and K3
needed (the scene at the first traced step; the later traced steps differ
from it by a few Adam steps).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List

import torch

STEP_MARK = "port_bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(path: str, steps: int, cfg: dict) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    marks = sorted((e for e in xs if e["name"] == STEP_MARK and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    if not marks:
        raise RuntimeError("the trace holds no step spans")
    t0 = marks[0]["ts"]
    dev_ev = [e for e in xs if e.get("cat", "").lower() in DEVICE_CATS]
    t_end = max([m["ts"] + m["dur"] for m in marks] + [e["ts"] + e["dur"] for e in dev_ev if e["ts"] >= t0])
    busy_iv = _union([(max(e["ts"], t0), min(e["ts"] + e["dur"], t_end)) for e in dev_ev
                      if e["ts"] + e["dur"] > t0 and e["ts"] < t_end])
    busy = sum(e - s for s, e in busy_iv)
    window = t_end - t0

    # host side: spans, launches and the op stack of each launch
    span_iv = [(m["ts"], m["ts"] + m["dur"]) for m in marks]
    in_span = lambda ts: any(s <= ts <= e for s, e in span_iv)
    runtime = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    ops_by_tid = defaultdict(list)
    for e in xs:
        if e.get("cat") in ("cpu_op", "user_annotation"):
            ops_by_tid[e["tid"]].append(e)
    for v in ops_by_tid.values():
        v.sort(key=lambda e: (e["ts"], -e["dur"]))
    kernels = [e for e in dev_ev if e.get("cat", "").lower() == "kernel"]
    launch_corr = {r["args"]["correlation"] for r in runtime
                   if "correlation" in r.get("args", {}) and in_span(r["ts"])}
    # the binning, on the host: from the prefix sum of the tile counts that
    # precedes a K2 launch to the end of the `searchsorted` of the tile edges
    # that follows it (`ops/binning.bin_intersections`)
    k2_corr = {k["args"]["correlation"] for k in kernels if "expand_intersections" in k["name"]}
    binning_corr = set()
    for r in runtime:
        if r.get("args", {}).get("correlation") not in k2_corr:
            continue
        ops = ops_by_tid.get(r["tid"], [])
        cums = [o["ts"] for o in ops if o["name"] == "aten::cumsum" and o["ts"] <= r["ts"]]
        ends = [o["ts"] + o["dur"] for o in ops if o["name"] == "aten::searchsorted" and o["ts"] >= r["ts"]]
        if not cums or not ends:
            continue
        lo, hi = max(cums), min(ends)
        binning_corr |= {x["args"]["correlation"] for x in runtime
                         if x["tid"] == r["tid"] and lo <= x["ts"] <= hi and "correlation" in x.get("args", {})}
    step_kernels = [k for k in kernels if k.get("args", {}).get("correlation") in launch_corr]
    by_name = defaultdict(float)
    for k in kernels:
        if t0 <= k["ts"] < t_end:
            by_name[k["name"]] += k["dur"]
    dur_of = lambda pred: sum(k["dur"] for k in step_kernels if pred(k)) / 1e6
    binning_s = dur_of(lambda k: k.get("args", {}).get("correlation") in binning_corr
                       or "expand_intersections" in k["name"])
    k1_s = dur_of(lambda k: "blend_forward" in k["name"])
    k3_s = dur_of(lambda k: "blend_backward" in k["name"])
    blocked = sum(r["dur"] for r in runtime if r["name"] in SYNC_CALLS and in_span(r["ts"]))
    host = sum(e - s for s, e in span_iv) - blocked

    # idle gaps, by the innermost host op (any thread) open at the gap's middle
    gaps = []
    prev = t0
    for s, e in busy_iv + [[t_end, t_end]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    all_ops = sorted([e for v in ops_by_tid.values() for e in v if e["name"] != STEP_MARK] + runtime,
                     key=lambda e: e["ts"])
    starts = [e["ts"] for e in all_ops]
    gap_by = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        j = bisect.bisect_right(starts, mid)
        name, best = "host_outside_any_op", None
        for o in reversed(all_ops[max(0, j - 400):j]):
            if o["ts"] + o["dur"] >= mid and (best is None or o["ts"] > best["ts"]):
                best = o
        if best is not None:
            name = best["name"]
        gap_by[name] += (e - s) / 1e6
    top = lambda d: [[k[:64], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "steps": steps, "window_s": window / 1e6, "busy_s": busy / 1e6,
        "host_s": host / 1e6, "kernels": len(step_kernels),
        "binning_s": binning_s, "k1_s": k1_s, "k3_s": k3_s,
        "breakdown": {"device_ops": top({k: v / 1e6 for k, v in by_name.items()}), "idle_gaps": top(gap_by)},
    }


@torch.no_grad()
def blend_counts(scene, traced: List[dict], clip, cfg: dict, dev) -> Dict[str, float]:
    """Slot-pixel tests and applied pairs of each traced step's training
    blend, summed, with the intersection counts the program reported."""
    from .reference import follow, plain

    if scene is None or not traced:
        return {}
    rc = cfg["recipe"]["raster"]
    W, H = cfg["frame_size"]
    p = {k: v for k, v in scene.params.items()}
    knots = scene.aux.get("spline_knots")
    stats = {"tests": 0, "applied": 0}
    C, gaussians = 0, 0
    for d in traced:
        pr, _, _, feats, bg, op_mask, _ = follow.render_inputs(p, scene.alive, knots, cfg, d["t1"], d["t2"])
        C = feats.shape[1]
        bins = plain.bin_pairs(pr, W, H, rc["block"], rc["max_tiles_per_gaussian"], cfg["max_intersections"])
        gaussians += int(torch.unique(bins.gid).numel())
        plain.blend(bins, pr.uv, pr.conic, pr.opacity, feats, bg, op_mask, W, H, rc["block"], stats=stats)
    return {"steps": len(traced), "tests": stats["tests"], "applied": stats["applied"], "channels": C,
            "gaussians": gaussians, "tiles": (-(-W // rc["block"])) * (-(-H // rc["block"])), "pixels": W * H,
            "nint": sum(min(d["nint"], cfg["max_intersections"]) for d in traced),
            "capacity": int(scene.alive.shape[0]), "param_elems": sum(v.numel() for v in p.values())}
