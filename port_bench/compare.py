"""The comparison that decides `correct`.

The numbers, each against a limit of its own (`limits/<configuration>.json`,
set in `PERF.md` from the program's readings over a dozen seeds and the
control's):

  * `loss_gap`: the largest relative gap of a checked step's loss;
  * `grad_gap`: per attribute, the gap between the norms of the first
    gradient (the program's from Adam's first moment after one step), over
    the reference's norm of that attribute or of the median attribute,
    whichever is larger; the largest over the attributes;
  * `change_gap`: the same for the norm of each attribute's change after the
    checked steps, over the attributes whose reference gradient is at least
    a thousandth of the median attribute's;
  * `pairs_gap`: checked steps whose frame pair differs from the seed's;
  * `event_alive_gap`, `event_count_gap`: slots whose liveness differs after
    the first density event, and the summed gap of its five counts;
  * `event_param_gap`: the largest gap of an attribute after the event, over
    that attribute's largest magnitude;
  * `event_moments_left`: newly used slots whose Adam moments were not
    zeroed by the event;
  * `capacity_gap`, `alive_gap`: the program's scene against the sizes the
    configuration states;
  * `init_alive_gap`: slots whose liveness differs between the program's
    initial scene and the one the reference works out from the clip
    (`reference/scene.py`);
  * `init_scaling_gap`: the norm of the gap of the initial scales (the kNN
    scale initialisation) over the reference's norm;
  * `init_param_gap`: the same for every other initial attribute and the
    spline knots, the largest (an attribute that is zero in the reference
    and not in the program reads 1e30).

The train steps start from the program's initial scene, checked by itself
against the reference's (the `init_*` numbers): see `PERF.md`.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from .reference import follow as _follow
from .reference import scene as _scene

COUNTS = ("num_cloned", "num_split", "num_pruned", "dropped", "num_alive")


def _norm_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def step_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the checked train steps: the program's (or a
    control's) readings against the reference's."""
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _norm_gaps(prog["grad_norms"], g_ref, g_ref),
        "change_gap": _norm_gaps(prog["change_norms"], ref["change_norms"], moving),
        "pairs_gap": float(sum(a != b for a, b in zip(prog["pairs"], ref["pairs"]))
                           + abs(len(prog["pairs"]) - len(ref["pairs"]))),
    }


def event_numbers(post: Optional[dict], ref: Optional[dict], dev) -> Dict[str, float]:
    if post is None or ref is None:
        return {"event_alive_gap": 1e30, "event_count_gap": 1e30,
                "event_param_gap": 1e30, "event_moments_left": 1e30}
    alive_gap = int((post["alive"].to(dev) != ref["alive"]).sum())
    count_gap = sum(abs(post["counts"][k] - ref["counts"][k]) for k in COUNTS)
    param_gap = 0.0
    for k, v in ref["params"].items():
        p = post["params"][k].to(dev)
        scale = float(v.abs().max()) if v.numel() else 0.0
        param_gap = max(param_gap, float((p - v).abs().max()) / max(scale, 1e-12) if v.numel() else 0.0)
        del p
    return {"event_alive_gap": float(alive_gap), "event_count_gap": float(count_gap),
            "event_param_gap": param_gap, "event_moments_left": float(post["moments_left"])}


def _gap(p: Optional[torch.Tensor], r: Optional[torch.Tensor]) -> float:
    if p is None and r is None:
        return 0.0
    if p is None or r is None or p.shape != r.shape:
        return 1e30
    d = float(torch.linalg.vector_norm((p.to(r.device) - r).double()))
    n = float(torch.linalg.vector_norm(r.double()))
    return 0.0 if d == 0.0 else (d / n if n > 0.0 else 1e30)


def init_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The program's initial scene (`params`, `alive`, `knots`) against the
    reference's."""
    pa, ra = prog["alive"].to(ref["alive"].device), ref["alive"]
    if pa.shape != ra.shape:
        return {"init_alive_gap": 1e30, "init_scaling_gap": 1e30, "init_param_gap": 1e30}
    gaps = {k: _gap(prog["params"].get(k), ref["params"].get(k)) for k in set(prog["params"]) | set(ref["params"])}
    gaps["spline_knots"] = _gap(prog["knots"], ref["knots"])
    scaling = gaps.pop("scaling")
    return {"init_alive_gap": float((pa != ra).sum()), "init_scaling_gap": scaling,
            "init_param_gap": max(gaps.values())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """Each number beside its limit, in a fixed order."""
    return [{"name": k, "value": numbers[k], "limit": limits[k], "ok": numbers[k] <= limits[k]}
            for k in sorted(numbers)]


def check(prog: dict, init: dict, event_pre: Optional[dict], clip, cfg: dict, limits: dict, seed: int,
          steps: int, dev) -> dict:
    """Run the reference after the window and compare: {"check": each
    number beside its limit, "ref_init": the reference's initial scene,
    "ref": its steps, "event_ref": its event}."""
    nums = {"capacity_gap": float(abs(int(init["alive"].shape[0]) - cfg["capacity"])),
            "alive_gap": float(abs(int(init["alive"].sum()) - cfg["alive_at_start"]))}
    ref_init = _scene.initial_scene(clip, cfg, seed, dev)
    nums.update(init_numbers(init, ref_init))
    ref = _follow.follow(init, clip, cfg, seed, steps, dev)
    nums.update(step_numbers(prog, ref))
    ev = _follow.event(event_pre, cfg, dev) if event_pre is not None else None
    nums.update(event_numbers(prog.get("event_post"), ev, dev))
    return {"check": verdict(nums, limits), "ref_init": ref_init, "ref": ref, "event_ref": ev}
