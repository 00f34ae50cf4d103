"""The benchmark of `splatter_a_video_tpu_torch`, one run of one cell:

    python3 port_bench/run.py --workload fit_2160p --seed 7 --seconds 10 --trace 0

from the root of a checkout, on a machine with an NVIDIA GPU (it exits with
code 2, and prints no result, without one or with fewer than the cell asks
for). A cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`port_bench/configs/<name>.json`) and a traffic mix
(`port_bench/traffic/<name>.json`). The run:

  1. makes the cell's clip on the GPU from `--seed` (`clip.py`) and hands it
     to the program as a `VideoFlowData`;
  2. calls the program's `train.fit.fit_clip` with the configuration; the
     fit lifts the tracks, builds the scene and trains, and the first
     `warm_steps` steps (the first density event among them) are set-up;
  3. measures the steps of the next `--seconds` seconds (a synchronize at
     both ends) and stops the fit;
  4. reads the device's peak memory, frees the program's state, and runs
     the plain reference (`reference/`: the initial scene from the clip,
     the first train steps, the first density event) to decide `correct`
     (`compare.py`).

With `--trace 1` it also traces `trace_steps` steps of the window with
`torch.profiler` into a Chrome trace under `$TMPDIR` (tens of MB, deleted
once read) and reports the per-layer metrics (`metrics/<name>.py`) in
place of the end-to-end ones.

Standard error carries, in order: the card's name and power limit
(`[card]`), each set-up phase as it ends (`[phase] clip_s ...`, `lift_s`,
`scene_s`, `first_step_at`), the program's own lines (density events and
the saturation latch), one line per density event (`[event] step ...`),
the window (`[window] steps ... fit_ms_per_step ...`), the set-up and scene
sizes (`[setup] ...`), all phase times and the reference's time
(`[phases] ...`), then, as its last lines, each number compared beside its
limit (`[check] name value <= limit ok|FAIL`). The last line of standard
output is the result: `correct`, `attempted` (the window's steps),
`failed`, `metrics`, `device`, with `--trace 1` also `breakdown`, and last
`check`, the numbers compared, each as [value, limit].

Build and kernel caches stay inside the checkout: the program builds its
kernels into `splatter_a_video_tpu_torch/_build/`, and any Triton or
extension cache goes to `port_bench/_cache/`. The run sets
`PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True` unless it is set: the
program's set-up leaves blocks its step could not reuse otherwise.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "splatter_a_video_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: `splatter_a_video_tpu_torch` is not one)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's set-up leaves large cached blocks (its kNN over every
    # initial point) that a fixed-size allocator cannot reuse for the step
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    cache = os.path.join(HERE, "_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    sys.path.insert(0, ROOT)
    from port_bench import manifest as mf

    man = mf.load_manifest(ROOT)
    wl = mf.cell(man, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"port_bench: the cell needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cfg = mf.config(wl["config"])
    tr = mf.traffic(wl["traffic"])
    lim = mf.limits(wl["config"])
    readers = mf.readers(man, args.workload) if args.trace else {}
    card = _card()
    print(f"[card] {card}", file=sys.stderr, flush=True)

    from port_bench import harness

    out = harness.run_cell(cfg, tr, lim, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                           readers, list(readers))
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    for e in out["events"]:
        print("[event] " + " ".join(f"{k} {v}" for k, v in e.items()), file=sys.stderr)
    print(f"[window] steps {out['steps']} seconds {args.seconds} fit_ms_per_step {out['fit_ms_per_step']!r}",
          file=sys.stderr)
    print(f"[setup] setup_s {out['setup_s']!r} capacity {out['capacity']} alive_at_start {out['alive_at_start']}"
          f" memory_peak_bytes {out['memory_peak_bytes']}", file=sys.stderr)
    correct = all(c["ok"] for c in out["check"])
    if args.trace:
        units = {m["name"]: m["unit"] for m in man["per_layer"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["per_layer"].items()}
    else:
        units = {m["name"]: m["unit"] for m in man["end_to_end"]}
        metrics = {k: {"value": out[k], "unit": units[k]} for k in ("fit_ms_per_step", "setup_s")
                   if k in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": out["steps"], "failed": 0, "metrics": metrics, "device": device,
              "card": card}
    if args.trace:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
        result["breakdown"] = out["breakdown"]
    print("[phases] " + " ".join(f"{k} {v!r}" for k, v in out["phases"].items()), file=sys.stderr)
    for c in out["check"]:
        print(f"[check] {c['name']} {c['value']!r} <= {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    result["check"] = {c["name"]: [c["value"], c["limit"]] for c in out["check"]}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
