"""The benchmark of `splatter_a_video_tpu_torch`, one run of one cell:

    python3 port_bench/run.py --workload fit_2160p --seed 7 --seconds 10 --trace 0

from the root of a checkout, on a machine with an NVIDIA GPU (it exits with
code 2, and prints no result, without one or with fewer than the cell asks
for). A cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`port_bench/configs/<name>.json`) and a traffic mix
(`port_bench/traffic/<name>.json`). The configuration names the program's
entry point that the cell drives, its `entry` (`fit` where it names none),
and the run hands the cell to `port_bench/entries/<entry>.py`, found by
name (`manifest.py`), whose `run` sets up, measures the window, checks the
window's answers against the plain reference (`reference/`) and, with
`--trace 1`, traces part of the window. The keys of the traffic file and of
the limits (`port_bench/limits/<configuration>.json`) belong to the entry.
A new entry point is new files and entries only: `entries/<entry>.py`, its
configuration, traffic and limits, its reference and counts, its readers,
its CPU case `tests/tiny_<entry>.py`, and its cells and metrics in
`BENCHMARK.json` (`manifest.py` lists them); a new cell that reports an
end-to-end metric that is already there appends its name to that metric's
`workloads`.

  * `fit` (`harness.py`): the program's `train.fit.fit_clip` on the cell's
    clip (`clip.py`, made on the GPU from `--seed`); the first `warm_steps`
    steps (the first density event among them) are set-up, the window
    measures the steps of the next `--seconds` seconds; the reference
    follows the initial scene, the first train steps and the first density
    event (`compare.py`). Reports `fit_ms_per_step` and `setup_s`.
  * `tracks` (`entries/tracks.py`): the program's `nets.tapir.track_points`
    on the clip's queries in `compute_tracks`' order, `queries_per_call` a
    call; `warm_calls` calls are set-up, the window runs whole calls for
    `--seconds` seconds; the reference (`reference/tapir.py`) tracks a
    sample of the window's queries drawn from the seed. Reports
    `preprocess_ms_per_frame` and `setup_s`.

The run reports the end-to-end metrics that `BENCHMARK.json` gives the cell
(`manifest.metrics_for`), and refuses to print a result where the entry
gives fewer. With `--trace 1` it traces part of the window with
`torch.profiler` into a Chrome trace under `$TMPDIR` (tens of MB, deleted
once read) and reports the cell's per-layer metrics (`metrics/<name>.py`)
in place of the end-to-end ones.

Standard error carries, in order: the card's name and power limit
(`[card]`), each set-up phase as it ends (`[phase] ...`), the program's own
lines, the entry's summary (the fit: `[event]` per density event,
`[window]`, `[setup]`; the tracks: `[window]`, `[setup]`), all phase times
and the reference's time (`[phases] ...`), then, as its last lines, each
number compared beside its limit (`[check] name value <= limit ok|FAIL`).
The last line of standard output is the result: `correct`, `attempted` (the
window's steps or queries), `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `check`, the numbers compared, each as
[value, limit].

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


def result(man: dict, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
           here: str = HERE):
    """Run one cell through its entry point (`manifest.entry`): the result
    line's fields and the numbers compared. No look for a card here."""
    from port_bench import manifest as mf

    wl = mf.cell(man, workload)
    cfg = mf.config(wl["config"], here)
    ent = mf.entry(mf.entry_name(cfg), here)
    tr, lim = mf.traffic(wl["traffic"], here), mf.limits(wl["config"], here)
    readers = mf.readers(man, workload, here) if trace else {}
    out = ent.run(cfg, tr, lim, seed, seconds, trace, device, t_start, readers)
    if trace:
        units = {m["name"]: m["unit"] for m in man["per_layer"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["per_layer"].items()}
    else:
        e2e = mf.metrics_for(man, workload, "end_to_end")
        missing = [m["name"] for m in e2e if m["name"] not in out["metrics"]]
        if missing:
            raise RuntimeError(f"the {mf.entry_name(cfg)} entry gives no {', '.join(missing)}")
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]} for m in e2e}
    import torch

    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    res = {"correct": all(c["ok"] for c in out["check"]), "attempted": out["attempted"],
           "failed": out.get("failed", 0), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind, "count": 1,
                      "memory_peak_bytes": int(out["memory_peak_bytes"])}}
    if trace:
        res["device"]["busy_s"], res["device"]["window_s"] = out["busy_s"], out["window_s"]
        res["breakdown"] = out["breakdown"]
    return res, out


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
    card = _card()
    print(f"[card] {card}", file=sys.stderr, flush=True)

    res, out = result(man, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    res["card"] = card
    print("[phases] " + " ".join(f"{k} {v!r}" for k, v in out["phases"].items()), file=sys.stderr)
    for c in out["check"]:
        print(f"[check] {c['name']} {c['value']!r} <= {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    res["check"] = {c["name"]: [c["value"], c["limit"]] for c in out["check"]}
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
