"""The fit entry: `train.fit.fit_clip` with the cell's configuration, run by
`harness.run_cell` (its docstring says how), reporting `fit_ms_per_step`
and `setup_s`."""

import sys

from port_bench import harness

TRAFFIC_KEYS = ("warm_steps", "check_steps", "trace_skip", "trace_steps")
LIMIT_KEYS = ("loss_gap", "grad_gap", "change_gap")


def run(cfg, traffic, limits, seed, seconds, trace, device, t_start, readers):
    out = harness.run_cell(cfg, traffic, limits, seed, seconds, trace, device, t_start, readers, list(readers))
    say = lambda msg: print(msg, file=sys.stderr)
    for e in out["events"]:
        say("[event] " + " ".join(f"{k} {v}" for k, v in e.items()))
    say(f"[window] steps {out['steps']} seconds {seconds} fit_ms_per_step {out['fit_ms_per_step']!r}")
    say(f"[setup] setup_s {out['setup_s']!r} capacity {out['capacity']} alive_at_start {out['alive_at_start']}"
        f" memory_peak_bytes {out['memory_peak_bytes']}")
    out["metrics"] = {"fit_ms_per_step": out["fit_ms_per_step"], "setup_s": out["setup_s"]}
    out["attempted"] = out["steps"]
    return out
