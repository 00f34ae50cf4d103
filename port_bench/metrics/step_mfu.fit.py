"""The float32 operations one train step needs (`counts/step.py`) over the
traced time per step, against the published float32 peak (%)."""

from port_bench.counts import peaks, step


def read(ctx):
    c, s = ctx["counts"], ctx["summary"]
    if not c or s["window_s"] <= 0:
        return None
    lc = ctx["cfg"]["recipe"]["loss"]
    n = c["steps"]
    ops = step.step_ops(c["tests"] / n, c["applied"] / n, c["nint"] / n, c["channels"], c["pixels"],
                        c["capacity"], c["param_elems"], lc["arap_sample_num"] if lc["arap_weight"] else 0)
    return 100.0 * ops / (s["window_s"] / s["steps"]) / peaks.FP32_FLOPS_PER_S
