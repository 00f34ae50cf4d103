"""The float32 operations the traced calls' results need (`counts/tapir.py`:
each query's cost volume, head and PIPs iterations, and the video's feature
grids once, shared by all of its queries) over the traced window, against
the published float32 peak (%)."""

from port_bench.counts import peaks, tapir


def read(ctx):
    s = ctx["summary"]
    if s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    m, T = ctx["cfg"]["model"], ctx["frames"]
    n = ctx["calls"] * ctx["queries_per_call"]
    ops = n * tapir.query_ops(m, T) + tapir.grid_ops(m, T) * n / ctx["queries_total"]
    return 100.0 * ops / s["window_s"] / peaks.FP32_FLOPS_PER_S
