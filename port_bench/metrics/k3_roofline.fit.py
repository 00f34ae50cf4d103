"""K3's least time (operations or bytes, `counts/blend.py`) over its traced
device time, summed over the traced steps (%)."""

from port_bench.counts import blend


def read(ctx):
    c, s = ctx["counts"], ctx["summary"]
    if not c or s["k3_s"] <= 0:
        return None
    n = c["steps"]
    ops, nbytes = blend.k3(c["tests"], c["applied"], c["nint"], c["tiles"] * n, c["gaussians"], c["pixels"] * n,
                           c["channels"])
    return 100.0 * blend.least_s(ops, nbytes) / s["k3_s"]
