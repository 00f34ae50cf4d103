"""The host's own time per traced step: the step spans less the time spent
blocked in synchronising CUDA calls (ms)."""


def read(ctx):
    s = ctx["summary"]
    return s["host_s"] / s["steps"] * 1e3
