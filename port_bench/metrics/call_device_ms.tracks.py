"""Device busy time per traced call of `track_points`: the union of kernel,
copy and set intervals over the traced window (ms)."""


def read(ctx):
    s = ctx["summary"]
    return s["busy_s"] / s["steps"] * 1e3 if s["busy_s"] > 0 else None
