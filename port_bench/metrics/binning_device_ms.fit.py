"""Device time per traced step in the binning: the prefix sum of tile
counts, K2, the sort of the intersection keys and the `searchsorted` of the
tile edges (ms)."""


def read(ctx):
    s = ctx["summary"]
    return s["binning_s"] / s["steps"] * 1e3 if s["binning_s"] > 0 else None
