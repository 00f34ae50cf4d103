"""Kernel launches per traced step, as a count."""


def read(ctx):
    s = ctx["summary"]
    return s["kernels"] / s["steps"] if s["kernels"] else None
