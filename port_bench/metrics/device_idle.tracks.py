"""The share of the traced calls' window with nothing running on the device (%)."""


def read(ctx):
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s["busy_s"] > 0 else None
