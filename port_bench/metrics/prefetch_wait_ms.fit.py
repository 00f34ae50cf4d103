"""Host time per traced step spent waiting on the prefetch queue for the
next batch (the program's `fit.batch_wait` span), from the program's record
of the traced window (ms)."""


def read(ctx):
    try:
        from splatter_a_video_tpu_torch.utils import spans
    except ImportError:                  # a program without the port's spans
        return None
    w = spans.last_window()
    s = w["spans"].get("fit.batch_wait")
    if not w["steps"] or s is None:
        return None
    return s["host_s"] / w["steps"] * 1e3
