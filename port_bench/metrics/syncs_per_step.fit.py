"""Blocking host/device crossings per traced step (the program's `sync`
counter), from the program's record of the traced window, as a count."""


def read(ctx):
    try:
        from splatter_a_video_tpu_torch.utils import spans
    except ImportError:                  # a program without the port's spans
        return None
    w = spans.last_window()
    if not w["steps"]:
        return None
    return w["counters"].get("sync", 0) / w["steps"]
