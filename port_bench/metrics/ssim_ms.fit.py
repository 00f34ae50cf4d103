"""Stream time per traced step of the rgb loss, L1 + D-SSIM (the program's
`step.loss.rgb` span, forward and backward), from the program's record of
the traced window (ms)."""


def read(ctx):
    try:
        from splatter_a_video_tpu_torch.utils import spans
    except ImportError:                  # a program without the port's spans
        return None
    w = spans.last_window()
    s = w["spans"].get("step.loss.rgb")
    if not w["steps"] or s is None or s["stream_s"] is None:
        return None
    return s["stream_s"] / w["steps"] * 1e3
