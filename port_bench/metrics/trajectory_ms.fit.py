"""Stream time per traced step of the render inputs: trajectories at both
instants, activations, SH (the program's `step.render_inputs` span, forward
and backward), from the program's record of the traced window (ms)."""


def read(ctx):
    try:
        from splatter_a_video_tpu_torch.utils import spans
    except ImportError:                  # a program without the port's spans
        return None
    w = spans.last_window()
    s = w["spans"].get("step.render_inputs")
    if not w["steps"] or s is None or s["stream_s"] is None:
        return None
    return s["stream_s"] / w["steps"] * 1e3
