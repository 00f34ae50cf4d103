"""Host time of the scene's kNN scale initialisation in the set-up (the
program's `setup.knn` span, which ends at the read that waits for the card),
from the program's set-up record of the run's fit (s)."""


def read(ctx):
    try:
        from splatter_a_video_tpu_torch.utils import spans
    except ImportError:                  # a program without the port's spans
        return None
    return spans.last_setup().get("setup.knn")
