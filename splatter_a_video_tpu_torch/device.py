"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    Raises instead of quietly falling back to the CPU when a CUDA device is
    asked for (the entry points' default) and none is present.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is available;"
            " pass device='cpu' to run the plain PyTorch path"
        )
    return dev
