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


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on `device` (None: where it is); to a GPU through pinned
    memory and a non-blocking copy, so the host does not wait for the card."""
    if device is None:
        return x
    dev = torch.device(device)
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)
