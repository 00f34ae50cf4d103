"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from .utils import spans as _spans


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
    memory and a non-blocking copy, so the host does not wait for the card.
    Counted as `h2d_async` while spans record."""
    if device is None:
        return x
    _spans.count("h2d_async")
    dev = torch.device(device)
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


def blocking_to(x, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)`. Of host data (a
    Python value or a CPU tensor) on a GPU that is one blocking copy, which
    waits for the card to finish its queue: counted as a `sync` while spans
    record (on the CPU too, where it costs nothing)."""
    if not (isinstance(x, torch.Tensor) and x.device.type != "cpu"):
        _spans.count("sync")
    return torch.as_tensor(x, dtype=dtype, device=device)


def hardware(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them, or "cpu"."""
    import subprocess

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
