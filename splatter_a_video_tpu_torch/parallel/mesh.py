"""Process groups for multi-GPU scaling (counterpart of
`splatter_a_video_tpu/parallel/mesh.py`).

The JAX package's 1-D device mesh over the "dp" axis becomes one process
per GPU, the `torchrun` idiom: each process drives one card and the ranks
meet in a `torch.distributed` process group (NCCL on the card, gloo on the
CPU). Without a process group, or in a group of one, every helper answers
for a single rank, the mesh of size 1.

    torchrun --nproc_per_node 4 -m splatter_a_video_tpu_torch.apps.train --distributed ...

`init_process_group` reads `torchrun`'s environment (`RANK`, `WORLD_SIZE`,
`MASTER_ADDR`, `MASTER_PORT`), or meets the other ranks through a
`FileStore` at a path the caller names; one rank needs no network.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """Ranks in `group` (default: the world), 1 without a process group."""
    return dist.get_world_size(group) if is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in `group` (default: the world), 0 without one."""
    return dist.get_rank(group) if is_initialized() else 0


def local_device(device="cuda") -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` under torchrun, else `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def init_process_group(backend: Optional[str] = None, store_path: Optional[str] = None,
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       timeout_s: float = 300.0) -> None:
    """Join (or, at world size 1, open) the default process group.

    backend: "nccl" or "gloo" (default: nccl when CUDA is present). With
    `store_path` the ranks meet in a `FileStore` there and `rank` /
    `world_size` default to 0 / 1; without it, `torchrun`'s environment
    variables give them.
    """
    if is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = timedelta(seconds=timeout_s)
    if store_path is not None:
        r = 0 if rank is None else rank
        n = 1 if world_size is None else world_size
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=r, world_size=n, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None):
    """The data-parallel group over the first `n_devices` ranks (default:
    all; the world group itself, None, when that is every rank). `backend`
    makes a group of another backend over the same ranks, such as gloo
    beside an NCCL world."""
    n = world_size() if n_devices is None else n_devices
    if n == world_size() and backend is None:
        return None
    return dist.new_group(ranks=list(range(n)), backend=backend)
