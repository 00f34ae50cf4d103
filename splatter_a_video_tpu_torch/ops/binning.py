"""Tile binning + depth sorting (counterpart of
`splatter_a_video_tpu/ops/binning.py`).

The pipeline is the reference CUDA rasterizer's, which a GPU runs well:

  1. clamp per-Gaussian tile counts to `max_tiles_per_gaussian`;
  2. exclusive prefix `offs` (torch.cumsum);
  3. kernel K2 (`rasterize_gpu.expand_intersections`) writes each slot's
     owner and its int64 key `tile << 32 | f32 depth bits`;
  4. one stable `torch.sort` of the keys: tile-major, depth-ascending,
     ties broken by Gaussian index;
  5. per-tile [start, end) `edges` by `torch.searchsorted`.

Depth order is by the full f32 depth, then index. That equals the JAX
package's `sort_mode="exact"` and its presorted path. At full size
(854x480, 131k capacity) the JAX default instead takes its two-scatter
path with a 20-bit truncated depth key tie-broken by index
(`binning.py:344-353,407-412`), so there the two packages can order
Gaussians whose depths agree in their top 20 bits differently
(PARITY.md deviation #1); the port is the closer of the two to the
reference.

The `Binning` fields that only the TPU needed (`packed`, `chunk_base`,
`perm`) are gone: the blend kernel gathers per-Gaussian records itself and
there is no chunked stream. `order`, the sort's permutation, is the
counterpart of JAX's `prepos`: the backward's per-Gaussian reduction
inverts it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rasterize_gpu as _rgpu
from .projection import tile_grid


class Binning(NamedTuple):
    """Sorted intersection stream for one camera view."""

    gid: torch.Tensor                # [M] int32 Gaussian ids in tile/depth order (-1 = padding)
    edges: torch.Tensor              # [T + 1] int32 per-tile [start, end) into gid
    offs: torch.Tensor               # [N] int32 exclusive prefix of tiles
    tiles: torch.Tensor              # [N] int32 clamped per-Gaussian tile counts
    order: torch.Tensor              # [M] int64 sorted position -> pre-sort slot
    num_intersections: torch.Tensor  # [] int32 true count (may exceed M: saturation)
    num_tiles_x: int
    num_tiles_y: int


def bin_intersections(
    depth: torch.Tensor,
    tiles: torch.Tensor,
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    W: int,
    H: int,
    max_intersections: int,
    max_tiles_per_gaussian: int = 64,
    block=16,
) -> Binning:
    """Build the sorted intersection stream.

    Args:
      depth: [N] camera depths (0 = culled); negatives key as 0.
      tiles/rect_min/rect_max: EWA tile footprints.
      max_intersections: slot budget M. Overflow drops the slots past M in
        Gaussian-index order; `num_intersections` reports the true count.
    """
    tgx, tgy = tile_grid(W, H, block)
    T = tgx * tgy
    M = max_intersections
    dev = depth.device
    tiles = torch.clamp_max(tiles.to(torch.int32), max_tiles_per_gaussian).contiguous()
    incl = torch.cumsum(tiles, 0, dtype=torch.int32)
    offs = incl - tiles
    total = incl[-1] if tiles.shape[0] else torch.zeros((), dtype=torch.int32, device=dev)
    keys, slot_gid = _rgpu.expand_intersections(
        offs, tiles,
        rect_min.to(torch.int32).contiguous(), rect_max.to(torch.int32).contiguous(),
        depth.to(torch.float32).contiguous(), M, tgx,
    )
    sorted_keys, order = torch.sort(keys, stable=True)
    gid = slot_gid[order]
    bounds = torch.arange(T + 1, dtype=torch.int64, device=dev) << 32
    edges = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    return Binning(
        gid=gid,
        edges=edges,
        offs=offs,
        tiles=tiles,
        order=order,
        num_intersections=total,
        num_tiles_x=tgx,
        num_tiles_y=tgy,
    )
