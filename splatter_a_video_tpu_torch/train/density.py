"""Adaptive density control under a fixed capacity (counterpart of
`splatter_a_video_tpu/train/density.py`): clone, split, prune and the
opacity reset, with the same semantics:

  * arrays stay at `capacity`; `alive` is the live mask; children go to
    free slots, clones first, each class hottest first; surplus candidates
    are dropped and reported (`DensifyInfo.dropped` undercounts as in the
    JAX package: it counts candidates, not split parents kept alive);
  * a split parent is removed only when all its children were placed;
  * the world-size prune waits for step > opacity_reset_interval unless
    `size_prune_always`; the screen-radius prune never fires (see the JAX
    module for why);
  * Adam moments of newly used slots are zeroed.

The split children's N(0, 1) noise is a [capacity, 3] tensor passed in, or
drawn from a JAX-compatible key (`prng.normal`) as the JAX package draws it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from ..device import to_device
from ..models.gaussians import GaussianScene
from ..ops.quaternion import inverse_sigmoid, quat_normalize, quat_to_rotmat
from . import prng
from .optim import AdamState, zero_moments_at


@dataclass(frozen=True)
class DensifyConfig:
    """Production values from `frag_gs_v10.yaml:26-39`; see the JAX
    module for the reasons behind `cameras_extent`, `size_prune_always`,
    `max_growth_frac` and `saturation_stop`."""

    percent_dense: float = 0.001
    split_num: int = 2
    densify_start_iter: int = 500
    densify_stop_iter: int = 100000
    prune_interval: int = 100
    duplicate_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.05
    cameras_extent: float = 5.0
    max_radii2d_px: float = 20.0
    size_prune_always: bool = False
    max_growth_frac: float = 0.0
    saturation_stop: float = 0.97


class DensifyState(NamedTuple):
    max_radii2d: torch.Tensor      # [cap] f32
    pos_grad_accum: torch.Tensor   # [cap] f32
    denom: torch.Tensor            # [cap] f32


class DensifyInfo(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    dropped: torch.Tensor          # candidates that found no free slot
    num_alive: torch.Tensor


def init_state(capacity: int, device=None) -> DensifyState:
    z = torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DensifyState(z, z, z)


def accumulate_stats(state: DensifyState, visibility, radii, viewspace_grad_norm) -> DensifyState:
    """Per-step update: max 2D radius, summed viewspace grad norm and visit
    count over the visible slots."""
    vis = visibility.to(torch.float32)
    return DensifyState(
        max_radii2d=torch.maximum(state.max_radii2d, radii.to(torch.float32) * vis),
        pos_grad_accum=state.pos_grad_accum + viewspace_grad_norm * vis,
        denom=state.denom + vis,
    )


def _place_candidates(scene_params: Dict[str, torch.Tensor], alive, cand_parent, cand_is_split,
                      noise, split_num: int, max_new=None):
    """Scatter the candidates' children into free slots. Returns (params,
    used_mask, n_placed, n_cand, n_free)."""
    cap = alive.shape[0]
    dev = alive.device
    free = torch.nonzero(~alive).reshape(-1)
    free_idx = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    free_idx[: free.shape[0]] = free
    n_free = torch.sum(~alive)
    n_cand = torch.sum(cand_parent >= 0)
    n_placed = torch.minimum(n_free, n_cand)
    if max_new is not None:
        n_placed = torch.minimum(n_placed, max_new)

    j = torch.arange(cap, device=dev)
    placed = (j < n_placed) & (cand_parent >= 0)
    dst = free_idx[placed]
    src = torch.where(cand_parent >= 0, cand_parent, 0)

    # split children: positions resampled from N(0, scale) in the parent's frame
    scaling_act = torch.exp(scene_params["scaling"][src])
    Rm = quat_to_rotmat(quat_normalize(scene_params["rotation"][src]))
    split_pos_off = torch.einsum("nij,nj->ni", Rm, noise * scaling_act)
    # the children's shrink, log(0.8 * split_num), is taken on the CPU: the
    # card's float32 log of 1.6 lies one ulp from the CPU's (and JAX's)
    shrink = torch.log(torch.tensor(0.8 * split_num, dtype=torch.float32)).to(dev)
    new_params = {}
    for name, val in scene_params.items():
        if val.dim() == 0 or val.shape[0] != cap:
            new_params[name] = val   # a shared, non-per-Gaussian parameter
            continue
        child = val[src]
        if name == "position":
            child = torch.where(cand_is_split[:, None], child + split_pos_off, child)
        elif name == "scaling":
            child = torch.where(cand_is_split[:, None], child - shrink, child)
        out = val.clone()
        out[dst] = child[placed]
        new_params[name] = out
    used = torch.zeros((cap,), dtype=torch.bool, device=dev)
    used[dst] = True
    return new_params, used, n_placed, n_cand, n_free


def _lexsort(keys):
    """Indices that sort by the last key, then the one before, ... (stable,
    as `jnp.lexsort`)."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


@torch.no_grad()
def densify_and_prune(scene: GaussianScene, opt_state: AdamState, state: DensifyState, step: int,
                      cfg: DensifyConfig, noise: Optional[torch.Tensor] = None,
                      key: Optional[torch.Tensor] = None):
    """One density-control event: (scene, opt_state, densify state, info).
    `noise` [capacity, 3] N(0, 1) draws for split children, drawn from
    `key` when not given."""
    cap = scene.alive.shape[0]
    dev = scene.alive.device
    alive = scene.alive
    params = scene.params
    if noise is None:
        noise = to_device(prng.normal(key, (cap, 3)), dev)

    grads = torch.where(state.denom > 0, state.pos_grad_accum / state.denom, 0.0)
    grads = torch.nan_to_num(grads)
    max_scale = torch.max(torch.exp(params["scaling"]), dim=-1).values
    dense_limit = cfg.percent_dense * cfg.cameras_extent
    hot = alive & (grads >= cfg.densify_grad_threshold)
    split_mask = hot & (max_scale > dense_limit)

    # candidates: clones (hottest first), then splits (hottest first)
    sn = cfg.split_num
    n_child = torch.where(hot, torch.where(split_mask, sn, 1), 0)
    prio = torch.where(hot, grads, float("-inf"))
    order = _lexsort(((-prio), (split_mask & hot).to(torch.int8), (~hot).to(torch.int8)))
    n_child_o = n_child[order]
    cum = torch.cumsum(n_child_o, 0)
    c = torch.arange(cap, device=dev)
    pj = torch.searchsorted(cum, c, right=True)
    valid = c < cum[-1]
    parent = order[torch.clamp_max(pj, cap - 1)]
    cand_parent = torch.where(valid, parent, -1)
    cand_is_split = valid & split_mask[parent]

    max_new = None
    if cfg.max_growth_frac > 0:
        max_new = torch.ceil(cfg.max_growth_frac * torch.sum(alive).to(torch.float32)).to(torch.int64)
    new_params, used, n_placed, n_cand, _ = _place_candidates(
        params, alive, cand_parent, cand_is_split, noise, sn, max_new=max_new)
    alive = alive | used

    # split parents whose children were all placed (placement is a prefix)
    inv_order = torch.argsort(order)
    start_slot = (cum - n_child_o)[inv_order]
    parent_removed = split_mask & (start_slot + sn <= n_placed)
    alive = alive & ~parent_removed

    # prune: low opacity; world size only after the first opacity reset
    opacity_act = torch.sigmoid(new_params["opacity"][:, 0])
    size_prune = torch.max(torch.exp(new_params["scaling"]), dim=-1).values > 0.1 * cfg.cameras_extent
    if not cfg.size_prune_always:
        size_prune = size_prune & (step > cfg.opacity_reset_interval)
    prune = ((opacity_act < cfg.min_opacity) | size_prune) & ~used
    n_pruned = torch.sum(prune & alive)
    alive = alive & ~prune

    opt_state = zero_moments_at(opt_state, used)
    aux = dict(scene.aux)
    aux["alive"] = alive
    new_scene = GaussianScene(params=new_params, aux=aux, cfg=scene.cfg)
    info = DensifyInfo(
        num_cloned=torch.sum((c < n_placed) & valid & ~cand_is_split),
        num_split=torch.sum(parent_removed),
        num_pruned=n_pruned,
        dropped=n_cand - n_placed,
        num_alive=torch.sum(alive),
    )
    return new_scene, opt_state, init_state(cap, dev), info


@torch.no_grad()
def reset_opacity(scene: GaussianScene, opt_state: AdamState, max_value: float = 0.01):
    """Clamp opacities to <= max_value and restart their Adam moments."""
    op = torch.sigmoid(scene.params["opacity"])
    params = dict(scene.params)
    params["opacity"] = inverse_sigmoid(torch.clamp_max(op, max_value))
    opt_state = zero_moments_at(opt_state, torch.ones_like(scene.alive), names=("opacity",))
    return GaussianScene(params=params, aux=scene.aux, cfg=scene.cfg), opt_state

