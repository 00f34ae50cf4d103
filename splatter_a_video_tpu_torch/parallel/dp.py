"""Data-parallel training over frame pairs (counterpart of
`splatter_a_video_tpu/parallel/dp.py`).

The JAX package's `shard_map` over a "dp" mesh axis becomes one process per
GPU in a `torch.distributed` group (`parallel/mesh.py`):

  * params and optimizer state are replicated on every rank;
  * a batch of n frame pairs (`stack_batches`, one slot per rank) comes to
    every rank, and rank d renders and differentiates slot d alone (the
    CUDA kernels K1-K4 run per rank on local shapes);
  * gradients and metrics are averaged as `pmean` averages them (one
    `all_reduce` of the sum, then a division by n), the viewspace-gradient
    sums are summed, and radii take the max (visibility = any) as in the
    reference's `render_batch`;
  * Adam runs on every rank on the identical reduced gradients, so the
    state stays replicated bit for bit.

Every rank draws its ARAP sample from the same split of the replicated key,
as in the JAX step (which splits `state.key` without folding in the chip).
Without a process group the steps run at world size 1 and reduce nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.pairs import batch_to_device
from ..device import resolve_device
from ..models.gaussians import GaussianScene
from ..train import density as _density
from ..train import losses as _losses
from ..train import optim as _optim
from ..train import prng as _prng
from ..train import trainer as _trainer
from . import mesh as _mesh


def stack_batches(batches) -> _trainer.Batch:
    """Stack n host batches into the [n, ...] batch the DP steps take (None
    fields stay None)."""
    return _trainer.Batch(*(None if xs[0] is None else np.stack([np.asarray(x) for x in xs])
                            for xs in zip(*batches)))


def local_batch(batch: _trainer.Batch, group=None, device=None) -> _trainer.Batch:
    """This rank's slot of a stacked host batch, on `device`."""
    r = _mesh.rank(group)
    return batch_to_device(_trainer.Batch(*(None if x is None else x[r] for x in batch)), device)


def _reduce(group, mean: List[torch.Tensor], total: List[torch.Tensor], maximum: List[torch.Tensor]):
    """(mean, total, maximum) over the group's ranks: the float tensors of
    `mean` and `total` in one summed `all_reduce` (`mean` then divided by
    the world size, as `pmean` does), the int tensors of `maximum` in one
    max `all_reduce`. Identity without a process group."""
    if not _mesh.is_initialized():
        return mean, total, maximum
    n = _mesh.world_size(group)
    floats = mean + total
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in floats])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out, off = [], 0
    for t in floats:
        out.append(buf[off:off + t.numel()].view(t.shape))
        off += t.numel()
    means = [t / n for t in out[: len(mean)]]
    totals = out[len(mean):]
    maxes = []
    if maximum:
        ibuf = torch.cat([t.reshape(-1) for t in maximum])
        dist.all_reduce(ibuf, op=dist.ReduceOp.MAX, group=group)
        off = 0
        for t in maximum:
            maxes.append(ibuf[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return means, totals, maxes


def _reduce_metrics(group, metrics: Dict[str, torch.Tensor], extra_mean=(), total=(), maximum=()):
    """`_reduce` with the metrics appended to the means; returns (metrics,
    means, totals, maxes)."""
    names = list(metrics)
    means, totals, maxes = _reduce(group, list(extra_mean) + [metrics[k].to(torch.float32) for k in names],
                                   list(total), list(maximum))
    k = len(extra_mean)
    return dict(zip(names, means[k:])), means[:k], totals, maxes


def make_dp_train_step(cfg: _trainer.TrainerConfig, extr: np.ndarray, group=None,
                       frames: Optional[_trainer.FrameStore] = None, device="cuda"):
    """The data-parallel train step: dp_step(state, batch) -> (state,
    metrics), where `batch` has a leading axis of the group's size (one
    frame pair per rank, `stack_batches`) and `state` is replicated. With
    `frames`, the batch may be slim (its images come from the store)."""
    dev = resolve_device(device)
    rcfg = cfg.raster_cfg()
    extr_t = torch.as_tensor(np.asarray(extr), dtype=torch.float32, device=dev)
    if frames is not None:
        frames = _trainer.FrameStore(*(None if f is None else f.to(dev) for f in frames))

    def per_pair_loss(scene: GaussianScene, params, batch: _trainer.Batch, key, step, uv_sink, abs_sink):
        """The JAX DP step's own loss sum (`dp.py:51-147`): the four terms
        always added, whatever their weights, and its own metrics."""
        sc = GaussianScene(params=params, aux=scene.aux, cfg=scene.cfg)
        inp = _trainer.scene_render_inputs(sc, batch.t1)
        p2 = sc.get_position(batch.t2)
        ex = {"track_gs": p2}
        if cfg.train_render_attributes or cfg.mask_attr_weight or cfg.dino_attr_weight:
            for name in ("mask_attribute", "pos_poly_feat", "dino_attribute"):
                if name in inp:
                    ex[name] = inp[name]
        out = _trainer._render_with_sinks(inp, extr_t, rcfg, ex, cfg.white_bg, uv_sink, abs_sink,
                                          depth_bg=cfg.depth_bg)
        pred_rgb = out.features["rgb"]
        loss_rgb = _losses.rgb_loss(pred_rgb, batch.rgb1, cfg.lambda_dssim)
        vis, _, conf = _losses.parse_tapir_track_info(batch.target_tracks[:, 2], batch.target_tracks[:, 3])
        interval = float(abs(int(batch.t2) - int(batch.t1)))
        loss_flow = _losses.tracking_loss(
            out.features["track_gs"], batch.query_px, batch.target_tracks[:, :2], vis & batch.track_valid, conf,
            interval, cfg.num_frames, cfg.height, cfg.width, quantile=cfg.track_quantile,
        )
        loss_depth = _losses.depth_loss_dpt(out.features["depth"][..., 0], batch.depth1)
        loss_arap = _losses.arap_loss(inp["position"], p2, None, k=cfg.arap_knn, sample_num=cfg.arap_sample_num,
                                      alive=sc.alive, key=key)
        loss = (cfg.loss_rgb_weight * loss_rgb + cfg.loss_flow_weight * loss_flow
                + cfg.depth_loss_weight * loss_depth + cfg.arap_weight * loss_arap)
        metrics = {"loss_rgb": loss_rgb, "psnr": _losses.psnr(pred_rgb, batch.rgb1)}
        if cfg.mask_attr_weight:
            loss_mask = torch.mean((out.features["mask_attribute"][..., 0] - batch.mask1) ** 2)
            loss = loss + cfg.mask_attr_weight * loss_mask
            metrics["loss_mask_attr"] = loss_mask
        if cfg.dino_attr_weight:
            loss_dino = torch.mean((out.features["dino_attribute"] - batch.dino1) ** 2)
            loss = loss + cfg.dino_attr_weight * loss_dino
            metrics["loss_dino_attr"] = loss_dino
        if cfg.fg_layer_weight:
            fg_sel = (inp["mask_attribute"][:, 0] > 0.5).detach()
            inp_fg = {**inp, "opacity": torch.where(fg_sel, inp["opacity"], 0.0)}
            out_fg = _trainer._render_with_sinks(
                inp_fg, extr_t, rcfg, {"mask_attribute": inp["mask_attribute"]}, False,
                uv_sink.detach(), abs_sink.detach(), depth_bg=cfg.depth_bg,
            )
            gt_mask1 = batch.mask1[..., None]
            loss_rgb_fg = torch.mean((out_fg.features["rgb"] - batch.rgb1 * gt_mask1) ** 2)
            loss_mask_fg = torch.mean((out_fg.features["mask_attribute"] - gt_mask1) ** 2)
            w_fg = cfg.fg_layer_weight if step > cfg.fg_layer_start_iter else 0.0
            loss = loss + w_fg * (loss_rgb_fg + loss_mask_fg)
            metrics["loss_rgb_fg"] = loss_rgb_fg
            metrics["loss_mask_fg"] = loss_mask_fg
        return loss, {"loss": loss, **metrics}, out.radius

    def dp_step(state: _trainer.TrainState, batch: _trainer.Batch):
        local = _trainer.resolve_batch(frames, local_batch(batch, group, dev))
        key, sub = _prng.split(state.key)
        scene = state.scene
        names = list(scene.params)
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
        N = scene.alive.shape[0]
        uv_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        abs_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        loss, metrics, radius = per_pair_loss(scene, params, local, sub, state.step, uv_sink, abs_sink)
        inputs = [params[k] for k in names] + [uv_sink]
        gs = torch.autograd.grad(loss, inputs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, gs)]
        metrics, grads, (duv,), (radius_max,) = _reduce_metrics(
            group, {k: v.detach() for k, v in metrics.items()}, gs[:-1], [gs[-1]], [radius])
        with torch.no_grad():
            new_params, opt_state = _optim.adam_update(cfg.optim, scene.params, dict(zip(names, grads)),
                                                       state.opt_state)
            # visibility = any over the ranks, radii = max (radius >= 0)
            dstate = _density.accumulate_stats(state.densify_state, radius_max > 0, radius_max,
                                               _trainer.viewspace_grad_norm(cfg, duv))
        new_scene = GaussianScene(params=new_params, aux=scene.aux, cfg=scene.cfg)
        return _trainer.TrainState(new_scene, opt_state, dstate, state.step + 1, key), metrics

    return dp_step


def make_dp_atlas_step(cfg: _trainer.TrainerConfig, extr: np.ndarray, group=None, device="cuda"):
    """Data-parallel multi-atlas step: one frame pair per rank, per-atlas
    gradients averaged, the same per-atlas Adam update on every rank. Reuses
    the single-GPU objective and update (`atlas_trainer.make_atlas_grad_fn`
    and `make_atlas_apply_fn`); radii reduce with a max alone, viewspace
    gradients are summed (`dp.py:215-219`)."""
    from ..train import atlas_trainer as _atlas

    dev = resolve_device(device)
    grad_fn = _atlas.make_atlas_grad_fn(cfg, extr, device=dev)
    apply_fn = _atlas.make_atlas_apply_fn(cfg)

    def dp_step(state, batch):
        local = local_batch(batch, group, dev)
        key, sub = _prng.split(state.key)
        grads, duv, radius, metrics = grad_fn(state.model, local, sub)
        leaves = [(n, k) for n in grads for k in grads[n]]
        metrics, flat, (duv,), (radius,) = _reduce_metrics(group, metrics, [grads[n][k] for n, k in leaves],
                                                           [duv], [radius])
        grads = {n: {} for n in grads}
        for (n, k), g in zip(leaves, flat):
            grads[n][k] = g
        return apply_fn(state, grads, duv, radius, metrics, key)

    return dp_step


def make_dp_joint_step(cfg: _trainer.TrainerConfig, extr: np.ndarray, group=None, cam_lr: float = 1e-4,
                       cam_prior_weight: float = 1e-2, cam_warmup_iters: int = 0,
                       cam_lr_warmup_scale: float = 10.0, cam_decay_steps: int = 0,
                       frames: Optional[_trainer.FrameStore] = None, device="cuda"):
    """Data-parallel camera-refine joint step: the scene's and the per-frame
    twists' gradients averaged over the ranks (each rank differentiates its
    own pair's twist rows). Reuses `camera_refine.make_joint_grad_fn` and
    `make_joint_apply_fn`; radii reduce with a max alone (`dp.py:254-260`)."""
    from ..train import camera_refine as _cam

    dev = resolve_device(device)
    grad_fn = _cam.make_joint_grad_fn(cfg, extr, cam_prior_weight, device=dev)
    apply_fn = _cam.make_joint_apply_fn(cfg, cam_lr, cam_warmup_iters, cam_lr_warmup_scale, cam_decay_steps)
    if frames is not None:
        frames = _trainer.FrameStore(*(None if f is None else f.to(dev) for f in frames))

    def dp_step(state, batch):
        local = _trainer.resolve_batch(frames, local_batch(batch, group, dev))
        key, sub = _prng.split(state.base.key)
        gp, gxi, duv, radius, metrics = grad_fn(state, local, sub)
        names = list(gp)
        metrics, flat, (duv,), (radius,) = _reduce_metrics(group, metrics, [gp[k] for k in names] + [gxi],
                                                           [duv], [radius])
        return apply_fn(state, dict(zip(names, flat[:-1])), flat[-1], duv, radius, metrics, key)

    return dp_step
