"""Camera refinement: per-frame se(3) twists of the camera pose (counterpart
of `splatter_a_video_tpu/train/camera_refine.py`).

  * `refine_camera_poses` recovers per-frame twists against a fixed scene
    by the photometric loss;
  * `make_joint_train_step` optimises the scene and the twists together,
    with the train step's losses (`trainer.compute_losses`) and density
    statistics.

A twist xi in R^6 is left-composed onto the canonical extrinsic
(`utils/pose.apply_se3_to_extrinsic`); xi = 0 is the identity. The twist
gradient reaches the blend through K3 + K4 -> uv / conic ->
`project_ortho` / `ewa_ortho`, which take the refined extrinsic.

The twists' Adam is optax's: eps 1e-8, and the learning rate of update k
(counting from 0) is the schedule read at k, with the schedule built as
`make_cam_optimizer` builds it in the JAX package (a constant warm-up
lr joined to a cosine decay or a constant).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussians import GaussianScene
from ..ops import rasterize as _raster
from ..utils.pose import apply_se3_to_extrinsic, se3_exp
from . import density as _density
from . import losses as _losses
from . import optim as _optim
from . import prng as _prng
from . import trainer as _trainer

_OPTAX_ADAM = _optim.OptimConfig(eps=1e-8, lrs=(), schedules=())


@dataclasses.dataclass(frozen=True)
class CamOptimizer:
    """optax.adam over the twists with the JAX package's camera schedule."""

    cam_lr: float
    warmup_iters: int = 0
    warmup_scale: float = 10.0
    decay_steps: int = 0

    def schedule(self, count: int) -> torch.Tensor:
        """The float32 lr of update `count` (from 0): optax's
        join_schedules(constant(cam_lr * warmup_scale), cosine_decay(cam_lr,
        decay_steps) or constant(cam_lr)) at the boundary `warmup_iters`."""
        if self.warmup_iters > 0:
            if count < self.warmup_iters:
                return torch.tensor(self.cam_lr * self.warmup_scale, dtype=torch.float32)
            count -= self.warmup_iters
        if self.decay_steps <= 0:
            return torch.tensor(self.cam_lr, dtype=torch.float32)
        c = torch.tensor(float(min(count, self.decay_steps)), dtype=torch.float32)
        return self.cam_lr * (0.5 * (1 + torch.cos(math.pi * c / float(self.decay_steps))))

    def init(self, xi: torch.Tensor) -> _optim.AdamState:
        return _optim.adam_init({"xi": xi})

    def update(self, g: torch.Tensor, state: _optim.AdamState, xi: torch.Tensor):
        """(new twists, new state)."""
        new, state = _optim.adam_update(_OPTAX_ADAM, {"xi": xi}, {"xi": g}, state,
                                        lr=self.schedule(state.count))
        return new["xi"], state


def make_cam_optimizer(cam_lr: float, cam_warmup_iters: int = 0, warmup_scale: float = 10.0,
                       decay_steps: int = 0) -> CamOptimizer:
    """Adam for the twists. With warm-up, the lr is `cam_lr * warmup_scale`
    for the first `cam_warmup_iters` updates (the joint step freezes the
    scene then); with `decay_steps`, the lr after warm-up decays from
    `cam_lr` to 0 by a cosine over that many updates, which bounds the
    gauge drift of the twists over long runs."""
    return CamOptimizer(cam_lr, cam_warmup_iters, warmup_scale, decay_steps)


def refine_camera_poses(
    scene: GaussianScene,
    frames,                          # [T, H, W, 3]
    base_extr: np.ndarray,           # [3, 4] canonical extrinsic
    rcfg: _raster.RasterizeConfig,
    num_iters: int = 150,
    lr: float = 3e-3,
    lambda_dssim: float = 0.2,
    device="cuda",
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Optimise per-frame twists xi [T, 6] so that the fixed scene rendered
    through exp(xi_t) @ base_extr matches each frame (the mean over frames
    of L1 + D-SSIM). Returns (xi, {"loss_first", "loss_last"})."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    T = frames.shape[0]
    extr0 = torch.as_tensor(np.asarray(base_extr), dtype=torch.float32, device=dev)
    opt = CamOptimizer(lr)
    with torch.no_grad():
        inputs = [(scene.get_position(float(t)), scene.get_rotation(float(t))) for t in range(T)]
        scaling, opacity, shs = scene.get_scaling(), scene.get_opacity(), scene.get_shs()
    xi = torch.zeros((T, 6), dtype=torch.float32, device=dev)
    state = opt.init(xi)
    losses = []
    for _ in range(num_iters):
        leaf = xi.detach().requires_grad_(True)
        per_frame = []
        for t in range(T):
            out = _raster.render_gaussians(inputs[t][0], scaling, inputs[t][1], opacity, shs,
                                           apply_se3_to_extrinsic(extr0, leaf[t]), rcfg)
            per_frame.append(_losses.rgb_loss(out.features["rgb"], frames[t], lambda_dssim))
        loss = torch.stack(per_frame).mean()
        (g,) = torch.autograd.grad(loss, [leaf])
        xi, state = opt.update(g, state, xi)
        losses.append(loss.detach())
    return xi.cpu().numpy(), {"loss_first": float(losses[0]), "loss_last": float(losses[-1])}


class CamTrainState(NamedTuple):
    """TrainState + per-frame camera twists and their Adam state."""

    base: _trainer.TrainState
    cam_xi: torch.Tensor             # [T, 6]
    cam_opt_state: _optim.AdamState


def init_cam_train_state(
    cfg: _trainer.TrainerConfig, scene: GaussianScene, seed: int = 0, cam_lr: float = 1e-4,
    cam_warmup_iters: int = 0, cam_lr_warmup_scale: float = 10.0, cam_decay_steps: int = 0,
    device="cuda",
) -> CamTrainState:
    """The joint state at step 0: `trainer.init_train_state` and zero twists.
    The Adam state does not depend on the schedule's arguments, which are
    kept for the JAX signature."""
    base = _trainer.init_train_state(cfg, scene, seed=seed, device=device)
    xi = torch.zeros((cfg.num_frames, 6), dtype=torch.float32, device=base.scene.device)
    opt = make_cam_optimizer(cam_lr, cam_warmup_iters, cam_lr_warmup_scale, cam_decay_steps)
    return CamTrainState(base, xi, opt.init(xi))


def make_joint_grad_fn(cfg: _trainer.TrainerConfig, extr: np.ndarray, cam_prior_weight: float = 1e-2,
                       device="cuda"):
    """grad_fn(state, batch, key, arap_idx=None) -> (gp, gxi, duv, radius,
    metrics): the gradients of the joint scene + camera objective, the
    train step's losses plus `cam_prior_weight` * |xi|^2."""
    dev = resolve_device(device)
    rcfg = cfg.raster_cfg()
    extr0 = torch.as_tensor(np.asarray(extr), dtype=torch.float32, device=dev)
    E0R, E0t = extr0[:, :3], extr0[:, 3]

    def grad_fn(state: CamTrainState, batch: _trainer.Batch, key, arap_idx=None):
        ts = state.base
        scene = ts.scene
        names = list(scene.params)
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
        xi = state.cam_xi.detach().requires_grad_(True)
        N = scene.alive.shape[0]
        uv_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        abs_sink = torch.zeros((N, 2), device=dev, requires_grad=True)
        extr_t1 = apply_se3_to_extrinsic(extr0, xi[int(batch.t1)])

        def pos2_in_t2_frame(pos2):
            # the tracking loss reads `track_gs` in the canonical camera's
            # convention, so the t2 positions are expressed relative to the
            # refined t2 camera: p' = E0^-1 exp(xi_t2) E0 p
            T2 = se3_exp(xi[int(batch.t2)])
            p = pos2 @ E0R.T + E0t
            p = p @ T2[:3, :3].T + T2[:3, 3]
            return (p - E0t) @ E0R

        loss, (metrics, radius) = _trainer.compute_losses(
            cfg, rcfg, scene, batch, arap_idx, ts.step, params, uv_sink, abs_sink, extr_t1,
            pos2_transform=pos2_in_t2_frame, key=key,
        )
        if cam_prior_weight:
            loss = loss + cam_prior_weight * torch.sum(xi * xi)
            metrics = {**metrics, "loss": loss}
        inputs = [params[k] for k in names] + [xi, uv_sink, abs_sink]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        gp = dict(zip(names, grads[: len(names)]))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return gp, grads[len(names)], grads[len(names) + 1], radius, metrics

    return grad_fn


def make_joint_apply_fn(cfg: _trainer.TrainerConfig, cam_lr: float = 1e-4, cam_warmup_iters: int = 0,
                        cam_lr_warmup_scale: float = 10.0, cam_decay_steps: int = 0):
    """(state, gp, gxi, duv, radius, metrics, key) -> (new_state, metrics):
    the scene's and the twists' Adam updates and the density statistics.
    During the warm-up the scene's gradients are zeroed (its Adam moments
    stay 0)."""
    cam_opt = make_cam_optimizer(cam_lr, cam_warmup_iters, cam_lr_warmup_scale, cam_decay_steps)

    @torch.no_grad()
    def apply_fn(state: CamTrainState, gp, gxi, duv, radius, metrics, key):
        ts = state.base
        scene = ts.scene
        if cam_warmup_iters > 0:
            scale = 0.0 if ts.step < cam_warmup_iters else 1.0
            gp = {k: g * scale for k, g in gp.items()}
        new_params, opt_state = _optim.adam_update(cfg.optim, scene.params, gp, ts.opt_state)
        new_xi, cam_opt_state = cam_opt.update(gxi, state.cam_opt_state, state.cam_xi)
        dstate = _density.accumulate_stats(ts.densify_state, radius > 0, radius,
                                           _trainer.viewspace_grad_norm(cfg, duv))
        new_base = _trainer.TrainState(dataclasses.replace(scene, params=new_params), opt_state, dstate,
                                       ts.step + 1, key)
        return CamTrainState(new_base, new_xi, cam_opt_state), metrics

    return apply_fn


def make_joint_train_step(
    cfg: _trainer.TrainerConfig, extr: np.ndarray, cam_lr: float = 1e-4, cam_prior_weight: float = 1e-2,
    cam_warmup_iters: int = 0, cam_lr_warmup_scale: float = 10.0, cam_decay_steps: int = 0,
    frames: Optional[_trainer.FrameStore] = None, device="cuda",
):
    """step(state, batch, arap_idx=None) -> (state, metrics): one train step
    over the scene and the per-frame twists together.

    The scene's trajectories can absorb any per-frame camera motion, so the
    data losses do not pin the twists: the joint step selects a gauge. The
    L2 prior (`cam_prior_weight`), the warm-up with a frozen scene and the
    cosine decay of the camera lr keep it near the canonical frame, as in
    the JAX package; recovering a known pose is `refine_camera_poses`'s
    job, against a fixed scene."""
    dev = resolve_device(device)
    grad_fn = make_joint_grad_fn(cfg, extr, cam_prior_weight, device=dev)
    apply_fn = make_joint_apply_fn(cfg, cam_lr, cam_warmup_iters, cam_lr_warmup_scale, cam_decay_steps)
    if frames is not None:
        frames = _trainer.FrameStore(*(None if f is None else f.to(dev) for f in frames))

    def step(state: CamTrainState, batch: _trainer.Batch, arap_idx: Optional[torch.Tensor] = None):
        batch = _trainer.resolve_batch(frames, batch)
        key, sub = _prng.split(state.base.key)
        gp, gxi, duv, radius, metrics = grad_fn(state, batch, sub, arap_idx)
        return apply_fn(state, gp, gxi, duv, radius, metrics, key)

    return step


def refined_extrinsics(base_extr: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """[T, 3, 4] refined extrinsics from per-frame twists (numpy in and out)."""
    extr0 = torch.as_tensor(np.asarray(base_extr), dtype=torch.float32)
    return np.stack([apply_se3_to_extrinsic(extr0, x).numpy()
                     for x in torch.as_tensor(np.asarray(xi), dtype=torch.float32)])
