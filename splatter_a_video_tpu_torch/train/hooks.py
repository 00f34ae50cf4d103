"""Training hooks: lifecycle callbacks, console / TensorBoard logging and
periodic checkpoints (counterpart of `splatter_a_video_tpu/train/hooks.py`).

`after_train_iter` fires at the log cadence and at each hook's own `every`,
not every step: its metrics are read back from the card, and a read on
every step would stall the host on the card. `before_train_iter` fires
every step (it needs no metrics). TensorBoard goes through
`torch.utils.tensorboard`; where that cannot be imported (no `tensorboard`
package), logging stays on the console, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List


class Hook:
    """Lifecycle callback base with all 12 sites."""

    locations = (
        "before_run", "after_load_checkpoint", "before_train",
        "before_train_iter", "after_train_iter", "before_val",
        "before_val_iter", "after_val_iter", "after_val",
        "before_save_checkpoint", "after_train", "after_run",
    )

    def before_run(self, ctx):
        pass

    def after_load_checkpoint(self, ctx):
        pass

    def before_train(self, ctx):
        pass

    def before_train_iter(self, ctx):
        pass

    def after_train_iter(self, ctx):
        pass

    def before_val(self, ctx):
        pass

    def before_val_iter(self, ctx):
        pass

    def after_val_iter(self, ctx):
        pass

    def after_val(self, ctx):
        pass

    def before_save_checkpoint(self, ctx):
        pass

    def after_train(self, ctx):
        pass

    def after_run(self, ctx):
        pass


class HookContext:
    """Mutable bag passed to hooks: step, metrics, state, config, out_dir."""

    def __init__(self, out_dir: str, cfg=None):
        self.out_dir = out_dir
        self.cfg = cfg
        self.step = 0
        self.metrics: Dict[str, float] = {}
        self.val_metrics: Dict[str, float] = {}
        self.state = None
        self.images: Dict[str, "object"] = {}


class LogHook(Hook):
    """Console + TensorBoard scalar / image logging with EMA smoothing."""

    def __init__(self, print_every: int = 100, image_every: int = 0, ema: float = 0.9,
                 tensorboard: bool = True):
        self.print_every = print_every
        self.image_every = image_every
        self.ema = ema
        self.tensorboard = tensorboard
        self._ema_vals: Dict[str, float] = {}
        self._writer = None
        self._t0 = None

    def before_train(self, ctx: HookContext):
        self._t0 = time.time()
        if self.tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(os.path.join(ctx.out_dir, "tb"))
            except Exception:
                self._writer = None

    def after_train_iter(self, ctx: HookContext):
        for k, v in ctx.metrics.items():
            prev = self._ema_vals.get(k, float(v))
            self._ema_vals[k] = self.ema * prev + (1 - self.ema) * float(v)
        if self._writer is not None:
            for k, v in ctx.metrics.items():
                self._writer.add_scalar(f"train/{k}", float(v), ctx.step)
            if ctx.images:
                import numpy as np

                for name, img in ctx.images.items():
                    arr = np.clip(np.asarray(img), 0, 1)
                    self._writer.add_image(f"train/{name}", arr, ctx.step, dataformats="HWC")
                ctx.images = {}
        if self.print_every and ctx.step % self.print_every == 0:
            parts = "  ".join(f"{k} {self._ema_vals.get(k, 0):.4f}"
                              for k in ("loss", "psnr") if k in self._ema_vals)
            rate = ctx.step / max(time.time() - self._t0, 1e-9)
            print(f"step {ctx.step:6d}  {parts}  {rate:.2f} it/s", flush=True)

    def after_val(self, ctx: HookContext):
        if self._writer is not None:
            for k, v in ctx.val_metrics.items():
                self._writer.add_scalar(f"val/{k}", float(v), ctx.step)
        if self.print_every:
            parts = "  ".join(f"{k} {float(v):.4f}" for k, v in ctx.val_metrics.items())
            print(f"val @ step {ctx.step}: {parts}", flush=True)

    def after_train(self, ctx: HookContext):
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()


class CheckPointHook(Hook):
    """Periodic `TrainState` snapshots; `ply=True` also writes
    `point_cloud_{step:06d}.ply` of the alive Gaussians."""

    def __init__(self, every: int = 5000, ply: bool = False):
        self.every = every
        self.ply = ply

    def after_train_iter(self, ctx: HookContext):
        if self.every and ctx.step % self.every == 0 and ctx.state is not None:
            self._save(ctx)

    def after_train(self, ctx: HookContext):
        if ctx.state is not None:
            self._save(ctx)

    def _save(self, ctx: HookContext):
        # the other hooks' before_save_checkpoint site first
        run_hooks([h for h in getattr(ctx, "hooks", []) if h is not self], "before_save_checkpoint", ctx)
        from ..utils.checkpoint import save_checkpoint

        save_checkpoint(ctx.out_dir, ctx.state, ctx.step)
        if self.ply:
            from ..utils.ply import save_ply

            scene = ctx.state.scene
            save_ply(
                os.path.join(ctx.out_dir, f"point_cloud_{ctx.step:06d}.ply"),
                {k: v.detach().cpu().numpy() for k, v in scene.params.items()},
                scene.alive.cpu().numpy(),
            )


def run_hooks(hooks: List[Hook], site: str, ctx: HookContext) -> None:
    for h in hooks:
        getattr(h, site)(ctx)
