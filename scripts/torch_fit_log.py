"""The logged metrics of a production-harness fit, one line per log step:
step, training PSNR, depth loss, the training render's true intersection
count and the alive count; one line per density event: step, cloned,
split, pruned, dropped, alive; then the eval record's quality, for each
intersection budget given. The fit is `scripts/torch_e2e_480p.py`'s, read
from the same `E480_*` knobs; nothing is written. `--seed` sets
`FitConfig.seed` (the initial points, the frame pairs, the track rows and
the key of the random draws), `--arap_ulp` moves the ARAP weight one ulp
up: the fit's sensitivity to a draw and to one rounding. `--depth_weight`
sets the depth loss's weight (default 1), and `--depth_stats` prints, at
each log step, the training render's depth of frame step % T as the depth
loss normalises it: median, mean absolute deviation (the divisor of the
prediction), the share of pixels within 1e-3 of the median and the share
left uncovered (final transmittance above 0.5).

    E480_TEXTURE=1 E480_GROWTH_FRAC=0.05 E480_LR_STEPS=8000 E480_STEPS=2000 \\
        python3 scripts/torch_fit_log.py --maxi 1048576 2097152
    E480_TEXTURE=1 E480_GROWTH_FRAC=0.05 E480_LR_STEPS=8000 E480_STEPS=2000 \\
        python3 scripts/torch_fit_log.py --seed 1

A fit repeats bit for bit on the card, and its first N steps do not depend
on E480_STEPS (only the log cadence, E480_STEPS // 40, does), so a short
run shows the steps of a long one. A budget the training render never
reaches leaves the fit unchanged.
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_e2e_480p as e2e
from splatter_a_video_tpu_torch.models import camera
from splatter_a_video_tpu_torch.train import hooks, trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maxi", type=int, nargs="+", default=[1 << 20], help="intersection budgets, one fit each")
    ap.add_argument("--seed", type=int, default=0, help="FitConfig.seed")
    ap.add_argument("--arap_ulp", action="store_true", help="move the ARAP weight one ulp up")
    ap.add_argument("--depth_weight", type=float, default=None, help="TrainerConfig.depth_loss_weight")
    ap.add_argument("--depth_stats", action="store_true", help="print the rendered depth's statistics")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    e2e.fit_configs = _varied(e2e.fit_configs, args.seed, args.arap_ulp, args.depth_weight)
    for maxi in args.maxi:
        s = e2e.read_env({**os.environ, "E480_MAXI": str(maxi)})
        fcfg, tcfg = e2e.fit_configs(s)
        fit_hooks = [DepthStats(tcfg, fcfg.log_every)] if args.depth_stats else None
        rec, _, hist, _ = e2e.run(s, device=args.device, hooks=fit_hooks, write=False)
        print(f"fit at budget {s.maxi}: seed {args.seed}, arap_weight {tcfg.arap_weight!r}, depth_loss_weight "
              f"{tcfg.depth_loss_weight!r}", flush=True)
        for ev in hist[-1].get("densify_events", []):
            print(f"event {ev['step']}: cloned {ev['num_cloned']}, split {ev['num_split']}, pruned "
                  f"{ev['num_pruned']}, dropped {ev['dropped']}, alive {ev['num_alive']}", flush=True)
        print(f"budget {s.maxi}: step, psnr, loss_depth, num_intersections, alive:",
              [(m["step"], round(m["psnr"], 2), round(m["loss_depth"], 3), int(m["num_intersections"]), m["alive"])
               for m in hist], flush=True)
        print(f"budget {s.maxi}: record", json.dumps({
            "recon_psnr": rec["recon"]["psnr"], "ssim": rec["recon"]["ssim"],
            "aj": rec["tapvid"]["average_jaccard"], "oa": rec["tapvid"]["occlusion_accuracy"],
            **{k: rec[k] for k in ("final_alive", "densify_totals", "eval_num_intersections", "hardware")}}),
            flush=True)
    return 0


def _varied(fit_configs, seed: int, arap_ulp: bool, depth_weight=None):
    """`fit_configs` with FitConfig.seed = seed, with arap_ulp the ARAP
    weight one float32 ulp up, and the depth loss's weight if given."""

    def configs(s):
        fcfg, tcfg = fit_configs(s)
        if arap_ulp:
            w = float(np.nextafter(np.float32(tcfg.arap_weight), np.float32(np.inf)))
            tcfg = dataclasses.replace(tcfg, arap_weight=w)
        if depth_weight is not None:
            tcfg = dataclasses.replace(tcfg, depth_loss_weight=depth_weight)
        return dataclasses.replace(fcfg, seed=seed), tcfg

    return configs


class DepthStats(hooks.Hook):
    """At each log step: the training render's depth of frame step % T,
    as `losses.depth_loss_dpt` normalises the prediction."""

    def __init__(self, tcfg, every: int):
        self.tcfg, self.every = tcfg, every

    def after_train_iter(self, ctx):
        if ctx.step % self.every:
            return
        cfg, scene = self.tcfg, ctx.state.scene
        t = ctx.step % cfg.num_frames
        extr = torch.as_tensor(camera.canonical_camera(cfg.width, cfg.height).extrinsic, device=scene.device)
        with torch.no_grad():
            out = trainer._render_with_sinks(trainer.scene_render_inputs(scene, t), extr, cfg.raster_cfg(), {},
                                             cfg.white_bg, 0.0, None, cfg.depth_bg)
            d = out.features["depth"][..., 0].reshape(-1)
            med = torch.sort(d).values[[(d.numel() - 1) // 2, d.numel() // 2]].mean()
            mad = (d - med).abs().mean()
            flat = ((d - med).abs() < 1e-3).float().mean()
            holes = (out.final_T > 0.5).float().mean()
        print(f"depth {ctx.step}: frame {t}, median {float(med):.4f}, mad {float(mad):.5f}, within 1e-3 of the "
              f"median {float(flat):.4f}, uncovered {float(holes):.4f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
