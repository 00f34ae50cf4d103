"""Training CLI (counterpart of `splatter_a_video_tpu/apps/train.py`).

Writes `args.json`, checkpoints (`ckpt_{step:06d}/state.pt`, every
`--i_weight` steps and at the end), `scene_cfg.json` and `history.json`
into `--out_dir`; `--resume` continues from the newest checkpoint there.
Trains on the GPU unless `--device cpu` is given.

Usage:
  python -m splatter_a_video_tpu_torch.apps.train --config cfg.txt --seq_name X
  python -m splatter_a_video_tpu_torch.apps.train --synthetic --num_iters 500
  python -m splatter_a_video_tpu_torch.apps.train --synthetic --device cpu --num_iters 20
"""

from __future__ import annotations

import json
import os
import time


def main(argv=None):
    from ..utils.config import parse_args

    args = parse_args(argv)

    from ..data import synthetic as synth_lib
    from ..data.video_flow import VideoFlowData
    from ..device import resolve_device
    from ..train import fit as fit_lib
    from ..train import trainer as trainer_lib
    from ..utils import checkpoint as ckpt_lib

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)

    if args.synthetic:
        data = synth_lib.make_clip(synth_lib.SyntheticClipConfig())
    else:
        base = os.path.join(args.datadir, args.seq_name)
        data = VideoFlowData(
            img_dir=os.path.join(base, "images"),
            depth_dir=os.path.join(base, "aligned_depth_anything_v2"),
            mask_dir=os.path.join(base, "masks"),
            tracks_dir=os.path.join(base, "bootstapir"),
            # raw depth-loss ground truth when present, else the lifting depth
            loss_depth_dir=os.path.join(base, "marigold", "depth_npy"),
            dino_dir=os.path.join(base, "dinov2"),
            start=args.base_idx,
            end=(-1 if args.num_imgs < 0 else args.base_idx + args.num_imgs),
        ).setup()

    H, W = data.image_size
    fcfg = fit_lib.FitConfig(
        num_iters=args.num_iters,
        num_track_samples=args.num_track_samples,
        capacity_factor=args.capacity_factor,
        log_every=args.i_print,
        seed=args.seed,
        profile_dir=args.profile_dir,
        error_resample_every=args.i_cache,
        distributed=bool(args.distributed),
        video_flow_margin=args.video_flow_margin,
        traj=args.traj,
        refine_camera=bool(args.refine_camera),
        camera_lr=args.camera_lr,
        camera_warmup=args.camera_warmup,
    )
    tcfg = trainer_lib.TrainerConfig(
        width=W,
        height=H,
        num_frames=data.num_frames,
        loss_rgb_weight=args.loss_rgb_weight,
        loss_flow_weight=args.loss_flow_weight,
        mask_attr_weight=args.loss_mask_weight,
        dino_attr_weight=args.loss_dino_weight,
        num_track_samples=args.num_track_samples,
        max_steps=args.num_iters,
        max_intersections=args.max_intersections,
    )
    if args.gs_config_file:
        # model-level YAML overrides: lrs, schedules, density hypers,
        # lambda_dssim, render attributes
        from ..utils.config import apply_gs_config, load_yaml

        tcfg, fcfg = apply_gs_config(load_yaml(args.gs_config_file), tcfg, fcfg)

    t0 = time.time()

    def cb(step, m):
        print(f"step {step:6d}  loss {m['loss']:.4f}  psnr {m['psnr']:.2f}  "
              f"alive {m['alive']}  {step / max(time.time() - t0, 1e-9):.1f} it/s", flush=True)

    from ..train import hooks as hooks_lib

    hooks = [
        hooks_lib.LogHook(print_every=0, image_every=args.i_img, tensorboard=bool(args.tensorboard)),
        hooks_lib.CheckPointHook(every=args.i_weight, ply=bool(args.export_ply)),
    ]
    from ..data.factory import make_training_sampler

    sampler = make_training_sampler(
        args.dataset_types, data.num_frames, dataset_weights=args.dataset_weights, seed=args.seed,
        start_interval=args.start_interval,
    ) if args.dataset_types != "simpleGS" else None

    state, history = fit_lib.fit_clip(
        data, fcfg, tcfg, callback=cb, hooks=hooks, out_dir=args.out_dir, resume=args.resume,
        sampler=sampler, device=device,
    )
    ckpt_lib.save_checkpoint(args.out_dir, state, int(state.step))
    from .train_state_io import save_scene_cfg

    save_scene_cfg(args.out_dir, state.scene)
    with open(os.path.join(args.out_dir, "history.json"), "w") as f:
        json.dump(history, f)
    print(f"done in {time.time() - t0:.1f}s -> {args.out_dir}")
    return state


if __name__ == "__main__":
    main()
