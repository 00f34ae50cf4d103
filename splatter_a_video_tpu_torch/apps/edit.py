"""Editing CLI (counterpart of `splatter_a_video_tpu/apps/edit.py`):
appearance re-optimisation under a mask or against a whole edited frame,
the fg / bg layer split and a moved copy of the foreground. Runs on the
GPU unless `--device cpu`.

Usage:
  python -m splatter_a_video_tpu_torch.apps.edit --ckpt out --mode appearance \
      --mask mask.png --target edited.png --width W --height H --num_frames T
  python -m splatter_a_video_tpu_torch.apps.edit --ckpt out --mode layers ...
  python -m splatter_a_video_tpu_torch.apps.edit --ckpt out --mode addfg --delta 0.2 0.0 0.0 ...
"""

from __future__ import annotations

import argparse
import os


def _read_image(path: str):
    import imageio.v2 as imageio
    import numpy as np

    return np.asarray(imageio.imread(path), np.float32)


def main(argv=None):
    p = argparse.ArgumentParser("sav-edit")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--mode", default="appearance",
                   choices=["appearance", "appearance_img", "layers", "addfg"])
    p.add_argument("--mask", default=None)
    p.add_argument("--target", default=None)
    p.add_argument("--delta", type=float, nargs=3, default=[0.2, 0.0, 0.0])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--num_frames", type=int, required=True)
    p.add_argument("--max_intersections", type=int, default=1 << 20)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np

    from .. import inference
    from ..device import resolve_device
    from ..models import camera as cam_lib
    from ..ops import rasterize as raster_lib
    from ..utils import vis as vis_lib
    from .train_state_io import load_scene_from_ckpt

    dev = resolve_device(args.device)
    scene = load_scene_from_ckpt(args.ckpt, device=dev)
    W, H, T = args.width, args.height, args.num_frames
    cam = cam_lib.canonical_camera(W, H)
    rcfg = raster_lib.RasterizeConfig(width=W, height=H, max_intersections=args.max_intersections)
    times = list(range(T))

    def write(out, sub):
        vis_lib.write_video(out, inference.render_video(sub, cam, rcfg, times, device=dev)["rgb"])
        print(f"wrote {out}")

    if args.mode == "appearance_img":
        # whole-frame transfer: every alive Gaussian's SH re-optimised, geometry frozen
        target = _read_image(args.target)[..., :3] / 255.0
        edited = inference.optimize_appearance_from_img(scene, target, cam, rcfg, steps=args.steps, device=dev)
        write(args.out or os.path.join(args.ckpt, "editing_img.mp4"), edited)
    elif args.mode == "appearance":
        target = _read_image(args.target)[..., :3] / 255.0
        if args.mask:
            mask = _read_image(args.mask)
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = mask / max(mask.max(), 1e-6)
        else:
            # edit wherever the target differs from the render
            out0 = inference.render_frame(scene, 0.0, cam.extrinsic, rcfg, device=dev)
            diff = np.abs(out0.features["rgb"].cpu().numpy() - target).sum(-1)
            mask = (diff > 0.05).astype(np.float32)
        sel = inference.select_gaussians_by_mask(scene, mask, cam, rcfg, device=dev)
        print(f"re-optimizing appearance of {len(sel)} gaussians")
        edited = inference.optimize_appearance(scene, sel, target, cam, rcfg, steps=args.steps, device=dev)
        write(args.out or os.path.join(args.ckpt, "editing.mp4"), edited)
    elif args.mode == "layers":
        fg, bg = inference.split_layers(scene)
        for name, sub in (("fg", fg), ("bg", bg)):
            write(os.path.join(args.out or args.ckpt, f"layer_{name}.mp4"), sub)
    else:  # addfg
        dup = inference.add_fg_copy(scene, np.asarray(args.delta), scale=args.scale)
        write(args.out or os.path.join(args.ckpt, "added_fg.mp4"), dup)


if __name__ == "__main__":
    main()
