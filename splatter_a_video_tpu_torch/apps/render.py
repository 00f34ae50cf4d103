"""Render CLI over a trained checkpoint (counterpart of
`splatter_a_video_tpu/apps/render.py`): video, depth, novel views, stereo
and slow-motion interpolation. Renders on the GPU unless `--device cpu`.

Usage:
  python -m splatter_a_video_tpu_torch.apps.render --ckpt out --mode video \
      --width 854 --height 480 --num_frames 80
  python -m splatter_a_video_tpu_torch.apps.render --ckpt out --mode interp --slowmo 4 ...
  python -m splatter_a_video_tpu_torch.apps.render --ckpt out --mode nvs --device cpu ...
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser("sav-render")
    p.add_argument("--ckpt", required=True, help="training out_dir")
    p.add_argument("--mode", default="video", choices=["video", "nvs", "stereo", "interp", "depth"])
    p.add_argument("--out", default=None)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--num_frames", type=int, required=True)
    p.add_argument("--slowmo", type=int, default=4)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--max_intersections", type=int, default=1 << 19)
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
    cam = cam_lib.canonical_camera(args.width, args.height)
    rcfg = raster_lib.RasterizeConfig(width=args.width, height=args.height,
                                      max_intersections=args.max_intersections)
    out = args.out or os.path.join(args.ckpt, f"{args.mode}.mp4")

    T = args.num_frames
    fps = args.fps
    if args.mode == "video":
        frames = inference.render_video(scene, cam, rcfg, list(range(T)), device=dev)["rgb"]
    elif args.mode == "depth":
        res = inference.render_video(scene, cam, rcfg, list(range(T)), device=dev)
        frames = [vis_lib.colorize_depth(d) for d in res["depth"]]
    elif args.mode == "nvs":
        frames = inference.render_nvs(scene, cam, rcfg, list(range(T)), device=dev)
    elif args.mode == "stereo":
        frames = inference.render_stereo(scene, cam, rcfg, list(range(T)), device=dev)
    else:  # interp
        times = np.linspace(0, T - 1, (T - 1) * args.slowmo + 1)
        frames = inference.render_video(scene, cam, rcfg, list(times), device=dev)["rgb"]
        fps = args.fps * args.slowmo
    vis_lib.write_video(out, frames, fps=fps)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
