"""Tracking CLI (counterpart of `splatter_a_video_tpu/apps/track.py`):
TAP-Vid evaluation of a trained checkpoint, Gaussian centre trajectories
and a tracked pixel grid drawn over the rendered video. Runs on the GPU
unless `--device cpu`.

Usage:
  python -m splatter_a_video_tpu_torch.apps.track --ckpt out --mode eval \
      --datadir data --seq_name clip
  python -m splatter_a_video_tpu_torch.apps.track --ckpt out --mode eval --synthetic
  python -m splatter_a_video_tpu_torch.apps.track --ckpt out --mode trajectories \
      --width 854 --height 480 --num_frames 80
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser("sav-track")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--mode", default="eval", choices=["eval", "trajectories", "pixels"])
    p.add_argument("--datadir", default="")
    p.add_argument("--seq_name", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--num_queries", type=int, default=256)
    p.add_argument("--max_intersections", type=int, default=1 << 19)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import inference
    from ..device import resolve_device
    from ..models import camera as cam_lib
    from ..ops import rasterize as raster_lib
    from ..train.losses import denormalize_coords
    from ..utils import vis as vis_lib
    from .train_state_io import load_scene_from_ckpt

    dev = resolve_device(args.device)
    scene = load_scene_from_ckpt(args.ckpt, device=dev)

    data = None
    if args.synthetic:
        from ..data import synthetic

        data = synthetic.make_clip(synthetic.SyntheticClipConfig())
    elif args.datadir:
        from ..data.video_flow import VideoFlowData

        base = os.path.join(args.datadir, args.seq_name)
        data = VideoFlowData(
            img_dir=os.path.join(base, "images"),
            depth_dir=os.path.join(base, "aligned_depth_anything_v2"),
            mask_dir=os.path.join(base, "masks"),
            tracks_dir=os.path.join(base, "bootstapir"),
        ).setup()

    if data is not None:
        H, W = data.image_size
        T = data.num_frames
    else:
        W, H, T = args.width, args.height, args.num_frames
    cam = cam_lib.canonical_camera(W, H)
    rcfg = raster_lib.RasterizeConfig(width=W, height=H, max_intersections=args.max_intersections)

    if args.mode == "eval":
        from ..eval import tapvid

        m = tapvid.evaluate_scene_tracking(scene, data, cam, rcfg, num_queries=args.num_queries,
                                           device=dev)
        print(json.dumps(m, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(m, f, indent=2)
        return
    times = list(range(T))
    if args.mode == "trajectories":
        # sampled Gaussian centre trajectories over the rendered frames
        tr3d = inference.gaussian_trajectories(scene, times, sample=256, device=dev)
        tracks = denormalize_coords(torch.from_numpy(tr3d[..., :2]), H, W).numpy()  # [S, T, 2]
        name = "trajectories.mp4"
    else:  # pixels: a pixel grid tracked from frame 0 through the clip
        g = 16
        ys, xs = np.mgrid[g // 2 : H : g, g // 2 : W : g]
        px0 = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
        tracks = [px0] + [
            inference.track_correspondences(scene, 0.0, px0, float(t), cam, rcfg, device=dev)[0]
            for t in range(1, T)
        ]
        tracks = np.stack(tracks, axis=1)  # [S, T, 2]
        name = "pixel_tracks.mp4"
    res = inference.render_video(scene, cam, rcfg, times, device=dev)
    frames = [vis_lib.draw_tracks_2d(res["rgb"][t], tracks[:, : t + 1]) for t in range(T)]
    out = args.out or os.path.join(args.ckpt, name)
    vis_lib.write_video(out, frames)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
