"""Preprocessing CLI: the offline stages over a raw clip (counterpart of
`splatter_a_video_tpu/apps/preprocess.py`).

The reference's three data-preparation scripts as one CLI producing the
training layout:

  images/ masks/ aligned_depth_anything_v2/*.npy bootstapir/{q}_{t}.npy
  [unidepth_disp/*.npy unidepth_intrins.json]

The network stages run through the port's Depth-Anything and TAPIR on
`--device` (default cuda) when converted checkpoints are present
(`$SPLAT_DEPTH_ANYTHING_WEIGHTS`, `$SPLAT_TAPIR_WEIGHTS`, or
`splatter_a_video_tpu_torch/weights/`), metric depth through an installed
`unidepth`; a stage whose dependency is absent prints `SKIPPED`, in the
same cases as the JAX package.

Usage:
  python -m splatter_a_video_tpu_torch.apps.preprocess --datadir data --seq_name clip \\
      --stages monodepth,align,tracks
  python -m splatter_a_video_tpu_torch.apps.preprocess --datadir data --seq_name clip --stages all
"""

from __future__ import annotations

import argparse
import os.path as osp

ALL_STAGES = ("metric", "monodepth", "align", "tracks")


def run_stage(stage: str, base: str, args) -> str:
    """Run one stage; returns a one-line status."""
    from ..data import preprocess as pp

    img_dir = osp.join(base, "images")
    mask_dir = osp.join(base, "masks")
    try:
        if stage == "metric":
            n = pp.compute_metric_depth(img_dir, osp.join(base, "unidepth_disp"), osp.join(base, "unidepth_intrins"))
        elif stage == "monodepth":
            n = pp.compute_monodepth(img_dir, osp.join(base, "depth_anything"), device=args.device)
        elif stage == "align":
            n = pp.align_monodepth_with_metric_depth(osp.join(base, "unidepth_disp"), osp.join(base, "depth_anything"),
                                                     osp.join(base, "aligned_depth_anything_v2"))
        elif stage == "tracks":
            n = pp.compute_tracks(img_dir, mask_dir, osp.join(base, "bootstapir"), grid_size=args.grid_size,
                                  device=args.device)
        else:
            return f"{stage}: unknown stage"
    except NotImplementedError as e:
        return f"{stage}: SKIPPED ({e})"
    except FileNotFoundError as e:
        return f"{stage}: SKIPPED (missing input: {e})"
    return f"{stage}: ok ({n} files)"


def main(argv=None):
    p = argparse.ArgumentParser("sav-preprocess")
    p.add_argument("--datadir", required=True)
    p.add_argument("--seq_name", default="")
    p.add_argument("--stages", default="all", help="comma list of metric,monodepth,align,tracks (or 'all')")
    p.add_argument("--grid_size", type=int, default=4)
    p.add_argument("--device", default="cuda", help="device of the network stages (cpu: their plain path)")
    args = p.parse_args(argv)

    from ..device import resolve_device

    resolve_device(args.device)   # no CUDA device: raise before any stage
    base = osp.join(args.datadir, args.seq_name) if args.seq_name else args.datadir
    if not osp.isdir(osp.join(base, "images")):
        raise SystemExit(f"no images/ under {base}")
    stages = ALL_STAGES if args.stages == "all" else tuple(s.strip() for s in args.stages.split(",") if s.strip())
    for stage in stages:
        print(run_stage(stage, base, args), flush=True)


if __name__ == "__main__":
    main()
