#!/usr/bin/env python3
"""Time one tree's blend kernels on the card at `chip_smoke.py`'s shapes.

    python3 scripts/torch_blend_ab.py [--tree DIR] [--label NAME] [--seed 0] [--kernels K ...]

Imports `splatter_a_video_tpu_torch` from DIR (default: this checkout) and
the scenes, blends and timer from this checkout's `chip_smoke.py`, builds
DIR's kernels into DIR's own `_build/`, and times each launch with CUDA
events (`chip_smoke.cuda_ms`, the median of 20 runs behind a device-side
sleep):

  main path: K2 and K1 on frame 0 of the flagship render (C = 20), K3 at
     C = 7 on the training frame (16x16) and K4 on its rows (R = 15);
  phase 23: K1, K3 and K4 on K3's rows on the training frame at each blend
     of `chip_smoke.wide_blends` (C = 33, 52, 64 and 200 on 16x16 tiles,
     R = 41, 60, 72 and 208, and WIDE_TILES, among them the tiles above
     1024 pixels).

`--kernels` times only the named kernels (the others still run where a
timed one needs their outputs), for a quick A/B of one kernel's variants.

To compare two trees on one card, run it for each in turns in one call
(parent, change, change, parent). A blend the tree refuses is recorded with
its error. Outputs are not checked here: `chip_smoke.py` holds every
instance `torch.equal` to its plain version. Prints the card's name and
power limit, then one JSON line: {"label", "tree", "card", "cases": [{"name",
"kernel", "ms" or "error", "regs", "local_bytes", "shared_bytes"}]}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEVICE = "cuda"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT), help="root of the checkout whose port is timed")
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="*", metavar="K", help="time only these kernels (default: all four)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))   # the tree's package

    import torch

    if not torch.cuda.is_available():
        print("torch_blend_ab: no CUDA device; the kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")   # this checkout's
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import splatter_a_video_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"imported {pkg.__file__}, not the package of {tree}")
    from splatter_a_video_tpu_torch import convert, inference
    from splatter_a_video_tpu_torch.models import camera
    from splatter_a_video_tpu_torch.ops import _build, binning, rasterize
    from splatter_a_video_tpu_torch.ops import rasterize_gpu as rg
    from splatter_a_video_tpu_torch.train import trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()
    cpm = cs.sleep_cycles_per_ms()
    dev = torch.device(DEVICE)
    extr = torch.as_tensor(camera.canonical_camera(cs.W, cs.H).extrinsic, dtype=torch.float32, device=dev)
    cases = []

    def timed(name: str, kernel: str, C: int, tile, fn) -> None:
        if args.kernels and kernel not in args.kernels:
            return
        row = {"name": name, "kernel": kernel}
        try:
            row["ms"] = cs.cuda_ms(fn, cpm)
            row.update(rg.kernel_attributes(kernel, C, tuple(tile)))
        except ValueError as e:   # a wrapper's refusal: nothing was launched
            row["error"] = f"ValueError: {e}"
        cases.append(row)
        print(json.dumps(row), flush=True)

    def blends(tag: str, pr, rc, mask=None, backward: bool = True) -> None:
        """K1 (and K3, then K4 on K3's rows) at the blend of `pr` under `rc`."""
        feats, bg, gmask = cs.blend_arrays(pr)
        mask = gmask if mask is None else mask
        C, tile = feats.shape[1], tuple(rc.block)
        name = f"{tag} C={C} {tile[0]}x{tile[1]}"
        b = binning.bin_intersections(pr.depth, pr.tiles, pr.rect_min, pr.rect_max, cs.W, cs.H,
                                      rc.max_intersections, rc.max_tiles_per_gaussian, rc.block)
        k1a = (b.gid, b.edges, pr.uv, pr.conic, pr.opacity, feats, bg, cs.W, cs.H, tile)
        timed(name, "blend_forward", C, tile, lambda: rg.blend_forward(*k1a))
        if not backward or (args.kernels and not {"blend_backward", "reduce_gaussians"} & set(args.kernels)):
            return
        try:
            out = rg.blend_forward(*k1a)
        except ValueError:   # K3's wrapper refuses or takes the tile before it reads K1's outputs
            out = (torch.zeros((cs.H, cs.W, C), device=dev), torch.zeros((cs.H, cs.W), device=dev))
        g = torch.randn((cs.H, cs.W, C), generator=torch.Generator(device=dev).manual_seed(args.seed + 14),
                        device=dev)
        k3a = (b.gid, b.edges, pr.uv, pr.conic, pr.opacity, feats, bg, mask, out[0], out[1], g, cs.W, cs.H, tile)
        timed(name, "blend_backward", C, tile, lambda: rg.blend_backward(*k3a))
        try:
            dg = rg.blend_backward(*k3a)
        except ValueError:
            return
        timed(f"{name} R={dg.shape[1]}", "reduce_gaussians", dg.shape[1], tile,
              lambda: rg.reduce_gaussians(dg, b.order, b.offs, b.tiles))

    with torch.no_grad():
        # ---- the main path: K2 and K1 (C = 20) on the render, K3 and K4 (C = 7) on the training frame
        scene = convert.scene_from_numpy(*cs.flagship_scene_arrays(args.seed), device=DEVICE)
        rcfg = rasterize.RasterizeConfig(width=cs.W, height=cs.H, max_intersections=cs.MAX_INTERSECTIONS)
        inp, extra = inference._scene_inputs(scene, 0.0, cs.EXTRA)
        pr = rasterize.project_gaussians(inp["position"], inp["scaling"], inp["rotation"], inp["opacity"],
                                         inp["shs"], extr, rcfg, extra_features=extra)
        tiles = pr.tiles.clamp_max(rcfg.max_tiles_per_gaussian).contiguous()
        offs = (torch.cumsum(tiles, 0, dtype=torch.int32) - tiles).contiguous()
        k2a = (offs, tiles, pr.rect_min.contiguous(), pr.rect_max.contiguous(), pr.depth.contiguous(),
               cs.MAX_INTERSECTIONS, -(-cs.W // rcfg.block[0]))
        timed("render K2", "expand_intersections", 0, rcfg.block, lambda: rg.expand_intersections(*k2a))
        blends("render", pr, rcfg, backward=False)
        tcfg = trainer.TrainerConfig(width=cs.W, height=cs.H, num_frames=cs.FRAMES,
                                     max_intersections=cs.MAX_INTERSECTIONS)
        tinp = trainer.scene_render_inputs(scene, cs.TRAIN_T1)
        tp = trainer.project_for_training(tinp, extr, tcfg.raster_cfg(),
                                          {"track_gs": scene.get_position(cs.TRAIN_T2)}, True, 0.0, tcfg.depth_bg)
        blends("train", tp, tcfg.raster_cfg(), mask=torch.tensor(cs.TRAIN_MASK, device=dev))
        del scene, pr, tp, inp, extra, tinp

        # ---- phase 23's blends
        scene = convert.scene_from_numpy(*cs.flagship_scene_arrays(args.seed, dino=cs.WIDE_DINO), device=DEVICE)
        for pr, rc in cs.wide_blends(scene, cs.wide_training_config(), extr, args.seed + 13):
            blends("wide", pr, rc)
            del pr
            torch.cuda.empty_cache()

    print(json.dumps({"label": args.label, "tree": str(tree), "card": card, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
