"""Convert a Depth-Anything checkpoint to the `.npz` the port reads.

Usage (on a machine with the checkpoint available; nothing is downloaded):
    python scripts/torch_convert_depth_anything.py \
        --ckpt pytorch_model.bin --config config.json \
        --out weights/depth_anything.npz
    python scripts/torch_convert_depth_anything.py \
        --ckpt state_dict.pt --num_heads 6 --out_indices 9 10 11 12
    python scripts/torch_convert_depth_anything.py --model LOCAL_HF_DIR   # needs transformers

`--ckpt` is the torch state dict of a `DepthAnythingForDepthEstimation`
(the published `depth-anything/*-hf` checkpoints' layout, as
`scripts/convert_depth_anything.py` reads it through transformers). The
attention heads and the tapped layers come from the checkpoint's
`config.json` (`backbone_config.num_attention_heads`,
`backbone_config.out_indices`) or from `--num_heads` / `--out_indices`.
The `.npz` is array for array the file `scripts/convert_depth_anything.py`
writes from the same checkpoint, so one file serves both packages. Point
`$SPLAT_DEPTH_ANYTHING_WEIGHTS` at it (or place it under
`splatter_a_video_tpu_torch/weights/`) and the port's
`data/preprocess.compute_monodepth` runs. Needs torch, numpy and the port;
transformers only for `--model`.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def backbone_config(path: str):
    """(num_heads, out_indices) from a Depth-Anything `config.json`."""
    with open(path) as f:
        bcfg = json.load(f)["backbone_config"]
    return int(bcfg["num_attention_heads"]), [int(i) for i in bcfg["out_indices"]]


def load_hf_model(model_dir: str):
    """(state dict, num_heads, out_indices) of a local HF checkpoint
    directory, through transformers, without network access."""
    from transformers import AutoModelForDepthEstimation

    model = AutoModelForDepthEstimation.from_pretrained(model_dir, local_files_only=True)
    bcfg = model.config.backbone_config
    return model.state_dict(), bcfg.num_attention_heads, list(bcfg.out_indices)


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="torch state_dict of DepthAnythingForDepthEstimation (.pt / .bin)")
    src.add_argument("--model", help="local HF checkpoint directory (needs transformers)")
    ap.add_argument("--config", help="the checkpoint's config.json (heads and tapped layers)")
    ap.add_argument("--num_heads", type=int, help="attention heads of the DINOv2 trunk")
    ap.add_argument("--out_indices", type=int, nargs="+", help="the trunk layers the neck taps")
    ap.add_argument("--out", default="weights/depth_anything.npz")
    args = ap.parse_args(argv)

    from splatter_a_video_tpu_torch.nets import depth_anything as da

    if args.model:
        sd, num_heads, out_indices = load_hf_model(args.model)
    else:
        import torch

        sd = torch.load(args.ckpt, map_location="cpu")
        if args.config:
            num_heads, out_indices = backbone_config(args.config)
        elif args.num_heads and args.out_indices:
            num_heads, out_indices = args.num_heads, args.out_indices
        else:
            ap.error("--ckpt needs --config, or --num_heads and --out_indices")
    # strict: every checkpoint key must be consumed (upstream-rename guard)
    params = da.params_from_torch(sd, strict=True)
    da.save_params(args.out, params, num_heads=num_heads, out_indices=out_indices)
    print(f"wrote {args.out}: {len(params)} arrays, heads={num_heads}, out_indices={out_indices}")


if __name__ == "__main__":
    main()
