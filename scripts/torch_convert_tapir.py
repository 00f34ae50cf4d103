"""Convert a (Boots)TAPIR torch checkpoint to the `.npz` the port reads.

Usage (on a machine with the checkpoint available):
    python scripts/torch_convert_tapir.py \
        --ckpt bootstapir_checkpoint_v2.pt --out weights/tapir.npz

The checkpoint is the torch state dict of the reference's `tapnet_torch`
TAPIR (the reference's `src/data_preparation/compute_tracks_torch.py:87-93`).
The `.npz` is array for array the file `scripts/convert_tapir.py` writes
from the same checkpoint, so one file serves both packages. Point
`$SPLAT_TAPIR_WEIGHTS` at it (or place it under
`splatter_a_video_tpu_torch/weights/`) and the port's
`data/preprocess.compute_tracks` runs. Needs torch, numpy and the port only.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_state_dict(path: str):
    """The checkpoint's state dict; some checkpoints nest it under
    'model' / 'state_dict'."""
    import torch

    sd = torch.load(path, map_location="cpu")
    if not any(k.startswith("resnet_torch") for k in sd):
        for key in ("model", "state_dict"):
            if key in sd:
                sd = sd[key]
                break
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="torch TAPIR state_dict (.pt)")
    ap.add_argument("--out", default="weights/tapir.npz")
    args = ap.parse_args(argv)

    from splatter_a_video_tpu_torch.nets import tapir

    # strict: every checkpoint key must be consumed, so an upstream rename
    # of the block-pattern keys fails instead of converting nothing
    params = tapir.params_from_torch(load_state_dict(args.ckpt), strict=True)
    tapir.save_params(args.out, params)
    print(f"wrote {args.out}: {len(params)} arrays")


if __name__ == "__main__":
    main()
