"""Scene (de)serialisation between a training output directory and the
renderers (counterpart of `splatter_a_video_tpu/apps/train_state_io.py`):
restore a `GaussianScene` from the port's checkpoint format without the
rest of the train state."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


def save_scene_cfg(out_dir: str, scene) -> None:
    cfg = dataclasses.asdict(scene.cfg)
    with open(os.path.join(out_dir, "scene_cfg.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)


def load_scene_from_ckpt(out_dir: str, step: Optional[int] = None, device="cuda"):
    """The scene of the newest (or the given) checkpoint, on `device`. The
    config stored in the checkpoint is used; `scene_cfg.json` beside it is
    for readers of the directory."""
    from ..convert import _scene_config
    from ..models.gaussians import GaussianScene
    from ..utils.checkpoint import load_state_dict

    d, step = load_state_dict(out_dir, step, device)
    if d is None:
        raise FileNotFoundError(f"no checkpoints under {out_dir}")
    return GaussianScene(params=d["params"], aux=d["aux"], cfg=_scene_config(d["scene_cfg"]))
