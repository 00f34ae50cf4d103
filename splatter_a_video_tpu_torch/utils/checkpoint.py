"""Checkpoint and resume of the training state (counterpart of
`splatter_a_video_tpu/utils/checkpoint.py`, in a torch format).

`out_dir/ckpt_{step:06d}/state.pt` holds the whole `TrainState`: the scene's
params and aux, its `SceneConfig` as a dict, Adam's shared `count` and its
`mu` / `nu`, the `DensifyState`, the step and the PRNG key. With all of
them, a restored run continues exactly where the saved one stood. Files
load with `torch.load(..., weights_only=True)`. The JAX package's orbax
checkpoints are not read here: scenes cross between the packages as
numpy (`convert.py`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from ..device import resolve_device

_FILE = "state.pt"


def _ckpt_dir(out_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(out_dir), f"ckpt_{step:06d}")


def state_dict(state) -> dict:
    """The plain dict of tensors and numbers that a checkpoint stores."""
    scene = state.scene
    return {
        "params": {k: v.detach() for k, v in scene.params.items()},
        "aux": dict(scene.aux),
        "scene_cfg": dataclasses.asdict(scene.cfg),
        "opt": {"count": int(state.opt_state.count), "mu": dict(state.opt_state.mu),
                "nu": dict(state.opt_state.nu)},
        "densify": state.densify_state._asdict(),
        "step": int(state.step),
        "key": state.key,
    }


def save_checkpoint(out_dir: str, state, step: int) -> str:
    path = _ckpt_dir(out_dir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(state_dict(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def latest_step(out_dir: str) -> Optional[int]:
    if not os.path.isdir(out_dir):
        return None
    steps = []
    for name in os.listdir(out_dir):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_state_dict(out_dir: str, step: Optional[int] = None, device="cuda"):
    """(the stored dict with its tensors on `device`, step), or (None,
    None) without a checkpoint."""
    if step is None:
        step = latest_step(out_dir)
    if step is None:
        return None, None
    dev = resolve_device(device)
    d = torch.load(os.path.join(_ckpt_dir(out_dir, step), _FILE), map_location=dev, weights_only=True)
    return d, step


def restore_checkpoint(out_dir: str, example_state=None, step: Optional[int] = None, device=None):
    """(TrainState, step) from the newest (or the given) checkpoint, or
    (None, None) if there is none. The state goes to `device`, by default
    the device of `example_state`; the key stays on the CPU."""
    from ..models.gaussians import GaussianScene
    from ..train import density as _density
    from ..train import optim as _optim
    from ..train.trainer import TrainState
    from ..convert import _scene_config

    if device is None:
        device = example_state.scene.device if example_state is not None else "cuda"
    d, step = load_state_dict(out_dir, step, device)
    if d is None:
        return None, None
    state = TrainState(
        scene=GaussianScene(params=d["params"], aux=d["aux"], cfg=_scene_config(d["scene_cfg"])),
        opt_state=_optim.AdamState(count=int(d["opt"]["count"]), mu=d["opt"]["mu"], nu=d["opt"]["nu"]),
        densify_state=_density.DensifyState(**d["densify"]),
        step=int(d["step"]),
        key=d["key"].cpu(),
    )
    return state, step
