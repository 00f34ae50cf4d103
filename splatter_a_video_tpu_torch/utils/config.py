"""Two-tier configuration: CLI flags and a YAML model config (counterpart
of `splatter_a_video_tpu/utils/config.py`, with the same flags and
defaults plus `--device`).

  * run-level flags from a `key = value` flag file (`--config`) and the
    command line;
  * the model / optimizer / renderer YAML applied onto the typed trainer
    and fit configs (`apply_gs_config`); `yaml` is imported only to read
    one;
  * per-step scalars `C(value, step)`: a value may be a list [start_step,
    start_value, end_step, end_value], linearly interpolated over steps.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T")


def C(value: Any, step: float = 0.0) -> float:
    """Scalar schedule resolver — parity with `C()` (`utils/config.py:32-53`):
    plain numbers pass through; [start_step, start_val, end_step, end_val]
    linearly interpolates by step."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, (list, tuple)) and len(value) == 4:
        s0, v0, s1, v1 = map(float, value)
        if step <= s0:
            return v0
        if step >= s1:
            return v1
        t = (step - s0) / max(s1 - s0, 1e-9)
        return v0 + (v1 - v0) * t
    raise ValueError(f"unresolvable config scalar: {value!r}")


def parse_structured(cls: Type[T], cfg: Optional[Dict[str, Any]]) -> T:
    """Dict -> (nested) dataclass, ignoring unknown keys — the lenient
    behavior of `parse_structured` (`utils/config.py:113-118`)."""
    cfg = cfg or {}
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in cfg.items():
        if k not in fields:
            continue
        ftype = fields[k].type
        fval = fields[k].default_factory() if fields[k].default_factory is not dataclasses.MISSING else None  # type: ignore
        if dataclasses.is_dataclass(fval.__class__) and isinstance(v, dict) and fval is not None:
            kwargs[k] = parse_structured(fval.__class__, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# YAML param-group names -> the scene's attribute names
_ATTR_RENAME = {"features": "features_dc", "pos_cubic_node": "pos_cubic_coeff"}


def apply_gs_config(yaml_cfg: Dict[str, Any], tcfg, fcfg):
    """Apply a reference-style model YAML (`frag_gs_v10.yaml`) onto the typed
    trainer/fit configs; returns replaced (tcfg, fcfg) copies.

    Mapping (reference -> here):
      trainer.max_steps                  -> TrainerConfig.max_steps + the
                                            lr-schedule horizon (OptimConfig)
      trainer.model.lambda_dssim         -> TrainerConfig.lambda_dssim
      optimizer.*.args.eps               -> OptimConfig.eps
      optimizer.*.extra_cfg.*            -> DensifyConfig fields (same names)
      optimizer.*.params.point_cloud.X.lr-> OptimConfig.lrs[X]
      scheduler.params.point_cloud.X     -> OptimConfig.schedules[X]
      dataset.white_bg                   -> TrainerConfig.white_bg
      render_attributes                  -> FitConfig.render_attributes +
                                            TrainerConfig.train_render_attributes
    (`pos_poly_feat` in render_attributes refers to an existing trajectory
    parameter, not a new attribute — the trainer blends it whenever
    train_render_attributes is on, `trainer.py`.) The point-cloud initializer
    block is informational here: initialization comes from lifted tracks
    (`fit.build_scene_from_clip`), the production path of the reference too.
    """
    tr = (yaml_cfg or {}).get("trainer", {}) or {}
    model = tr.get("model", {}) or {}
    opt_all = tr.get("optimizer", {}) or {}
    opt1 = next(iter(opt_all.values()), {}) if opt_all else {}
    extra = opt1.get("extra_cfg", {}) or {}
    dens_fields = {f.name for f in dataclasses.fields(type(tcfg.densify))}
    dens_kw = {
        k: type(getattr(tcfg.densify, k))(v)
        for k, v in extra.items()
        if k in dens_fields
    }

    lrs = dict(tcfg.optim.lrs)
    for pname, d in (opt1.get("params", {}) or {}).items():
        attr = pname.split(".")[-1]
        attr = _ATTR_RENAME.get(attr, attr)
        if isinstance(d, dict) and "lr" in d:
            lrs[attr] = float(d["lr"])
    schedules = dict(tcfg.optim.schedules)
    for pname, d in ((tr.get("scheduler", {}) or {}).get("params", {}) or {}).items():
        attr = pname.split(".")[-1]
        attr = _ATTR_RENAME.get(attr, attr)
        if isinstance(d, dict) and "init" in d and "final" in d:
            schedules[attr] = (float(d["init"]), float(d["final"]))

    max_steps = int(tr.get("max_steps", tcfg.max_steps))
    optim_new = dataclasses.replace(
        tcfg.optim,
        max_steps=max_steps,
        eps=float((opt1.get("args") or {}).get("eps", tcfg.optim.eps)),
        lrs=tuple(sorted(lrs.items())),
        schedules=tuple(sorted(schedules.items())),
    )
    tcfg_kw: Dict[str, Any] = dict(
        max_steps=max_steps,
        lambda_dssim=float(model.get("lambda_dssim", tcfg.lambda_dssim)),
        optim=optim_new,
        densify=dataclasses.replace(tcfg.densify, **dens_kw),
        white_bg=bool((tr.get("dataset") or {}).get("white_bg", tcfg.white_bg)),
    )
    ra = tr.get("render_attributes")
    if ra:
        fcfg = dataclasses.replace(
            fcfg,
            render_attributes=tuple(
                (k, int(v)) for k, v in ra.items() if k != "pos_poly_feat"
            ),
        )
        tcfg_kw["train_render_attributes"] = True
    return dataclasses.replace(tcfg, **tcfg_kw), fcfg


def make_arg_parser() -> argparse.ArgumentParser:
    """The training CLI's flags: those of the JAX package's
    `make_arg_parser`, with the same defaults, plus `--device`."""
    p = argparse.ArgumentParser("splatter_a_video_tpu_torch")
    p.add_argument("--config", type=str, default=None,
                   help="key=value flag file (configargparse style)")
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--seq_name", type=str, default="clip")
    p.add_argument("--out_dir", type=str, default="out")
    p.add_argument("--num_imgs", type=int, default=250,
                   help="frames to use (-1 = all; reference config.py:30)")
    p.add_argument("--base_idx", type=int, default=0,
                   help="first frame index of the clip sub-range "
                        "(reference trainer_fragGS.py:266-268)")
    p.add_argument("--num_iters", type=int, default=20000)
    p.add_argument("--loss_rgb_weight", type=float, default=10.0)
    p.add_argument("--loss_flow_weight", type=float, default=2.0)
    p.add_argument("--loss_mask_weight", type=float, default=0.0,
                   help="mask_attribute MSE weight (reference hand-enables "
                        "this at 20, trainer_fragGS.py:631-636)")
    p.add_argument("--loss_dino_weight", type=float, default=0.0,
                   help="dino_attribute MSE weight vs dinov2/ images "
                        "(reference hand value 20, trainer_fragGS.py:638-642)")
    p.add_argument("--gs_config_file", type=str, default=None,
                   help="model-level YAML (frag_gs_v10.yaml equivalent)")
    p.add_argument("--num_track_samples", type=int, default=4096)
    p.add_argument("--video_flow_margin", type=float, default=0.25,
                   help="bg border-grid extension margin "
                        "(reference config.py:48, trainer_fragGS.py:328)")
    p.add_argument("--start_interval", type=int, default=5,
                   help="curriculum start interval for the gaussian/flow "
                        "dataset types (reference train.py:81,201)")
    p.add_argument("--capacity_factor", type=float, default=2.0)
    p.add_argument("--traj", type=str, default="cubic_spline",
                   choices=["cubic_spline", "poly_fourier", "lbs"],
                   help="trajectory family: per-point spline over lifted "
                        "tracks (production), per-point poly+Fourier bases, "
                        "or shared LBS translation bones")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--i_print", type=int, default=100)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of a few "
                        "steady-state train steps into this directory; the "
                        "port's spans record while it does, and "
                        "fit_steps_A_B.spans.json beside it holds each "
                        "span's host and stream ms and the counters, per step")
    p.add_argument("--i_img", type=int, default=500)
    p.add_argument("--i_weight", type=int, default=5000)
    p.add_argument("--i_cache", type=int, default=0,
                   help="error-map resampling cadence: every i_cache steps "
                        "write per-frame photometric error to flow_error.txt "
                        "and bias id1 sampling by it (reference cadence "
                        "--i_cache, src/config.py:88; 0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the latest checkpoint in out_dir")
    p.add_argument("--export_ply", type=int, default=0,
                   help="also write point_cloud_{step}.ply at each "
                        "checkpoint (reference CheckPointHook exports ply + "
                        "pth, checkpoint_hook.py:11-44)")
    p.add_argument("--tensorboard", type=int, default=1)
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic clip (no datadir needed)")
    p.add_argument("--refine_camera", type=int, default=0,
                   help="jointly optimize per-frame se(3) camera twists "
                        "with the scene (train/camera_refine.py); the twists "
                        "are written to out_dir/camera_xi.npy, and to "
                        "out_dir/camera_refine.pt for --resume")
    p.add_argument("--camera_lr", type=float, default=1e-4,
                   help="Adam lr for the camera twists (--refine_camera)")
    p.add_argument("--camera_warmup", type=int, default=0,
                   help="pose-only warmup steps: scene gradients frozen, "
                        "camera lr boosted 10x (recover bad initial poses "
                        "before the scene absorbs them)")
    p.add_argument("--distributed", type=int, default=0,
                   help="data-parallel over torch.distributed ranks, one "
                        "process per GPU (launch with torchrun); at world "
                        "size 1 the plain step")
    p.add_argument("--dataset_types", type=str, default="simpleGS",
                   help="'+'-joined pair-sampling policies "
                        "(simpleGS/gaussian/flow/point), reference "
                        "create_training_dataset.py:165")
    p.add_argument("--dataset_weights", type=float, nargs="*", default=None,
                   help="mixture weights for '+'-joined dataset_types "
                        "(must sum to 1)")
    p.add_argument("--max_intersections", type=int, default=1 << 19,
                   help="static rasterizer slot budget (gaussian-tile "
                        "intersections); lower for small clips")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to train on; cuda (default) raises without a "
                        "GPU, cpu runs the plain PyTorch versions of the kernels")
    return p


def parse_flag_file(path: str) -> Dict[str, str]:
    """Parse a `key = value` flag file (`configs/config.txt`'s format)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = make_arg_parser()
    args, _ = p.parse_known_args(argv)
    if args.config:
        defaults = parse_flag_file(args.config)
        known = {a.dest: a for a in p._actions}
        # list-typed flags (nargs): split the file value into items so
        # argparse's per-item type applies (e.g. `dataset_weights = 0.8 0.2`)
        for k, v in list(defaults.items()):
            a = known.get(k)
            if a is not None and a.nargs in ("*", "+") and isinstance(v, str):
                defaults[k] = [a.type(x) if a.type else x for x in v.split()]
        p.set_defaults(**{k: v for k, v in defaults.items() if k in known})
        args, _ = p.parse_known_args(argv)
        # re-coerce scalar types for file-sourced values
        for a in p._actions:
            if (a.dest in defaults and a.type is not None
                    and a.nargs not in ("*", "+")
                    and isinstance(getattr(args, a.dest), str)):
                setattr(args, a.dest, a.type(getattr(args, a.dest)))
    return args
