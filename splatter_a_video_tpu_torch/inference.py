"""Rendering a trained video-Gaussian scene (counterpart of the rendering
part of `splatter_a_video_tpu/inference.py`): video, novel views, stereo.

Entry points run on `device="cuda"` unless told otherwise and raise when
no GPU is present rather than running on the CPU. Tracking, selection,
appearance optimisation and layer editing come in later slices.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import camera as _camera
from .models.gaussians import GaussianScene
from .ops import rasterize as _raster


def _scene_inputs(scene: GaussianScene, t, extra_names: Sequence[str]):
    inp = dict(
        position=scene.get_position(t),
        scaling=scene.get_scaling(),
        rotation=scene.get_rotation(t),
        opacity=scene.get_opacity(),
        shs=scene.get_shs(),
    )
    extra = {}
    for n in extra_names:
        if n == "pos_poly_feat":  # motion coefficients, rendered raw
            v = scene.params[n]
            extra[n] = v.reshape(v.shape[0], -1)
        elif n in scene.params:
            extra[n] = scene.get_render_attribute(n)
    return inp, extra


@torch.no_grad()
def render_frame(
    scene: GaussianScene,
    t,
    extr,
    rcfg: _raster.RasterizeConfig,
    extra_names: Tuple[str, ...] = (),
    bg: float = 1.0,
    device="cuda",
) -> _raster.RenderOutput:
    """Render one frame (rgb/depth + named attributes) at (possibly
    fractional) time t with the [3,4] world->camera `extr`."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    extr = torch.as_tensor(extr, dtype=torch.float32, device=dev)
    inp, extra = _scene_inputs(scene, t, extra_names)
    return _raster.render_gaussians(
        inp["position"], inp["scaling"], inp["rotation"], inp["opacity"],
        inp["shs"], extr, rcfg, extra_features=extra, bg_color=bg,
    )


def _rgb(out: _raster.RenderOutput) -> np.ndarray:
    return np.clip(out.features["rgb"].cpu().numpy(), 0, 1)


def render_video(
    scene: GaussianScene,
    cam: _camera.Camera,
    rcfg: _raster.RasterizeConfig,
    times: Sequence[float],
    extra_names: Tuple[str, ...] = (),
    batched: bool = False,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Render a frame sequence; fractional times interpolate.

    Returns {"rgb": [F,H,W,3] clipped to [0,1], "depth": [F,H,W], name:
    [F,H,W,c]}. `batched` is accepted for the JAX signature: PyTorch runs
    eagerly, so both forms render frame by frame with the same result.
    """
    del batched
    dev = resolve_device(device)
    scene = scene.to(dev)
    rgbs, depths, extras = [], [], {n: [] for n in extra_names}
    for t in times:
        out = render_frame(scene, t, cam.extrinsic, rcfg, extra_names, device=dev)
        rgbs.append(_rgb(out))
        depths.append(out.features["depth"][..., 0].cpu().numpy())
        for n in extra_names:
            extras[n].append(out.features[n].cpu().numpy())
    res = {"rgb": np.stack(rgbs), "depth": np.stack(depths)}
    for n in extra_names:
        res[n] = np.stack(extras[n])
    return res


def render_nvs(
    scene: GaussianScene,
    base_cam: _camera.Camera,
    rcfg: _raster.RasterizeConfig,
    times: Sequence[float],
    radius: float = 0.15,
    at: Tuple[float, float, float] = (0.0, 0.0, 1.0),
    device="cuda",
) -> np.ndarray:
    """Orbit novel-view synthesis: one orbit camera per frame. [F,H,W,3]."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    cams = _camera.orbit_cameras(base_cam, len(times), radius=radius, at=at)
    return np.stack([
        _rgb(render_frame(scene, t, cam.extrinsic, rcfg, device=dev))
        for t, cam in zip(times, cams)
    ])


ANAGLYPH_MATRICES = {
    # left 3x3 | right 3x3 acting on (rgb_left, rgb_right) -> rgb
    "true": ([[0.299, 0.587, 0.114], [0, 0, 0], [0, 0, 0]],
             [[0, 0, 0], [0, 0, 0], [0.299, 0.587, 0.114]]),
    "color": ([[1, 0, 0], [0, 0, 0], [0, 0, 0]],
              [[0, 0, 0], [0, 1, 0], [0, 0, 1]]),
    "optimized": ([[0, 0.7, 0.3], [0, 0, 0], [0, 0, 0]],
                  [[0, 0, 0], [0, 1, 0], [0, 0, 1]]),
}


def render_stereo(
    scene: GaussianScene,
    base_cam: _camera.Camera,
    rcfg: _raster.RasterizeConfig,
    times: Sequence[float],
    baseline: float = 0.1,
    at: Tuple[float, float, float] = (0.0, 0.0, 2.5),
    mode: str = "optimized",
    device="cuda",
) -> np.ndarray:
    """Anaglyph stereo video from a left/right camera pair. [F,H,W,3]."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    left, right = _camera.stereo_cameras(base_cam, baseline=baseline, at=at)
    ml, mr = (np.asarray(m, np.float32) for m in ANAGLYPH_MATRICES[mode])
    frames = []
    for t in times:
        il = _rgb(render_frame(scene, t, left.extrinsic, rcfg, device=dev))
        ir = _rgb(render_frame(scene, t, right.extrinsic, rcfg, device=dev))
        frames.append(il @ ml.T + ir @ mr.T)
    return np.stack(frames)
