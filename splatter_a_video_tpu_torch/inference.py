"""Rendering and tracking with a trained video-Gaussian scene (counterpart
of the rendering and tracking part of `splatter_a_video_tpu/inference.py`):
video, novel views, stereo, point correspondences and Gaussian
trajectories.

Entry points run on `device="cuda"` unless told otherwise and raise when
no GPU is present rather than running on the CPU. Selection, appearance
optimisation and layer editing come in a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.video_flow import bilinear_sample
from .device import resolve_device
from .models import camera as _camera
from .models.gaussians import GaussianScene
from .ops import rasterize as _raster
from .train.losses import denormalize_coords


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


@torch.no_grad()
def track_correspondences(
    scene: GaussianScene,
    t1: float,
    px1s: np.ndarray,
    t2: float,
    cam: _camera.Camera,
    rcfg: _raster.RasterizeConfig,
    occlusion_eps: float = 0.02,
    device="cuda",
):
    """Predicted pixels in frame t2 and occlusion of the query pixels px1s
    [N, 2] of frame t1: the t2 Gaussian positions are blended into frame
    t1's render as `track_gs` and read at the queries; a query is occluded
    when frame t2's rendered depth at its predicted pixel lies more than
    `occlusion_eps` in front of the tracked point's depth.

    Known quirk, kept from the JAX package (`inference.py:206-210`): the
    track map is sampled at normalised coordinates with an epsilon
    tolerance, unlike the reference, which fed pixel coordinates to its
    `grid_sample`.

    Returns (px2s [N, 2] pixel coordinates, occluded [N] bool).
    """
    dev = resolve_device(device)
    scene = scene.to(dev)
    H, W = cam.height, cam.width
    extr = torch.as_tensor(cam.extrinsic, dtype=torch.float32, device=dev)
    pos2 = scene.get_position(float(t2))
    inp, _ = _scene_inputs(scene, float(t1), ())
    out = _raster.render_gaussians(
        inp["position"], inp["scaling"], inp["rotation"], inp["opacity"],
        inp["shs"], extr, rcfg, extra_features={"track_gs": pos2},
    )
    track_map = out.features["track_gs"]                               # [H, W, 3]
    pred_2d = denormalize_coords(track_map[..., :2], H, W).cpu().numpy()  # pixels in frame t2
    track_map = track_map.cpu().numpy()
    px1s = np.asarray(px1s)
    px2s = bilinear_sample(pred_2d, px1s)                  # [N, 2]
    track_depth = bilinear_sample(track_map[..., 2], px1s)  # [N]

    out2 = render_frame(scene, float(t2), cam.extrinsic, rcfg, device=dev)
    depth2 = out2.features["depth"][..., 0].cpu().numpy()
    surf_depth = bilinear_sample(depth2, px2s)
    occluded = surf_depth < (track_depth - occlusion_eps)
    return px2s, occluded


@torch.no_grad()
def gaussian_trajectories(
    scene: GaussianScene, times: Sequence[float], sample: int = 512,
    rng: Optional[np.random.RandomState] = None, device="cuda",
) -> np.ndarray:
    """[S, T, 3] centre trajectories of `sample` alive Gaussians drawn
    from `rng` (seed 0 by default, as in the JAX package)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    rng = rng or np.random.RandomState(0)
    alive_idx = np.nonzero(scene.alive.cpu().numpy())[0]
    sel = rng.choice(alive_idx, min(sample, len(alive_idx)), replace=False)
    sel_t = torch.from_numpy(sel).to(dev)
    return np.stack([scene.get_position(float(t))[sel_t].cpu().numpy() for t in times], axis=1)
