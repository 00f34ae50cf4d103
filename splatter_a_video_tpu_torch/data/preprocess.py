"""Offline preprocessing stages (counterpart of
`splatter_a_video_tpu/data/preprocess.py`).

The reference's data preparation runs three pretrained networks (UniDepth
metric depth, Depth-Anything monocular disparity, TAPIR dense tracks) and
one pure-math step: aligning monocular disparity to metric disparity with a
median scale / shift. The alignment is here exactly; the network stages run
through the port's networks (`nets/depth_anything.py`, `nets/tapir.py`) on
`device` when converted checkpoints are present, and through an installed
`unidepth` for metric depth; each is gated (NotImplementedError) without
its dependency. `data/synthetic.py` writes the same layout hermetically.
The directory drivers import `imageio` when they run.

Expected output layout (consumed by `data/video_flow.py`, reference
`data_preparation/README.md:39-60`):
  images/, masks/, aligned_depth_anything_v2/*.npy,
  marigold/depth_npy/*_pred.npy, bootstapir/{q}_{t}.npy
"""

from __future__ import annotations

import json
import os
import os.path as osp
from glob import glob
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

UINT16_MAX = 65535


def align_disparity(
    mono_disp: np.ndarray, metric_disp: np.ndarray
) -> Tuple[np.ndarray, float, float]:
    """Median scale/shift alignment of one monocular disparity map to a
    metric one (`compute_depth.py:111-124`):

        scale = median((metric - median(metric)) / (mono - median(mono)))
        shift = median(metric - scale * mono)
        aligned = scale * mono + shift, with values below
        min(1e-6, q01(aligned)) zeroed as invalid.

    Returns (aligned, scale, shift).
    """
    ms_metric = metric_disp - np.median(metric_disp) + 1e-8
    ms_mono = mono_disp - np.median(mono_disp) + 1e-8
    scale = float(np.median(ms_metric / ms_mono))
    shift = float(np.median(metric_disp - scale * mono_disp))
    aligned = scale * mono_disp + shift
    min_thre = min(1e-6, float(np.quantile(aligned, 0.01)))
    aligned = np.where(aligned < min_thre, 0.0, aligned)
    return aligned, scale, shift


# A metric-depth backend: (rgb[H,W,3] uint8, intrinsics[3,3]|None) ->
# {"depth": [H,W] meters, "intrinsics": [3,3]}.
MetricDepthModel = Callable[[np.ndarray, Optional[np.ndarray]], Dict[str, np.ndarray]]


def _unidepth_backend() -> Optional[MetricDepthModel]:
    """The reference's backend (`compute_metric_depth.py:16,33`): UniDepth V2,
    an *external* repo even there (`sys.path.append(UNIDEPTH_PATH)`), never
    vendored. Available only if a `unidepth` install is importable here."""
    try:
        from unidepth.models import UniDepthV2  # type: ignore
    except ImportError:
        return None
    model = UniDepthV2.from_pretrained("lpiccinelli/unidepth-v2-vitl14").eval()

    def run(rgb: np.ndarray, intrinsics: Optional[np.ndarray]):
        # `compute_metric_depth.py:62-70`
        rgb_t = torch.from_numpy(rgb).permute(2, 0, 1)
        intr_t = None if intrinsics is None else torch.from_numpy(intrinsics)
        pred = model.infer(rgb_t, intr_t)
        return {k: v.squeeze().cpu().numpy() for k, v in pred.items()}

    return run


def compute_metric_depth(
    img_dir: str,
    depth_dir: str,
    intrins_file: str,
    model: Optional[MetricDepthModel] = None,
) -> int:
    """Metric-depth inference driver (`compute_metric_depth.py:18-59`):
    per frame, write disparity `1/clip(depth, 1e-6, 1e6)` to
    `depth_dir/<name>.npy` and collect per-frame pinhole intrinsics
    `(fx, fy, cx, cy)` into one `intrins_file` json. Skips entirely when
    the output is already complete (returns 0). `model` defaults to the
    external UniDepth V2 backend, gated when not installed."""
    import imageio.v2 as iio

    img_files = sorted(os.listdir(img_dir))
    if not intrins_file.endswith(".json"):
        intrins_file = f"{intrins_file}.json"
    os.makedirs(depth_dir, exist_ok=True)
    parent = osp.dirname(intrins_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    if len(os.listdir(depth_dir)) == len(img_files) and osp.isfile(intrins_file):
        return 0

    if model is None:
        model = _unidepth_backend()
    if model is None:
        raise NotImplementedError(
            "UniDepth is an external dependency (the reference imports it "
            "from a local clone, compute_metric_depth.py:10-16) and is not "
            "installed here; pass `model=` or generate the layout "
            "hermetically with data/synthetic.py."
        )

    intrins_dict = {}
    n = 0
    for img_file in img_files:
        img_name = osp.splitext(img_file)[0]
        pred = model(iio.imread(osp.join(img_dir, img_file))[..., :3], None)
        disp = 1.0 / np.clip(pred["depth"], a_min=1e-6, a_max=1e6)
        np.save(osp.join(depth_dir, img_name + ".npy"), disp.squeeze())
        K = pred["intrinsics"]
        intrins_dict[img_name] = (
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
        )
        n += 1
    with open(intrins_file, "w") as f:
        json.dump(intrins_dict, f, indent=1)
    return n


def align_monodepth_with_metric_depth(
    metric_depth_dir: str,
    input_monodepth_dir: str,
    output_monodepth_dir: str,
    matching_pattern: str = "*",
) -> int:
    """Directory driver (`compute_depth.py:90-126`): uint16 disparity pngs
    + metric npys -> aligned npys. Skips when the output is complete.
    Returns the number of frames written (0 = skipped)."""
    import imageio.v2 as iio

    mono_paths = sorted(glob(f"{input_monodepth_dir}/{matching_pattern}"))
    img_files = [osp.basename(p) for p in mono_paths]
    os.makedirs(output_monodepth_dir, exist_ok=True)
    if len(os.listdir(output_monodepth_dir)) == len(img_files):
        return 0
    n = 0
    for f in img_files:
        imname = os.path.splitext(f)[0]
        mono = iio.imread(osp.join(input_monodepth_dir, f)) / UINT16_MAX
        metric = np.load(osp.join(metric_depth_dir, imname + ".npy"))
        aligned, _, _ = align_disparity(mono, metric)
        np.save(osp.join(output_monodepth_dir, imname + ".npy"), aligned)
        n += 1
    return n


def disp_to_uint16(disp: np.ndarray) -> np.ndarray:
    """Quantize a relative disparity map to uint16 png range, matching the
    Depth-Anything export convention (`compute_depth.py:36-56`:
    min-max-normalized then scaled to UINT16_MAX)."""
    lo, hi = float(disp.min()), float(disp.max())
    x = (disp - lo) / max(hi - lo, 1e-12)
    return (x * UINT16_MAX).astype(np.uint16)


def compute_monodepth(img_dir: str, out_dir: str, model: str = "depth-anything-v2", device="cuda"):
    """Monocular disparity inference (`compute_depth.py:59-88`) through the
    port's Depth-Anything (`nets/depth_anything.py`) on `device`. Runs when
    a converted checkpoint is present (`$SPLAT_DEPTH_ANYTHING_WEIGHTS` or
    `weights/depth_anything.npz`); weights are not downloadable offline.
    Writes `<name>.png` uint16 disparity per frame; returns frames written."""
    from ..nets import depth_anything as _da

    net = _da.get_model(device=device)
    if net is None:
        raise NotImplementedError(
            "Depth-Anything weights are not available in this offline "
            "environment; convert a checkpoint with "
            "scripts/torch_convert_depth_anything.py, or generate "
            "the layout hermetically with data/synthetic.py."
        )
    import imageio.v2 as iio

    img_files = sorted(glob(osp.join(img_dir, "*.jpg"))) + sorted(
        glob(osp.join(img_dir, "*.png"))
    )
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for f in img_files:
        disp = _da.infer_disparity(net, iio.imread(f)[..., :3])
        out = osp.join(out_dir, osp.splitext(osp.basename(f))[0] + ".png")
        iio.imwrite(out, disp_to_uint16(disp))
        n += 1
    return n


def compute_tracks(
    img_dir: str,
    mask_dir: str,
    out_dir: str,
    grid_size: int = 4,
    resize: Tuple[int, int] = (256, 256),
    query_chunk: int = 128,
    device="cuda",
) -> int:
    """Dense TAPIR tracking (`compute_tracks_torch.py:101-166`) through the
    port's TAPIR (`nets/tapir.py`) on `device`. Runs when a converted BootsTAPIR
    checkpoint is present (`$SPLAT_TAPIR_WEIGHTS` or `weights/tapir.npz`);
    the checkpoint is not downloadable offline — without it this stays
    gated and `data/synthetic.py` emits the same layout hermetically.

    Per query frame q, every grid point (stride `grid_size`) inside the
    mask is tracked through all frames; per-pair `{q}_{t}.npy [N, 4] =
    (x, y, occ_logit, expected_dist)` files are written with the
    query-frame coords snapped to the original grid. Returns files written.
    Deviation (documented): frames are resized to the inference resolution
    with torch-bilinear rather than mediapy's PIL resize.
    """
    from ..nets import tapir as _tapir
    from ..nets.interp import interp2d

    net = _tapir.get_model(device=device)
    if net is None:
        raise NotImplementedError(
            "BootsTAPIR checkpoint not available offline; convert one with "
            "scripts/torch_convert_tapir.py, or use data/synthetic.py which emits "
            "the same {q}_{t}.npy layout hermetically."
        )
    import imageio.v2 as iio

    frame_paths = sorted(glob(osp.join(img_dir, "*")))
    names = [osp.splitext(osp.basename(f))[0] for f in frame_paths]
    video = np.stack([iio.imread(f)[..., :3] for f in frame_paths])
    T, height, width = video.shape[:3]
    mask_paths = sorted(glob(osp.join(mask_dir, "*")))
    masks = np.stack(
        [np.atleast_3d(iio.imread(f))[..., 0] > 0 for f in mask_paths]
    )

    rh, rw = resize
    video_r = interp2d(torch.from_numpy(video.astype(np.float32)), rh, rw, "bilinear", False).numpy()
    video_r = video_r.astype(np.uint8)

    y, x = np.mgrid[0:height:grid_size, 0:width:grid_size]
    y_r = y / (height - 1) * (rh - 1)
    x_r = x / (width - 1) * (rw - 1)

    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for t in range(T):
        if len(glob(f"{out_dir}/{names[t]}_*.npy")) == T:
            continue
        in_mask = masks[t][y, x]
        qp = np.stack(
            [t * np.ones_like(y)[in_mask], y_r[in_mask], x_r[in_mask]], axis=-1
        )
        if len(qp):
            res = _tapir.track_points(net, video_r, qp, chunk=query_chunk)
            # back to the original raster (compute_tracks_torch.py:148-150)
            tracks = res["tracks"] * np.array(
                [(width - 1) / (rw - 1), (height - 1) / (rh - 1)]
            )
            out = np.concatenate(
                [tracks, res["occlusion"][..., None],
                 res["expected_dist"][..., None]], axis=-1
            ).astype(np.float32)
        else:
            out = np.zeros((0, T, 4), np.float32)
        for j in range(T):
            if j == t and len(qp):
                out[:, j, :2] = np.stack([x[in_mask], y[in_mask]], axis=-1)
            np.save(f"{out_dir}/{names[t]}_{names[j]}.npy", out[:, j])
            written += 1
    return written
