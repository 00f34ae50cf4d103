"""Tap-Vid tracking metrics: AJ, delta_avg, OA, TC (counterpart of
`splatter_a_video_tpu/eval/tapvid.py`).

The TAP-Vid protocol (Doersch et al. 2022): metrics over pixel-error thresholds
{1, 2, 4, 8, 16} measured in the 256x256-normalized image space, evaluated
at visible ground-truth points; occlusion accuracy over all points; plus
CoDeF-style temporal coherence (mean L2 between consecutive predicted and
ground-truth flows at co-visible points).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

THRESHOLDS = (1.0, 2.0, 4.0, 8.0, 16.0)
EVAL_SIZE = 256.0  # TAP-Vid thresholds are defined at 256x256 resolution


def _scale_to_eval(px: np.ndarray, W: int, H: int) -> np.ndarray:
    return px * np.array([EVAL_SIZE / W, EVAL_SIZE / H], np.float32)


def compute_tapvid_metrics(
    pred_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    gt_occluded: np.ndarray,
    W: int,
    H: int,
    query_frame: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """TAP-Vid metrics for one clip.

    Args:
      pred_tracks / gt_tracks: [N, T, 2] pixel coords.
      pred_occluded / gt_occluded: [N, T] bool.
      query_frame: optional [N] query frame indices to exclude from eval
        (the query point itself is trivially correct).
    Returns dict with average_jaccard, delta_avg, occlusion_accuracy,
    temporal_coherence (+ per-threshold entries).
    """
    N, T, _ = pred_tracks.shape
    p = _scale_to_eval(pred_tracks, W, H)
    g = _scale_to_eval(gt_tracks, W, H)
    dist = np.linalg.norm(p - g, axis=-1)  # [N, T]

    evaluate = np.ones((N, T), bool)
    if query_frame is not None:
        evaluate[np.arange(N), query_frame] = False

    gt_visible = ~gt_occluded & evaluate
    pred_visible = ~pred_occluded

    # occlusion accuracy over all evaluated points
    oa = float(
        np.sum((pred_occluded == gt_occluded) & evaluate) / max(np.sum(evaluate), 1)
    )

    deltas, jaccards = [], []
    for thr in THRESHOLDS:
        within = dist <= thr
        # delta: fraction of visible gt points tracked within thr
        d = float(np.sum(within & gt_visible) / max(np.sum(gt_visible), 1))
        deltas.append(d)
        # jaccard: TP / (TP + FP + FN)
        tp = np.sum(within & gt_visible & pred_visible)
        fp = np.sum(pred_visible & evaluate & ~(within & gt_visible))
        fn = np.sum(gt_visible & ~(within & pred_visible))
        jaccards.append(float(tp / max(tp + fp + fn, 1)))

    # temporal coherence: mean L2 between consecutive pred/gt flows at
    # co-visible consecutive points (lower is better)
    flow_p = p[:, 1:] - p[:, :-1]
    flow_g = g[:, 1:] - g[:, :-1]
    covis = gt_visible[:, 1:] & gt_visible[:, :-1]
    if covis.sum() > 0:
        tc = float(np.linalg.norm(flow_p - flow_g, axis=-1)[covis].mean())
    else:
        tc = float("nan")

    out = {
        "average_jaccard": float(np.mean(jaccards)) * 100.0,
        "delta_avg": float(np.mean(deltas)) * 100.0,
        "occlusion_accuracy": oa * 100.0,
        "temporal_coherence": tc,
    }
    for thr, d, j in zip(THRESHOLDS, deltas, jaccards):
        out[f"delta_{int(thr)}"] = d * 100.0
        out[f"jaccard_{int(thr)}"] = j * 100.0
    return out


def evaluate_scene_tracking(
    scene,
    data,
    cam,
    rcfg,
    num_queries: int = 256,
    query_stride: int = 4,
    rng: Optional[np.random.RandomState] = None,
    device="cuda",
) -> Dict[str, float]:
    """Evaluate a trained scene's tracking against the clip's (TAPIR or
    ground-truth) tracks.

    Queries are sampled from frame-0 track points; predictions come from
    `inference.track_correspondences` per target frame, on `device`.
    """
    from .. import inference
    from ..data.video_flow import parse_tapir_track_info
    from ..device import resolve_device

    rng = rng or np.random.RandomState(0)
    T = data.num_frames
    H, W = data.image_size
    scene = scene.to(resolve_device(device))

    tr = data.load_target_tracks(0, list(range(T)))  # [N, T, 4]
    if len(tr) > num_queries:
        tr = tr[rng.choice(len(tr), num_queries, replace=False)]
    gt_xy = tr[..., :2]
    vis, invis, conf = parse_tapir_track_info(tr[..., 2], tr[..., 3])
    gt_occ = ~vis

    q_px = gt_xy[:, 0]  # queries at frame 0
    preds = np.zeros_like(gt_xy)
    pred_occ = np.zeros(gt_occ.shape, bool)
    for t in range(T):
        px2, occ = inference.track_correspondences(
            scene, 0.0, q_px, float(t), cam, rcfg, device=scene.device
        )
        preds[:, t] = px2
        pred_occ[:, t] = occ
    return compute_tapvid_metrics(
        preds, pred_occ, gt_xy, gt_occ, W, H,
        query_frame=np.zeros(len(preds), np.int64),
    )
