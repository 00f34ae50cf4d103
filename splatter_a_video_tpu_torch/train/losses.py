"""The training losses of the main path (counterpart of
`splatter_a_video_tpu/train/losses.py`): photometric L1 + D-SSIM and PSNR,
the quantile-trimmed masked L1 and the TAPIR tracking loss, the
median-normalised depth loss and the ARAP rigidity energy.

Quantiles and medians are computed as the JAX package computes them
(sort, then linear interpolation; the median averages the two middle
values), not with `torch.median`, which returns the lower one. ARAP's
sample indices come in as a tensor, or are drawn from a JAX-compatible
key (`prng`) as the JAX package draws them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import to_device
from ..ops.knn import _pairwise_sq_dists
from ..ops.ssim import ssim as _ssim
from . import prng


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of all of x, in float32 as `jnp.quantile`."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * float(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1.0 - hw
    return s[int(lo)] * lw.to(s.device) + s[int(hi)] * hw.to(s.device)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of all of x, the mean of the two middle values for an even
    count (`jnp.median`)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's subgradient +1 at x = 0 (`torch.abs` takes 0 there):
    the median pixel of an odd-sized depth map sits exactly at 0."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(pred - gt))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR of [0, 1] images."""
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - l) L1 + l (1 - SSIM) of [H, W, 3] images."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - _ssim(pred, gt))


def masked_l1_loss(pred, gt, mask=None, normalize: bool = True, quantile: float = 1.0, valid=None):
    """Quantile-trimmed masked L1 of [B, D] rows: rows whose mean |err| is
    above the `quantile` of the valid rows get weight 0; mask [B, 1]
    weights; valid [B] bool marks real rows."""
    err = torch.mean(_abs(pred - gt), dim=-1, keepdim=True)
    if mask is None:
        mask = torch.ones_like(err)
    if valid is not None:
        mask = mask * valid[:, None].to(err.dtype)
    if quantile < 1.0:
        if valid is not None:
            big = torch.max(torch.where(valid[:, None], err, float("-inf")))
            err_for_q = torch.where(valid[:, None], err, big)
        else:
            err_for_q = err
        q = _quantile(err_for_q.detach(), quantile)
        mask = mask * (err <= q).to(err.dtype)
    if normalize:
        return torch.sum(err * mask) / (torch.sum(mask) + 1e-8)
    return torch.mean(err * mask)


def depth_loss_dpt(pred_depth: torch.Tensor, gt_depth: torch.Tensor, weight=None) -> torch.Tensor:
    """Median/MAD-normalised MSE. The prediction's median carries no
    gradient (the JAX package's stop-gradient, PARITY.md #8)."""
    t_pred = _median(pred_depth.detach())
    s_pred = torch.mean(_abs(pred_depth - t_pred))
    t_gt = _median(gt_depth)
    s_gt = torch.mean(_abs(gt_depth - t_gt))
    pn = (pred_depth - t_pred) / torch.clamp_min(s_pred, 1e-8)
    gn = (gt_depth - t_gt) / torch.clamp_min(s_gt, 1e-8)
    if weight is not None:
        return torch.sum((pn - gn) ** 2 * weight) / (torch.sum(weight) + 1e-8)
    return torch.mean((pn - gn) ** 2)


def denormalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[-1, 1] normalised -> pixel coordinates: (coords + 1) * 0.5 * (w, h)."""
    wh = torch.tensor([w, h], dtype=coords.dtype, device=coords.device)
    return (coords + 1.0) * 0.5 * wh


def parse_tapir_track_info(occlusions: torch.Tensor, expected_dist: torch.Tensor):
    """TAPIR logits -> (visible, invisible, confidence)."""
    conf = (1.0 - torch.sigmoid(occlusions)) * (1.0 - torch.sigmoid(expected_dist))
    return conf > 0.5, torch.sigmoid(occlusions) > 0.5, conf


def tracking_loss(predicted_track_map, query_pixels, gt_tracks_2d, target_visibles,
                  target_confidences, frame_interval, num_frames: int, h: int, w: int,
                  quantile: float = 0.98) -> torch.Tensor:
    """Long-range 2D tracking loss: the rendered `track_gs` map read at the
    integer query pixels against the TAPIR targets, weighted by confidence
    and exp(-2 |t2 - t1| / T), trimmed at `quantile`, over max(h, w)."""
    pred_2d = denormalize_coords(predicted_track_map[..., :2], h, w)
    qx = query_pixels[:, 0].to(torch.int64)
    qy = query_pixels[:, 1].to(torch.int64)
    pred_at_query = pred_2d[qy, qx]
    w_interval = torch.exp(-2.0 * torch.as_tensor(frame_interval, dtype=torch.float32) / num_frames)
    track_weights = target_confidences[:, None] * w_interval.to(pred_2d.device)
    return masked_l1_loss(
        pred_at_query, gt_tracks_2d, mask=track_weights, quantile=quantile, valid=target_visibles
    ) / max(h, w)


def arap_connectivity(points, k: int = 5, radius: float = 0.1, least_edge_num: int = 3,
                      query_idx=None, alive=None):
    """kNN connectivity of the query points with adaptive weights:
    (nn_idx [S,k], weight [S,k], edge_valid [S,k]). Only the [S, N] slice
    of distances is formed; dead slots sit at +inf. Edges past
    `least_edge_num` are cut when farther than `radius`. Weights are
    exp(-d / mean(d)) over the finite distances (the finite pre-mask mean),
    zeroed on cut edges and normalised per row."""
    q = points if query_idx is None else points[query_idx]
    d2 = _pairwise_sq_dists(q, points)
    if alive is not None:
        d2 = torch.where(alive[None, :], d2, float("inf"))
    neg, idx = torch.topk(-d2, k + 1, dim=1)
    nn_d, nn_i = -neg[:, 1:], idx[:, 1:]   # drop self, the distance-0 top hit
    cut = torch.arange(k, device=points.device)[None, :] >= least_edge_num
    valid = torch.where(cut, nn_d < radius**2, True)
    nn_d = torch.where(torch.isfinite(nn_d), nn_d, 0.0)
    w = torch.exp(-nn_d / torch.clamp_min(torch.mean(nn_d), 1e-12))
    w = torch.where(valid, w, 0.0)
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)
    return nn_i, w, valid


def _edge_matrix(verts, nn_idx, valid):
    """E[i, n] = p_i - p_nn_idx[i, n], zero where the edge is cut."""
    e = verts[:, None, :] - verts[nn_idx]
    return torch.where(valid[..., None], e, 0.0)


def estimate_rotation(src_edges, tgt_edges, weight) -> torch.Tensor:
    """Weighted Kabsch rotation per point by SVD: R = V U^T of
    S = sum_k w_k src_k tgt_k^T. Unchanged edge sets get S = 0; a 1e-8
    ridge keeps S regular. On a reflection (det R <= 0) the column of U
    of the smallest singular value flips; a non-finite R becomes I. R does
    not depend on the SVD's sign conventions, and the flipped column is the
    same in both packages while the smallest singular value is simple."""
    eye = torch.eye(3, dtype=src_edges.dtype, device=src_edges.device)
    S = torch.einsum("nka,nk,nkb->nab", src_edges, weight, tgt_edges)
    unchanged = torch.all(torch.all(src_edges == tgt_edges, dim=2), dim=1)
    S = torch.where(unchanged[:, None, None], 0.0, S)
    S = S + 1e-8 * eye
    U, sig, Vt = torch.linalg.svd(S)
    Wm = Vt.transpose(-1, -2)
    R = Wm @ U.transpose(-1, -2)
    det = torch.linalg.det(R)
    flip_col = torch.argmin(sig, dim=-1)
    arange3 = torch.arange(3, device=S.device)[None, :]
    sign = torch.where(arange3 == flip_col[:, None],
                       torch.where(det[:, None] <= 0, -1.0, 1.0), 1.0)
    U_fixed = U * sign[:, None, :]
    R = torch.where((det <= 0)[:, None, None], Wm @ U_fixed.transpose(-1, -2), R)
    bad = ~torch.all(torch.isfinite(R).reshape(R.shape[0], -1), dim=1)
    return torch.where(bad[:, None, None], eye, R)


def arap_sample(N: int, sample_num: int, alive=None, key: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """ARAP sample indices drawn from `key` as the JAX package draws them:
    with replacement, uniform over the alive slots (`jax.random.choice`
    with p = alive / count), or over all N slots (`jax.random.randint`)
    without a mask."""
    S = min(sample_num, N)
    if alive is None:
        return to_device(prng.randint(key, (S,), 0, N), device)
    p = alive.to(torch.float32)
    return prng.choice(key, N, (S,), p / torch.clamp_min(p.sum(), 1.0))


def arap_loss(pos_t1, pos_t2, sample_idx=None, k: int = 5, sample_num: int = 512,
              alive=None, key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """As-rigid-as-possible error between two instants on a sample of
    points: per-point rotations (no gradient) from the kNN edges at t1 and
    t2, then the stretch of the rotated t1 edges against the t2 edges,
    weighted and halved (Nt = 2). `sample_idx` [S] is drawn with
    `arap_sample` from `key` when not given."""
    if sample_idx is None:
        sample_idx = arap_sample(pos_t1.shape[0], sample_num, alive, key, pos_t1.device)
    nn_idx, w, valid = arap_connectivity(pos_t1, k=k, query_idx=sample_idx, alive=alive)
    src = torch.where(valid[..., None], pos_t1[sample_idx][:, None, :] - pos_t1[nn_idx], 0.0)
    tgt = torch.where(valid[..., None], pos_t2[sample_idx][:, None, :] - pos_t2[nn_idx], 0.0)
    with torch.no_grad():
        R = estimate_rotation(src, tgt, w)
    rot_rigid = torch.einsum("nab,nkb->nka", R, src)
    stretch = torch.sum((tgt - rot_rigid) ** 2, dim=-1)
    return torch.sum(w * stretch) / 2.0
