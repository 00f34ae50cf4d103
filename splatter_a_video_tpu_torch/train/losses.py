"""The loss library (counterpart of `splatter_a_video_tpu/train/losses.py`):
the main path's photometric L1 + D-SSIM and PSNR, quantile-trimmed masked
L1 and TAPIR tracking loss, median-normalised depth loss and ARAP rigidity
energy; and the criteria that nothing on the main path calls (L2, the
trimmed / masked / robust criteria, depth range, distortion, flow
smoothness, patch-correlation and scale-shift-invariant depth, feature
smoothness, first-K entropy and blending, the weight ramp, GAN losses).

Quantiles and medians are computed as the JAX package computes them
(sort, then linear interpolation; the median averages the two middle
values), not with `torch.median`, which returns the lower one. ARAP's
sample indices come in as a tensor, or are drawn from a JAX-compatible
key (`prng`) as the JAX package draws them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import blocking_to, to_device
from ..ops.knn import smallest_k, sq_dists_fma
from ..ops.ssim import ssim as _ssim
from ..utils import spans as _spans
from . import prng


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of all of x, in float32 as `jnp.quantile`."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * float(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1.0 - hw
    return s[int(lo)] * blocking_to(lw, s.device) + s[int(hi)] * blocking_to(hw, s.device)


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


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


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


def trimmed_l1_loss(pred, gt, quantile: float = 0.9) -> torch.Tensor:
    """Mean of the per-row mean |err| over the rows at or below the
    `quantile` (`err <= q`, where `_trim_mask` keeps `err < q`)."""
    err = torch.mean(_abs(pred - gt), dim=-1)
    m = (err <= _quantile(err.detach(), quantile)).to(err.dtype)
    return torch.sum(err * m) / (torch.sum(m) + 1e-8)


def _trim_mask(per_row_err: torch.Tensor, quantile: float) -> torch.Tensor:
    """1 on the rows strictly below the `quantile` of `per_row_err`."""
    return (per_row_err < _quantile(per_row_err.detach(), quantile)).to(per_row_err.dtype)


def trimmed_mse_loss(pred, gt, mask=None, quantile: float = 0.9) -> torch.Tensor:
    """Mean per-row MSE over the rows below the `quantile`, weighted by
    `mask` [B] when given."""
    err = torch.mean((pred - gt) ** 2, dim=-1)
    keep = _trim_mask(err, quantile)
    w = keep if mask is None else keep * mask
    return torch.sum(err * w) / (torch.sum(w) + 1e-8)


def _trimmed_moments(x, keep, n, sqrt: bool):
    """Per-column variance (or std) of x over the kept rows, divided by
    max(n - 1, 1)."""
    mu = torch.sum(x * keep, dim=0) / n
    var = torch.sum(((x - mu) ** 2) * keep, dim=0) / torch.clamp_min(n - 1, 1.0)
    return torch.sqrt(var) if sqrt else var


def trimmed_std_normed_l1_loss(pred, gt, quantile: float = 0.9) -> torch.Tensor:
    """|err| over the mean of pred's and gt's per-column std on the rows
    below the `quantile`."""
    err = _abs(pred - gt)
    keep = _trim_mask(torch.mean(err, dim=-1), quantile)[:, None]
    n = torch.sum(keep) + 1e-8
    std = 0.5 * (_trimmed_moments(pred, keep, n, True) + _trimmed_moments(gt, keep, n, True))
    return torch.mean(err / (std + 1e-12))


def trimmed_var_normed_mse_loss(pred, gt, quantile: float = 0.9) -> torch.Tensor:
    """err^2 over the mean of pred's and gt's per-column variance on the
    rows below the `quantile`."""
    err = (pred - gt) ** 2
    keep = _trim_mask(torch.mean(err, dim=-1), quantile)[:, None]
    n = torch.sum(keep) + 1e-8
    var = 0.5 * (_trimmed_moments(pred, keep, n, False) + _trimmed_moments(gt, keep, n, False))
    return torch.mean(err / (var + 1e-12))


def depth_range_loss(depth: torch.Tensor, min_th: float = 0.0, max_th: float = 2.0) -> torch.Tensor:
    """Quadratic penalty outside [min_th, max_th], over the element count."""
    lower = torch.where(depth < min_th, (depth - min_th) ** 2, 0.0)
    upper = torch.where(depth > max_th, (depth - max_th) ** 2, 0.0)
    return (torch.sum(lower) + torch.sum(upper)) / depth.numel()


def distortion_loss(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 distortion, iint w_i w_j |t_i - t_j|: t [..., K+1]
    interval edges, w [..., K] weights."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = _abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return torch.mean(loss_inter + loss_intra)


def flow_smoothness_loss(flow: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Alpha-weighted total variation of a flow field [H, W, 2], alpha
    [H, W, 1]. Where two neighbours' flows are equal, `torch.linalg.norm`
    gives the gradient 0 (the reference `criterion.py`'s torch semantics),
    where `jnp.linalg.norm` gives NaN: the values agree everywhere, the
    gradients wherever no difference is exactly 0."""
    gx = torch.linalg.norm(flow[1:, :, :] - flow[:-1, :, :], dim=-1, keepdim=True)
    gy = torch.linalg.norm(flow[:, 1:, :] - flow[:, :-1, :], dim=-1, keepdim=True)
    cost = torch.sum(alpha[1:, :, :] * gx) + torch.sum(alpha[:, 1:, :] * gy)
    return cost / (2 * torch.sum(alpha) + 1e-6)


def normalize_minus_one_to_one(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0


def masked_mse_loss(pred, gt, mask=None, normalize: bool = True) -> torch.Tensor:
    """MSE weighted by `mask`; normalised by the mask's sum times the last
    dimension."""
    err = (pred - gt) ** 2
    if mask is None:
        return torch.mean(err)
    if normalize:
        return torch.sum(err * mask) / (err.shape[-1] * torch.sum(mask) + 1e-8)
    return torch.mean(err * mask)


def masked_huber_loss(pred, gt, delta: float, mask=None, normalize: bool = True) -> torch.Tensor:
    adiff = _abs(pred - gt)
    err = torch.where(adiff <= delta, 0.5 * adiff**2, delta * (adiff - 0.5 * delta))
    if mask is None:
        return torch.mean(err)
    if normalize:
        return torch.sum(err * mask) / (torch.sum(mask) + 1e-8)
    return torch.mean(err * mask)


def cauchy_loss(pred, gt, c: float = 1.0, mask=None, normalize: bool = True) -> torch.Tensor:
    err = torch.log(1.0 + ((pred - gt) / c) ** 2)
    if mask is None:
        return torch.mean(err)
    if normalize:
        return torch.mean(err * mask) / (torch.mean(mask) + 1e-8)
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


def depth_correlation_loss(gt_depth: torch.Tensor, rendered_depth: torch.Tensor, patch_size: int,
                           num_patches: int, key: torch.Tensor) -> torch.Tensor:
    """1 - the mean Pearson correlation of `num_patches` square patches,
    their corners drawn from `key` as the JAX package draws them (split,
    then randint). The std is the population one (`jnp.std`: ddof 0)."""
    H, W = gt_depth.shape[:2]
    gt = gt_depth.reshape(H, W)
    rd = rendered_depth.reshape(H, W)
    ki, kj = prng.split(key)
    ii = to_device(prng.randint(ki, (num_patches,), 0, H - patch_size), gt.device)
    jj = to_device(prng.randint(kj, (num_patches,), 0, W - patch_size), gt.device)
    off = torch.arange(patch_size, device=gt.device)
    rows, cols = (ii[:, None] + off)[:, :, None], (jj[:, None] + off)[:, None, :]
    gts = gt[rows, cols].reshape(num_patches, -1)
    rds = rd[rows, cols].reshape(num_patches, -1)
    pcc = torch.mean(rds * gts, dim=1) - torch.mean(rds, dim=1) * torch.mean(gts, dim=1)
    pcc = pcc / torch.clamp_min(torch.std(rds, dim=1, correction=0) * torch.std(gts, dim=1, correction=0), 1e-8)
    return 1.0 - torch.mean(pcc)


def scale_shift_invariant_depth_loss(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    """MSE after the least-squares scale and shift of `pred` onto `gt`
    (the MiDaS data term); scale 1, shift 0 when the system is singular."""
    if mask is None:
        mask = torch.ones_like(pred)
    a00 = torch.sum(mask * pred * pred)
    a01 = torch.sum(mask * pred)
    a11 = torch.sum(mask)
    b0 = torch.sum(mask * pred * gt)
    b1 = torch.sum(mask * gt)
    det = a00 * a11 - a01 * a01
    scale = torch.where(det > 0, (a11 * b0 - a01 * b1) / torch.clamp_min(det, 1e-12), 1.0)
    shift = torch.where(det > 0, (-a01 * b0 + a00 * b1) / torch.clamp_min(det, 1e-12), 0.0)
    aligned = scale * pred + shift
    return torch.sum(mask * (aligned - gt) ** 2) / (torch.sum(mask) + 1e-8)


def denormalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[-1, 1] normalised -> pixel coordinates: (coords + 1) * 0.5 * (w, h)."""
    wh = blocking_to([w, h], coords.device, coords.dtype)
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
    track_weights = target_confidences[:, None] * blocking_to(w_interval, pred_2d.device)
    return masked_l1_loss(
        pred_at_query, gt_tracks_2d, mask=track_weights, quantile=quantile, valid=target_visibles
    ) / max(h, w)


def arap_connectivity(points, k: int = 5, radius: float = 0.1, least_edge_num: int = 3,
                      query_idx=None, alive=None):
    """kNN connectivity of the query points with adaptive weights:
    (nn_idx [S,k], weight [S,k], edge_valid [S,k]). Only the [S, N] slice
    of distances is formed, without a gradient; dead slots sit at +inf. Edges past
    `least_edge_num` are cut when farther than `radius`. Weights are
    exp(-d / mean(d)) over the finite distances (the finite pre-mask mean),
    zeroed on cut edges and normalised per row."""
    q = points if query_idx is None else points[query_idx]
    with torch.no_grad():   # the same distance bits and order on every device: the same neighbours
        d2 = sq_dists_fma(q[:, None, :], points[None, :, :])
        if alive is not None:
            d2 = torch.where(alive[None, :], d2, float("inf"))
        nn_i = smallest_k(d2, k + 1)[:, 1:]   # drop self, the distance-0 top hit
    # the chosen distances again, with their gradient: the same bits as in d2
    nn_d = sq_dists_fma(q[:, None, :], points[nn_i])
    if alive is not None:
        nn_d = torch.where(alive[nn_i], nn_d, float("inf"))
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
    _spans.count("sync", 2)   # on the card, torch.linalg.svd reads its result's checks to the host twice
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


def smoothness_loss(features: torch.Tensor, key: torch.Tensor, positions=None, k: int = 10,
                    sample_num: int = 512, alive=None) -> torch.Tensor:
    """Neighbourhood feature smoothness: the sum of |w * (f_i - f_nn)| over
    the kNN edges of `sample_num` points drawn from `key` (`arap_sample`:
    over the alive slots when `alive` is given). `positions` drive the
    connectivity; without them the features do."""
    pos = features if positions is None else positions
    sample_idx = arap_sample(pos.shape[0], sample_num, alive, key, pos.device)
    nn_idx, w, valid = arap_connectivity(pos, k=k, query_idx=sample_idx, alive=alive)
    edges = torch.where(valid[..., None], features[sample_idx][:, None, :] - features[nn_idx], 0.0)
    return torch.sum(_abs(w[..., None] * edges))


def _first_k_rows(table: torch.Tensor, fill, gs_idx: torch.Tensor) -> torch.Tensor:
    """table[gs_idx] with the id -1 reading an appended row of `fill`."""
    ext = torch.cat([table, torch.full((1,) + tuple(table.shape[1:]), fill, dtype=table.dtype,
                                       device=table.device)])
    return ext[torch.where(gs_idx >= 0, gs_idx, table.shape[0]).long()]


def entropy_loss(opacity: torch.Tensor, gs_idx: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel entropy of the first-K opacities [N] at `gs_idx`
    [..., K], normalised per pixel; an id of -1 reads opacity 1."""
    po = _first_k_rows(opacity, 1.0, gs_idx)
    po = po / (torch.sum(po, dim=-1, keepdim=True) + 1e-8)
    ent = -torch.sum(po * torch.log(torch.maximum(po, po.new_tensor(1e-12))), dim=-1)
    return torch.mean(ent)


def alpha_blending_firstK(attribute: torch.Tensor, gs_idx: torch.Tensor, pixel_weight: torch.Tensor,
                          bg: float = 1.0) -> torch.Tensor:
    """The first-K blend from recorded ids: attribute [N, D], gs_idx
    [..., K], pixel_weight [..., K] -> [..., D]; an id of -1 reads `bg`."""
    vals = _first_k_rows(attribute, bg, gs_idx)
    return torch.sum(vals * pixel_weight[..., None], dim=-2)


def weight_scheduler(step, start_step: int, w: float, min_weight: float, max_weight: float) -> torch.Tensor:
    """0 up to `start_step`, then w per step after it, clipped to
    [min_weight, max_weight]."""
    step = torch.as_tensor(step)
    weight = torch.where(step <= start_step, 0.0, w * (step - start_step))
    return torch.clamp(weight, min_weight, max_weight)


def gan_loss(logits, target_is_real: bool, gan_mode: str = "hinge", for_discriminator: bool = True,
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """GAN objective over discriminator logits: 'original' (sigmoid BCE),
    'ls' (MSE to the label), 'hinge' or 'w' (WGAN). A (multiscale) list,
    whose items may be lists ending in the prediction, averages the
    per-scale means."""
    if isinstance(logits, (list, tuple)):
        per = [torch.mean(gan_loss(p[-1] if isinstance(p, (list, tuple)) else p, target_is_real, gan_mode,
                                   for_discriminator, real_label, fake_label)) for p in logits]
        return sum(per) / len(per)
    x = logits
    zero = x.new_zeros(())
    if gan_mode == "original":
        t = real_label if target_is_real else fake_label
        # binary_cross_entropy_with_logits, mean-reduced, in JAX's form
        return torch.mean(torch.maximum(x, zero) - x * t + torch.log1p(torch.exp(-_abs(x))))
    if gan_mode == "ls":
        t = real_label if target_is_real else fake_label
        return torch.mean((x - t) ** 2)
    if gan_mode == "hinge":
        if for_discriminator:
            return -torch.mean(torch.minimum((x - 1.0) if target_is_real else (-x - 1.0), zero))
        if not target_is_real:
            raise AssertionError("generator hinge loss must aim for real")
        return -torch.mean(x)
    if gan_mode == "w":
        return -torch.mean(x) if target_is_real else torch.mean(x)
    raise ValueError(f"Unexpected gan_mode {gan_mode}")
