"""The reference's initial scene, worked out from the benchmark's clip.

What the program's set-up derives from the clip before its first step, done
again in plain PyTorch (and NumPy for the draws and two quantiles), from the
semantics the program states:

  * the lifting: per query frame, a sample of its track rows drawn from
    `RandomState(seed)` (foreground rows first, then background), each track
    lifted to (x, y) in [-1, 1] by half the frame size and the depth
    renormalised over the clip to [0.5, 2], sampled bilinearly; a track is
    kept where its query point lies in the eroded mask of its side, and it is
    visible and confident in at least min(int(0.9 T), the 0.9 quantile)
    frames (0.99 for the background); the background is extended by two
    border grids that follow the mean background motion; random pixels of
    random frames top it up to the configured number of points;
  * the scale: log sqrt of the mean squared distance to the 3 nearest other
    points, exactly (float64 differences), by a blocked search over
    Morton-ordered chunks;
  * the trajectories: a not-a-knot cubic spline through the frame-0 offsets
    at the knot frames (a linear solve in float64), or zero motion
    coefficients;
  * identity rotations, the configured opacity, DC colour from the sampled
    RGB, zero SH rest and attributes, dead slots parked at z = -10.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

SH_C0 = 0.28209479177387814
POLY_DIM, FOURIER_DIM, FRAMES_PER_KNOT = 4, 8, 5
MOTION = ("pos_poly_feat", "pos_fourier_feat", "rot_poly_feat", "rot_fourier_feat")
DEAD_Z, DEAD_LOG_SCALE = -10.0, math.log(1e-3)
EROSION = 2                         # the square that erodes each side of the mask (as the clip is handed over)
KNN_CELLS = 1 << 24                 # query-candidate pairs a block of the kNN forms at once


def _f32(x: float, dev) -> torch.Tensor:
    """A float32 scalar on the device: divisions by it round as one IEEE
    division (a host scalar divides by its reciprocal on the card)."""
    return torch.tensor(x, dtype=torch.float32, device=dev)


class Frames:
    """The clip's per-frame images on the device, and its bilinear samples:
    border-clamped, weights in float64, corners summed in a fixed order."""

    def __init__(self, clip, dev):
        self.dev = dev
        self.rgb = _upload(clip.frames, dev)                                # [T, H, W, 3]
        raw = _upload(clip.depths, dev)                                     # [T, H, W]
        lo, hi = float(raw.min()), float(raw.max())
        span = hi - lo
        if span > 0:
            self.depth = (raw - lo) / _f32(span, dev) * _f32(1.5, dev) + _f32(0.5, dev)
        else:
            self.depth = torch.full_like(raw, 0.5)
        fg = _upload(clip.masks, dev)
        self.side = torch.zeros(fg.shape, dtype=torch.float32, device=dev)  # +1 fg / -1 bg / 0 boundary, eroded
        self.side[_erode(~fg, EROSION)] = -1.0
        self.side[_erode(fg, EROSION)] = 1.0
        self.T, self.H, self.W = raw.shape

    def sample(self, img: torch.Tensor, f: torch.Tensor, xy: torch.Tensor, nearest: bool = False) -> torch.Tensor:
        """img [T, H, W(, C)] at frames f [n] and pixels xy [n, 2] (float32):
        [n(, C)] in float64."""
        squeeze = img.dim() == 3
        if squeeze:
            img = img[..., None]
        x = xy[:, 0].clamp(0.0, self.W - 1.0)
        y = xy[:, 1].clamp(0.0, self.H - 1.0)
        if nearest:                  # the planted fault: the nearest pixel, not a bilinear sample
            out = img[f, y.round().long(), x.round().long()].double()
            return out[:, 0] if squeeze else out
        x0, y0 = x.floor().long(), y.floor().long()
        x1, y1 = (x0 + 1).clamp_max(self.W - 1), (y0 + 1).clamp_max(self.H - 1)
        wx = (x.double() - x0.double())[:, None]
        wy = (y.double() - y0.double())[:, None]
        a, b = img[f, y0, x0].double(), img[f, y0, x1].double()
        c, d = img[f, y1, x0].double(), img[f, y1, x1].double()
        out = a * (1 - wx) * (1 - wy) + b * wx * (1 - wy) + c * (1 - wx) * wy + d * wx * wy
        return out[:, 0] if squeeze else out

    def normalise(self, xy: torch.Tensor) -> torch.Tensor:
        """Pixels -> [-1, 1] by half the frame size (float32)."""
        half = torch.tensor([self.W, self.H], dtype=torch.float32, device=self.dev) / 2.0
        return (xy - half) / half


def _upload(arrays, dev) -> torch.Tensor:
    """The frames' arrays as one [T, ...] tensor on the device, a frame at a time."""
    out = torch.empty((len(arrays),) + arrays[0].shape, dtype=torch.from_numpy(arrays[0]).dtype, device=dev)
    for t, a in enumerate(arrays):
        out[t].copy_(torch.from_numpy(a))
    return out


def _erode(m: torch.Tensor, r: int) -> torch.Tensor:
    """Binary erosion of [T, H, W] by an r x r square centred at (r // 2,
    r // 2), with everything outside the frame false."""
    T, H, W = m.shape
    pad = torch.zeros((T, H + r, W + r), dtype=torch.bool, device=m.device)
    o = r // 2
    pad[:, o:o + H, o:o + W] = m
    out = torch.ones_like(m)
    for i in range(r):
        for j in range(r):
            out &= pad[:, i:i + H, j:j + W]
    return out


def _quantile_floor(counts: torch.Tensor, q: float, T: int) -> float:
    """min(int(q T), the q quantile of the counts (linear, as NumPy's))."""
    c = counts.cpu().numpy().astype(np.float32)
    return min(int(q * T), float(np.quantile(c, q)))


def _lift(fr: Frames, tracks: torch.Tensor, q: int, fg: bool, nearest: bool):
    """The kept tracks of query frame q: ([n, T, 3] float64, colours [n, 3])."""
    T = fr.T
    n = tracks.shape[0]
    xy = tracks[..., :2].transpose(0, 1).contiguous()                      # [T, n, 2]
    occ, dist = tracks[..., 2].t(), tracks[..., 3].t()
    vis = 1.0 - torch.sigmoid(occ)
    conf = 1.0 - torch.sigmoid(dist)
    valid_vis, valid_inv = vis * conf > 0.5, (1.0 - vis) * conf > 0.5
    conf = conf * (valid_vis | valid_inv).float()
    f = torch.arange(T, device=fr.dev).repeat_interleave(n)
    flat = xy.reshape(-1, 2)
    depth = fr.sample(fr.depth, f, flat, nearest).reshape(T, n)
    side = (fr.side == (1.0 if fg else -1.0)).float()
    in_mask = (fr.sample(side, f, flat) == 1.0).reshape(T, n)
    valid_vis &= in_mask
    conf = conf * in_mask
    thresh = 0.9 if fg else 0.99
    vc = valid_vis.sum(0)
    cc = (conf > 0.5).sum(0)
    keep = in_mask[q] & (vc >= _quantile_floor(vc, thresh, T)) & (cc >= _quantile_floor(cc, thresh, T))
    pts = torch.cat([fr.normalise(flat).reshape(T, n, 2).double(), depth[..., None]], -1)   # [T, n, 3]
    col = fr.sample(fr.rgb, torch.full((n,), q, device=fr.dev), xy[q])
    return pts[:, keep].transpose(0, 1), col[keep]


def _sample_side(clip, fr: Frames, rng: np.random.RandomState, num: int, fg: bool, nearest: bool):
    T = fr.T
    per_q = int(np.ceil(num / T))
    pts, cols, cur = [], [], 0
    for q in range(T):
        n_tr = clip.tracks[(q, q)].shape[0]
        nsel = int(min(per_q, num - cur, n_tr))
        if nsel <= 0:
            break
        rows = rng.choice(n_tr, nsel, replace=False) if nsel < n_tr else slice(None)
        tr = torch.from_numpy(np.stack([clip.tracks[(q, t)][rows] for t in range(T)], 1)).to(fr.dev)
        cur += tr.shape[0]
        p, c = _lift(fr, tr, q, fg, nearest)
        pts.append(p)
        cols.append(c)
    return torch.cat(pts), torch.cat(cols)


def _border(fr: Frames, bg: torch.Tensor, margin: float, nearest: bool):
    """The left (frame 0) and right (last frame) border grids, moved by the
    background tracks' mean offset from that frame."""
    W, H, T = fr.W, fr.H, fr.T
    grid = int(64 / (margin / 0.25))
    pts, cols = [], []
    for left in (True, False):
        f = 0 if left else T - 1
        if left:
            xs = np.linspace(0, int((W - 1) * margin), W // grid)
        else:
            xs = np.linspace(int((W - 1) * (1 - margin)), W - 1, W // grid)
        ys = np.linspace(0, H - 1, H // int(grid * margin))
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        px = torch.from_numpy(np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)).to(fr.dev)
        fi = torch.full((px.shape[0],), f, device=fr.dev)
        depth = fr.sample(fr.depth, fi, px, nearest)
        col = fr.sample(fr.rgb, fi, px)
        ok = fr.sample(fr.side, fi, px) != 1.0
        p3 = torch.cat([fr.normalise(px)[ok].double(), depth[ok][:, None]], -1)
        delta = (bg - bg[:, f:f + 1]).mean(0, keepdim=True)                # [1, T, 3]
        pts.append(p3[:, None] + delta)
        cols.append(col[ok])
    return torch.cat(pts), torch.cat(cols)


def lift(clip, cfg: dict, seed: int, device, nearest: bool = False):
    """The lifted tracks [N, T, 3] (float64) and colours [N, 3] (float32)."""
    dev = torch.device(device)
    fr = Frames(clip, dev)
    rng = np.random.RandomState(seed)
    fg, fg_c = _sample_side(clip, fr, rng, cfg["num_fg_samples"], True, nearest)
    bg, bg_c = _sample_side(clip, fr, rng, cfg["num_bg_samples"], False, nearest)
    ext, ext_c = _border(fr, bg, cfg["recipe"]["fit"]["video_flow_margin"], nearest)
    tracks, cols = torch.cat([fg, bg, ext]), torch.cat([fg_c, bg_c, ext_c])
    ok = ~torch.isnan(tracks).any(2).any(1)
    tracks, cols = tracks[ok], cols[ok]
    need = cfg["alive_at_start"] - tracks.shape[0]
    if need > 0:
        fs = rng.randint(0, fr.T, size=need)
        xy = np.stack([rng.uniform(0, fr.W - 1, need), rng.uniform(0, fr.H - 1, need)], 1).astype(np.float32)
        fi, xy = torch.from_numpy(fs).to(dev), torch.from_numpy(xy).to(dev)
        p = torch.cat([fr.normalise(xy), fr.sample(fr.depth, fi, xy, nearest).float()[:, None]], 1)
        tracks = torch.cat([tracks, p.double()[:, None].expand(-1, fr.T, -1)])
        cols = torch.cat([cols, fr.sample(fr.rgb, fi, xy).float().double()])
    del fr
    return tracks, cols.float()


def _morton(q: torch.Tensor) -> torch.Tensor:
    """Interleave the 10 low bits of each of q's three integer columns."""
    code = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def mean_knn3_sq_dist(pos: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """[N] float64: the mean squared distance of each point to its 3 nearest
    other points (duplicates count), exact. The points go in Morton order; a
    chunk's 3rd-nearest distance among its own points bounds every query's,
    so the true neighbours lie in the chunk's box grown by it."""
    p = pos.double()
    N = p.shape[0]
    if N < 4:
        raise ValueError("the scale needs 4 points or more")
    lo, hi = p.min(0).values, p.max(0).values
    q = ((p - lo) / (hi - lo).clamp_min(1e-30) * 1023).long().clamp(0, 1023)
    order = torch.argsort(_morton(q))
    ps = p[order]
    out = torch.empty(N, dtype=torch.float64, device=p.device)
    for s in range(0, N, chunk):
        Q = ps[s:s + chunk]
        if Q.shape[0] < 4:                     # a short last chunk: take the one before it along
            Q = ps[max(s - chunk, 0):s + chunk]
        r = ((Q[:, None] - Q[None]) ** 2).sum(-1).topk(4, 1, largest=False).values[:, 3].max().sqrt()
        box = ((ps >= Q.min(0).values - r) & (ps <= Q.max(0).values + r)).all(1)
        C = ps[box]
        rows = max(1, KNN_CELLS // C.shape[0])
        for a in range(0, ps[s:s + chunk].shape[0], rows):
            qa = ps[s + a:s + min(a + rows, chunk)]
            v = ((qa[:, None] - C[None]) ** 2).sum(-1).topk(4, 1, largest=False).values
            out[order[s + a:s + a + qa.shape[0]]] = v[:, 1:4].sum(1) / 3.0
    return out


def spline_knots(T: int) -> np.ndarray:
    m = -(-T // FRAMES_PER_KNOT)
    idx = np.linspace(0, T - 1, m + 1).astype(np.int64)
    return (idx / (T - 1)).astype(np.float32)


def not_a_knot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cubic spline coefficients [4, n - 1, ...] (coefficient k of interval i
    multiplies (t - x_i)^(3 - k)) through (x [n], y [n, ...]), not-a-knot at
    both ends (a parabola for n = 3), in float64."""
    x, y = x.double(), y.double()
    n = x.shape[0]
    h = x[1:] - x[:-1]
    flat = y.reshape(n, -1)
    slope = (flat[1:] - flat[:-1]) / h[:, None]
    A = torch.zeros((n, n), dtype=torch.float64, device=y.device)
    rhs = torch.zeros_like(flat)
    for i in range(1, n - 1):            # continuity of the slope: in second derivatives s
        A[i, i - 1], A[i, i], A[i, i + 1] = h[i - 1], 2 * (h[i - 1] + h[i]), h[i]
        rhs[i] = 6 * (slope[i] - slope[i - 1])
    if n == 3:                           # one parabola: s constant
        A[0, 0], A[0, 1] = 1.0, -1.0
        A[2, 1], A[2, 2] = 1.0, -1.0
    else:                                # the third derivative continuous at x_1 and x_{n-2}
        A[0, 0], A[0, 1], A[0, 2] = h[1], -(h[0] + h[1]), h[0]
        A[n - 1, n - 3], A[n - 1, n - 2], A[n - 1, n - 1] = h[n - 2], -(h[n - 3] + h[n - 2]), h[n - 3]
    s = torch.linalg.solve(A, rhs)
    hh = h[:, None]
    c = torch.stack([(s[1:] - s[:-1]) / (6 * hh), s[:-1] / 2,
                     slope - hh * (2 * s[:-1] + s[1:]) / 6, flat[:-1]])
    return c.reshape((4, n - 1) + tuple(y.shape[1:]))


def initial_scene(clip, cfg: dict, seed: int, device, nearest: bool = False) -> Dict[str, object]:
    """{"params": {name: tensor [capacity, ...]}, "alive": bool [capacity],
    "knots": float32 [M + 1] or None}, on `device`. `nearest` plants a fault:
    every depth sampled at the nearest pixel."""
    dev = torch.device(device)
    fc = cfg["recipe"]["fit"]
    tracks, cols = lift(clip, cfg, seed, dev, nearest)
    N, T = tracks.shape[0], tracks.shape[1]
    cap = int(np.ceil(N * cfg["capacity_factor"] / 128) * 128)
    seq = tracks.float()                                                    # [N, T, 3]
    f32 = dict(dtype=torch.float32, device=dev)

    def full(shape, v=0.0):
        return torch.full((cap,) + tuple(shape), v, **f32)

    pos = full((3,))
    pos[:N] = seq[:, 0]
    pos[N:, 2] = DEAD_Z
    d2 = mean_knn3_sq_dist(seq[:, 0])
    scaling = full((3,), DEAD_LOG_SCALE)
    scaling[:N] = torch.log(torch.sqrt(d2.clamp_min(1e-7)))[:, None].float()
    rotation = full((4,))
    rotation[:, 0] = 1.0
    o = fc["init_opacity"]
    fdc = full((1, 3))
    fdc[:N, 0] = (cols - 0.5) / SH_C0
    params = {"position": pos, "features_dc": fdc, "features_rest": full((15, 3)), "scaling": scaling,
              "rotation": rotation, "opacity": full((1,), math.log(o / (1.0 - o)))}
    if cfg["traj"] != "static":
        params.update(pos_poly_feat=full((POLY_DIM, 3)), pos_fourier_feat=full((FOURIER_DIM, 3)),
                      rot_poly_feat=full((POLY_DIM, 4)), rot_fourier_feat=full((FOURIER_DIM, 4)))
    for name, dim in fc["render_attributes"].items():
        if name not in MOTION:
            params[name] = full((int(dim),))
    knots: Optional[torch.Tensor] = None
    if cfg["traj"] == "cubic_spline":
        kn = spline_knots(T)
        idx = np.linspace(0, T - 1, len(kn)).astype(np.int64)
        delta = seq[:, idx] - seq[:, :1]                                    # [N, M + 1, 3]
        c = not_a_knot(torch.from_numpy(kn).to(dev), delta.transpose(0, 1))  # [4, M, N, 3]
        coeff = full((4, len(kn) - 1, 3))
        coeff[:N] = c.permute(2, 0, 1, 3).float()
        params["pos_cubic_coeff"] = coeff
        knots = torch.from_numpy(kn).to(dev)
    alive = torch.arange(cap, device=dev) < N
    return {"params": params, "alive": alive, "knots": knots}
