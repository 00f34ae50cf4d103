"""Plain PyTorch reference of the program's train step and density event.

Written from the semantics the program states (the reference repository's
training recipe as the port documents it), in float32 with TF32 off unless a
caller turns it on for the control. It imports nothing of the program:

  * trajectories: cubic splines over knots, or polynomial + Fourier bases;
  * orthographic projection, SH colours (degree 3, +z view direction),
    3D covariances, EWA footprints with the tight 3-sigma tile rect;
  * binning: every (Gaussian, tile) pair of the rect in row-major order, at
    most `max_tiles` a Gaussian and `max_intersections` in all, ordered per
    tile by depth, then Gaussian index;
  * the blend: front to back per pixel, alpha = min(0.99, o exp(power)),
    skipped below 1/255 or at power > 0, stopped before the Gaussian that
    would take the transmittance under 1e-4; extra channels blend with the
    opacity's gradient cut. It runs densely per tile, a chunk of tiles at a
    time, and its backward recomputes each chunk (so it fits at 2160p);
  * L1 + D-SSIM, the trimmed tracking loss, the median / MAD depth loss,
    ARAP on sampled points, the attribute losses; Adam with one shared
    count, per-attribute rates and log-linear schedules;
  * density control: clone, split, prune into a fixed capacity.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import prng

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


# --------------------------------------------------------------------------
# scene
# --------------------------------------------------------------------------

def _tnorm(t: int, T: int, dev) -> torch.Tensor:
    return torch.tensor(float(t), dtype=torch.float32, device=dev) / max(T - 1, 1)


def _poly_fourier(poly_feat, fourier_feat, tn):
    k = torch.arange(poly_feat.shape[1], dtype=torch.float32, device=tn.device)
    poly = torch.pow(tn, k)
    l = torch.arange(fourier_feat.shape[1] // 2, dtype=torch.float32, device=tn.device) + 1.0
    four = torch.cat([torch.cos(tn * l * math.pi), torch.sin(tn * l * math.pi)])
    return torch.einsum("npc,p->nc", poly_feat, poly) + torch.einsum("nfc,f->nc", fourier_feat, four)


def position(p: Dict[str, torch.Tensor], knots, traj: str, t: int, T: int) -> torch.Tensor:
    tn = _tnorm(t, T, p["position"].device)
    if traj == "cubic_spline":
        coeff = p["pos_cubic_coeff"]                 # [N, 4, M, 3], scipy's layout
        i = torch.searchsorted(knots, (tn - 1e-7).reshape(1)) - 1
        i = i.clamp(0, coeff.shape[2] - 1)
        d = tn - knots[i][0]
        c = coeff[:, :, int(i)]                      # [N, 4, 3]
        return p["position"] + (((c[:, 0] * d + c[:, 1]) * d + c[:, 2]) * d + c[:, 3])
    return p["position"] + _poly_fourier(p["pos_poly_feat"], p["pos_fourier_feat"], tn)


def rotation(p, t: int, T: int) -> torch.Tensor:
    tn = _tnorm(t, T, p["rotation"].device)
    return p["rotation"] + _poly_fourier(p["rot_poly_feat"], p["rot_fourier_feat"], tn).detach()


def sh_colour(shs: torch.Tensor) -> torch.Tensor:
    """ReLU(SH basis at the +z direction + 0.5), degree 3, [N, 16, 3] -> [N, 3]."""
    N = shs.shape[0]
    d = torch.cat([shs.new_zeros((N, 2)), shs.new_ones((N, 1))], 1)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = SH_C0 * shs[:, 0]
    r = r - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] - SH_C1 * x * shs[:, 3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    r = (r + SH_C2[0] * xy * shs[:, 4] + SH_C2[1] * yz * shs[:, 5] + SH_C2[2] * (2.0 * zz - xx - yy) * shs[:, 6]
         + SH_C2[3] * xz * shs[:, 7] + SH_C2[4] * (xx - yy) * shs[:, 8])
    r = (r + SH_C3[0] * y * (3.0 * xx - yy) * shs[:, 9] + SH_C3[1] * xy * z * shs[:, 10]
         + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[:, 11] + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[:, 12]
         + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[:, 13] + SH_C3[5] * z * (xx - yy) * shs[:, 14]
         + SH_C3[6] * x * (xx - 3.0 * yy) * shs[:, 15])
    b = r + 0.5
    return torch.maximum(b, b.new_zeros(()))


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def cov3d(scaling: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T as its upper triangle [N, 6]."""
    Rm = quat_rotmat(rot)
    v = scaling * scaling
    r = lambda i, j: Rm[:, i, j]
    e = lambda a, b: r(a, 0) * r(b, 0) * v[:, 0] + r(a, 1) * r(b, 1) * v[:, 1] + r(a, 2) * r(b, 2) * v[:, 2]
    return torch.stack([e(0, 0), e(0, 1), e(0, 2), e(1, 1), e(1, 2), e(2, 2)], -1)


def project(pos, rot, scaling, opacity, extr, W: int, H: int, nearest: float, extent: float,
            block: int, max_tiles: int) -> SimpleNamespace:
    """Orthographic projection and EWA footprint (the training render's
    tight 3-sigma rect, without opacity)."""
    R, tr = extr[:, :3], extr[:, 3]
    pc = pos @ R.T + tr
    wh = torch.tensor([W, H], dtype=torch.float32, device=pos.device)
    uv = (pc[:, :2] + 1.0) * wh * 0.5 - 0.5
    depth = torch.nan_to_num(pc[:, 2])
    culled = (depth <= nearest) | torch.any((uv < (1.0 - extent) * wh * 0.5) | (uv > (1.0 + extent) * wh * 0.5), -1)
    uv = torch.where(culled[:, None], 0.0, uv)
    depth = torch.where(culled, 0.0, depth)
    visible = depth != 0
    cov = cov3d(scaling, rot) * visible[:, None].to(torch.float32)
    t0, t1 = (W / 2.0) * R[0], (H / 2.0) * R[1]

    def quad(u, v):
        return (u[0] * v[0] * cov[:, 0] + (u[0] * v[1] + u[1] * v[0]) * cov[:, 1]
                + (u[0] * v[2] + u[2] * v[0]) * cov[:, 2] + u[1] * v[1] * cov[:, 3]
                + (u[1] * v[2] + u[2] * v[1]) * cov[:, 4] + u[2] * v[2] * cov[:, 5])

    a, b, c = quad(t0, t0) + 0.3, quad(t0, t1), quad(t1, t1) + 0.3
    det = a * c - b * b
    det_ok = det != 0.0
    ds = torch.where(det_ok, det, 1.0)
    conic = torch.stack([c / ds, -b / ds, a / ds], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    max_r = max((int(max(max_tiles, 9) ** 0.5) - 2) * block / 2.0, float(block))
    radius = torch.clamp_max(torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0))), max_r)
    with torch.no_grad():
        rx = torch.clamp_max(torch.ceil(3.0 * torch.sqrt(torch.clamp_min(a, 0.0))), max_r)
        ry = torch.clamp_max(torch.ceil(3.0 * torch.sqrt(torch.clamp_min(c, 0.0))), max_r)
        r2 = torch.stack([rx, ry], -1)
        tg = torch.tensor([-(-W // block), -(-H // block)], dtype=torch.int32, device=pos.device)
        tmin = torch.clamp(torch.floor((uv - r2) / block).to(torch.int32), torch.zeros_like(tg), tg)
        tmax = torch.clamp(torch.floor((uv + r2 + (block - 1)) / block).to(torch.int32), torch.zeros_like(tg), tg)
        span = tmax - tmin
        tiles = span[:, 0] * span[:, 1]
        keep = (tiles != 0) & det_ok & visible
    conic = torch.nan_to_num(conic) * keep[:, None]
    return SimpleNamespace(uv=uv, depth=depth, conic=conic, radius=(torch.nan_to_num(radius) * keep).to(torch.int32),
                     tiles=(tiles * keep).to(torch.int32), tmin=tmin * keep[:, None], tmax=tmax * keep[:, None],
                     opacity=opacity, visible=visible)


# --------------------------------------------------------------------------
# binning and the blend
# --------------------------------------------------------------------------

class Bins:
    def __init__(self, gid, starts, counts, nint, tgx, tgy):
        self.gid, self.starts, self.counts, self.nint, self.tgx, self.tgy = gid, starts, counts, nint, tgx, tgy


@torch.no_grad()
def bin_pairs(pr: SimpleNamespace, W: int, H: int, block: int, max_tiles: int, budget: int) -> Bins:
    dev = pr.depth.device
    tgx, tgy = -(-W // block), -(-H // block)
    tiles = torch.clamp_max(pr.tiles.long(), max_tiles)
    nint = int(tiles.sum())
    owner = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev), tiles)[:budget]
    offs = torch.cumsum(tiles, 0) - tiles
    j = torch.arange(owner.shape[0], device=dev) - offs[owner]
    rmx, rmy = pr.tmin[owner, 0].long(), pr.tmin[owner, 1].long()
    rw = (pr.tmax[owner, 0].long() - rmx).clamp_min(1)
    tile = (rmy + j // rw) * tgx + (rmx + j % rw)
    bits = torch.where(pr.depth > 0, pr.depth, 0.0).view(torch.int32).long()[owner]
    order = torch.sort((tile << 32) | bits, stable=True).indices
    gid = owner[order]
    counts = torch.bincount(tile, minlength=tgx * tgy)
    starts = torch.cumsum(counts, 0) - counts
    return Bins(gid, starts, counts, nint, tgx, tgy)


def _chunks(counts: torch.Tensor, budget: int) -> List[torch.Tensor]:
    """Tiles grouped by slot count so that tiles x 256 x longest <= budget."""
    order = torch.argsort(counts, descending=True)
    c = counts[order].tolist()
    out, i = [], 0
    while i < len(c):
        L = max(c[i], 1)
        n = max(1, budget // (256 * L))
        out.append(order[i:i + n])
        i += n
    return out


def _tile_blend(ts, b: Bins, uv, conic, op, feats, bg, op_mask, W: int, H: int, block: int,
                stats: Optional[dict] = None):
    """Blend the tiles `ts`: (image rows [n, P, C], pixel x, pixel y)."""
    dev = uv.device
    L = max(int(b.counts[ts].max()), 1)
    P = block * block
    ar = torch.arange(L, device=dev)
    has = ar[None] < b.counts[ts][:, None]                                   # [n, L]
    g = torch.where(has, b.gid[(b.starts[ts][:, None] + ar[None]).clamp_max(max(b.gid.shape[0] - 1, 0))], 0)
    p = torch.arange(P, device=dev)
    px = (ts[:, None] % b.tgx) * block + p[None] % block                      # [n, P]
    py = (ts[:, None] // b.tgx) * block + p[None] // block
    vx = uv[g, 0][:, None, :] - px.to(torch.float32)[..., None]              # [n, P, L]
    vy = uv[g, 1][:, None, :] - py.to(torch.float32)[..., None]
    cg = conic[g]
    power = -0.5 * (cg[..., 0][:, None] * (vx * vx) + cg[..., 2][:, None] * (vy * vy)) - cg[..., 1][:, None] * vx * vy
    gexp = torch.exp(power)
    og = op[g][:, None, :]
    raw = og * gexp
    with torch.no_grad():
        valid = has[:, None, :] & (power <= 0) & (torch.clamp_max(raw, ALPHA_MAX) >= ALPHA_MIN)
        a_val = torch.where(valid, torch.clamp_max(raw, ALPHA_MAX), 0.0)
        applied = valid & (torch.cumprod(1.0 - a_val, -1) >= T_EPS)
        if stats is not None:
            # a tile walks its slots until its last pixel stops (at the
            # Gaussian that ends it, or at the range's end)
            inside = (px < W) & (py < H)
            term = valid & ~applied
            stop = torch.where(term.any(-1), torch.argmax(term.to(torch.int8), -1) + 1, b.counts[ts][:, None])
            walked = torch.where(inside, stop, 0).amax(-1)
            stats["tests"] += int((walked * inside.sum(-1)).sum())
            stats["applied"] += int((applied & inside[..., None]).sum())
    out = []
    for use_op in (True, False):
        cm = op_mask if use_op else ~op_mask
        if not bool(cm.any()):
            continue
        r = raw if use_op else og.detach() * gexp
        alpha = r - (r - ALPHA_MAX).clamp_min(0.0).detach()       # min(r, .99), its gradient passed
        a = torch.where(applied, alpha, 0.0)
        incl = torch.cumprod(1.0 - a, -1)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], -1)
        w = a * excl
        f = feats[:, cm][g]                                       # [n, L, c]
        img = torch.einsum("npl,nlc->npc", w, f) + incl[..., -1:] * bg[cm]
        out.append((cm, img))
    rows = torch.zeros((ts.shape[0], P, feats.shape[1]), dtype=torch.float32, device=dev)
    for cm, img in out:
        rows = rows.index_copy(2, torch.nonzero(cm)[:, 0], img)
    return rows, px, py


def blend(b: Bins, uv, conic, op, feats, bg, op_mask, W: int, H: int, block: int,
          budget: int = 1 << 26, grad_image: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
    """The image [H, W, C] (no gradient); or, given dL/dimage, the gradient
    accumulated into the leaves uv, conic, op, feats chunk by chunk."""
    C = feats.shape[1]
    image = torch.zeros((H, W, C), dtype=torch.float32, device=uv.device)
    for ts in _chunks(b.counts, budget):
        if grad_image is None:
            with torch.no_grad():
                rows, px, py = _tile_blend(ts, b, uv, conic, op, feats, bg, op_mask, W, H, block, stats)
            ok = (px < W) & (py < H)
            image[py[ok], px[ok]] = rows[ok]
        else:
            with torch.enable_grad():
                rows, px, py = _tile_blend(ts, b, uv, conic, op, feats, bg, op_mask, W, H, block)
                ok = (px < W) & (py < H)
                g = torch.zeros_like(rows)
                g[ok] = grad_image[py[ok], px[ok]]
                rows.backward(g)
    return image


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _abs(x):
    return torch.where(x >= 0, x, -x)


def _sorted_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    pos = torch.tensor(q, dtype=torch.float32) * float(s.shape[0] - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    return s[int(lo)] * (1.0 - hw).to(s.device) + s[int(hi)] * hw.to(s.device)


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _band(n: int, dev) -> torch.Tensor:
    """[n, n] zero-padded 11-tap Gaussian blur (sigma 1.5) as a band matrix."""
    x = np.arange(11) - 5
    g = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = torch.tensor((g / g.sum()).astype(np.float32), device=dev)
    i = torch.arange(n, device=dev)
    d = i[None, :] - i[:, None]
    return torch.where(d.abs() <= 5, g[(d + 5).clamp(0, 10)], torch.zeros((), device=dev))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [H, W, C] images: 11-tap Gaussian window (sigma 1.5),
    zero padding, C1 = 0.01^2, C2 = 0.03^2; the separable blur as two band
    matrix products (so TF32 reaches it, as it would the program's)."""
    bh, bw = _band(a.shape[0], a.device), _band(a.shape[1], a.device)

    def blur(img):
        return torch.einsum("wW,hWc->hwc", bw, torch.einsum("hH,Hwc->hwc", bh, img))

    m1, m2 = blur(a), blur(b)
    s1 = blur(a * a) - m1 * m1
    s2 = blur(b * b) - m2 * m2
    s12 = blur(a * b) - m1 * m2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * m1 * m2 + c1) * (2 * s12 + c2)) / ((m1 * m1 + m2 * m2 + c1) * (s1 + s2 + c2))).mean()


def image_losses(feat: Dict[str, torch.Tensor], batch: dict, rc: dict, H: int, W: int, T: int,
                 half: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss terms read from the rendered image (all but ARAP). `half`
    keeps the top half of the frame only (a planted fault)."""
    rows = slice(0, H // 2) if half else slice(0, H)
    rgb, gt = feat["rgb"][rows], batch["rgb"][rows]
    l_rgb = (1.0 - rc["lambda_dssim"]) * torch.mean(_abs(rgb - gt)) + rc["lambda_dssim"] * (1.0 - ssim(rgb, gt))
    # tracking: the rendered track_gs map read at the query pixels
    tg = feat["track_gs"][..., :2]
    wh = torch.tensor([W, H], dtype=torch.float32, device=tg.device)
    pred = (tg + 1.0) * 0.5 * wh
    qp, tt, valid = batch["query_px"], batch["target"], batch["valid"]
    pq = pred[qp[:, 1].long(), qp[:, 0].long()]
    conf = (1.0 - torch.sigmoid(tt[:, 2])) * (1.0 - torch.sigmoid(tt[:, 3]))
    vis = (conf > 0.5) & valid
    w_int = torch.exp(-2.0 * torch.tensor(float(abs(batch["t2"] - batch["t1"])), dtype=torch.float32) / T)
    mask = (conf * w_int.to(conf.device))[:, None] * vis[:, None].to(torch.float32)
    err = torch.mean(_abs(pq - tt[:, :2]), -1, keepdim=True)
    big = torch.max(torch.where(vis[:, None], err, float("-inf")))
    q = _sorted_quantile(torch.where(vis[:, None], err, big).detach(), rc["track_quantile"])
    mask = mask * (err <= q).to(torch.float32)
    l_flow = torch.sum(err * mask) / (torch.sum(mask) + 1e-8) / max(H, W)
    # depth: median / mean-absolute-deviation normalised squared error
    pd, gd = feat["depth"][rows][..., 0], batch["depth"][rows]
    tp = _median(pd.detach())
    sp = torch.mean(_abs(pd - tp))
    tgd = _median(gd)
    sg = torch.mean(_abs(gd - tgd))
    l_depth = torch.mean(((pd - tp) / torch.clamp_min(sp, 1e-8) - (gd - tgd) / torch.clamp_min(sg, 1e-8)) ** 2)
    loss = rc["rgb_weight"] * l_rgb
    if rc["flow_weight"]:
        loss = loss + rc["flow_weight"] * l_flow
    if rc["depth_weight"]:
        loss = loss + rc["depth_weight"] * l_depth
    terms = {"loss_rgb": l_rgb, "loss_flow": l_flow, "loss_depth": l_depth}
    if rc["mask_attr_weight"]:
        lm = torch.mean((feat["mask_attribute"][rows][..., 0] - batch["mask"][rows]) ** 2)
        loss = loss + rc["mask_attr_weight"] * lm
        terms["loss_mask_attr"] = lm
    if rc["dino_attr_weight"]:
        ld = torch.mean((feat["dino_attribute"][rows] - batch["dino"][rows]) ** 2)
        loss = loss + rc["dino_attr_weight"] * ld
        terms["loss_dino_attr"] = ld
    return loss, terms


def sq_dists_fma(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """|q|^2 + |p|^2 - 2 q.p with the dot as a chain of fused multiply-adds
    (each formed in float64, rounded once), floored at 0."""
    dot = q[..., 0] * p[..., 0]
    for i in (1, 2):
        wide = q[..., i].double() * p[..., i].double()
        wide += dot
        dot = wide.float()
    sq = lambda x: (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    return torch.clamp_min(sq(q) + sq(p) - 2.0 * dot, 0.0)


def smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of the k smallest entries per row: by value, equal values by
    descending index."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False)
    thr = vals[:, -1:]
    n_less = (vals < thr).sum(1, keepdim=True)
    cols = torch.arange(d2.shape[1], dtype=torch.int32, device=d2.device)
    tied = torch.topk(torch.where(d2 == thr, cols, -1), k, dim=1).values.long()
    j = torch.arange(k, device=d2.device)[None, :]
    out = torch.where(j < n_less, idx, torch.gather(tied, 1, (j - n_less).clamp_min(0)))
    out = torch.sort(out, dim=1, descending=True).values
    order = torch.sort(torch.gather(d2, 1, out), dim=1, stable=True).indices
    return torch.gather(out, 1, order)


def _kabsch(src, tgt, w):
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    S = torch.einsum("nka,nk,nkb->nab", src, w, tgt)
    same = torch.all(torch.all(src == tgt, dim=2), dim=1)
    S = torch.where(same[:, None, None], 0.0, S) + 1e-8 * eye
    U, sig, Vt = torch.linalg.svd(S)
    Wm = Vt.transpose(-1, -2)
    R = Wm @ U.transpose(-1, -2)
    det = torch.linalg.det(R)
    flip = torch.argmin(sig, dim=-1)
    a3 = torch.arange(3, device=S.device)[None, :]
    sign = torch.where(a3 == flip[:, None], torch.where(det[:, None] <= 0, -1.0, 1.0), 1.0)
    R = torch.where((det <= 0)[:, None, None], Wm @ (U * sign[:, None, :]).transpose(-1, -2), R)
    bad = ~torch.all(torch.isfinite(R).reshape(R.shape[0], -1), dim=1)
    return torch.where(bad[:, None, None], eye, R)


def arap(pos1, pos2, alive, key, k: int, sample_num: int, chunk: int = 64) -> torch.Tensor:
    """ARAP on `sample_num` alive points drawn from `key` (with replacement,
    uniform over the alive slots), their k nearest alive neighbours at t1."""
    N = pos1.shape[0]
    S = min(sample_num, N)
    p = alive.to(torch.float32)
    idx = prng.choice(key, N, (S,), p / torch.clamp_min(p.sum(), 1.0))
    q = pos1[idx]
    with torch.no_grad():
        nn = []
        for s in range(0, S, chunk):
            d2 = sq_dists_fma(q[s:s + chunk, None, :], pos1[None, :, :])
            d2 = torch.where(alive[None, :], d2, float("inf"))
            nn.append(smallest_k(d2, k + 1)[:, 1:])
        nn_i = torch.cat(nn)
    nn_d = sq_dists_fma(q[:, None, :], pos1[nn_i])
    nn_d = torch.where(alive[nn_i], nn_d, float("inf"))
    cut = torch.arange(k, device=pos1.device)[None, :] >= 3
    valid = torch.where(cut, nn_d < 0.1 ** 2, True)
    nn_d = torch.where(torch.isfinite(nn_d), nn_d, 0.0)
    w = torch.exp(-nn_d / torch.clamp_min(torch.mean(nn_d), 1e-12))
    w = torch.where(valid, w, 0.0)
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)
    src = torch.where(valid[..., None], pos1[idx][:, None, :] - pos1[nn_i], 0.0)
    tgt = torch.where(valid[..., None], pos2[idx][:, None, :] - pos2[nn_i], 0.0)
    with torch.no_grad():
        R = _kabsch(src, tgt, w)
    stretch = torch.sum((tgt - torch.einsum("nab,nkb->nka", R, src)) ** 2, dim=-1)
    return torch.sum(w * stretch) / 2.0


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------

def learning_rate(oc: dict, name: str, count: int) -> torch.Tensor:
    if name in oc["schedules"]:
        init, final = oc["schedules"][name]
        li = float(np.log(init * oc["spatial_lr_scale"]))
        lf = float(np.log(final * oc["spatial_lr_scale"]))
        t = torch.clamp(torch.tensor(count, dtype=torch.float32) / oc["lr_max_steps"], 0.0, 1.0)
        return torch.exp(li * (1 - t) + lf * t)
    return torch.tensor(oc["lrs"].get(name, 0.001), dtype=torch.float32)


@torch.no_grad()
def adam(oc: dict, params, grads, mu, nu, count: int):
    """One update of every attribute; returns (params, mu, nu, count)."""
    n = count + 1
    dev = next(iter(params.values())).device
    bc1 = (1.0 - torch.tensor(oc["b1"], dtype=torch.float32) ** n).to(dev)
    bc2 = (1.0 - torch.tensor(oc["b2"], dtype=torch.float32) ** n).to(dev)
    out, m2, v2 = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m2[k] = (1 - oc["b1"]) * g + oc["b1"] * mu[k]
        v2[k] = (1 - oc["b2"]) * (g * g) + oc["b2"] * nu[k]
        out[k] = p + (-learning_rate(oc, k, count).to(dev)) * ((m2[k] / bc1) / (torch.sqrt(v2[k] / bc2) + oc["eps"]))
    return out, m2, v2, n


# --------------------------------------------------------------------------
# density control
# --------------------------------------------------------------------------

def _lexsort(keys):
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


@torch.no_grad()
def density_event(params, alive, accum, denom, step: int, dc: dict, noise: torch.Tensor):
    """One clone / split / prune event: (params, alive, used slots, counts)."""
    cap = alive.shape[0]
    dev = alive.device
    grads = torch.nan_to_num(torch.where(denom > 0, accum / denom, 0.0))
    max_scale = torch.max(torch.exp(params["scaling"]), dim=-1).values
    hot = alive & (grads >= dc["densify_grad_threshold"])
    split = hot & (max_scale > dc["percent_dense"] * dc["cameras_extent"])
    sn = dc["split_num"]
    n_child = torch.where(hot, torch.where(split, sn, 1), 0)
    prio = torch.where(hot, grads, float("-inf"))
    order = _lexsort(((-prio), (split & hot).to(torch.int8), (~hot).to(torch.int8)))
    n_child_o = n_child[order]
    cum = torch.cumsum(n_child_o, 0)
    c = torch.arange(cap, device=dev)
    pj = torch.searchsorted(cum, c, right=True)
    valid = c < cum[-1]
    parent = order[torch.clamp_max(pj, cap - 1)]
    cand_parent = torch.where(valid, parent, -1)
    cand_split = valid & split[parent]
    free = torch.nonzero(~alive).reshape(-1)
    free_idx = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    free_idx[: free.shape[0]] = free
    n_placed = torch.minimum(torch.sum(~alive), torch.sum(cand_parent >= 0))
    if dc["max_growth_frac"] > 0:
        n_placed = torch.minimum(n_placed, torch.ceil(dc["max_growth_frac"] * torch.sum(alive).to(torch.float32)).to(torch.int64))
    placed = (c < n_placed) & (cand_parent >= 0)
    dst = free_idx[placed]
    src = torch.where(cand_parent >= 0, cand_parent, 0)
    off = torch.einsum("nij,nj->ni", quat_rotmat(params["rotation"][src]), noise * torch.exp(params["scaling"][src]))
    shrink = torch.log(torch.tensor(0.8 * sn, dtype=torch.float32)).to(dev)
    new = {}
    for name, val in params.items():
        if val.dim() == 0 or val.shape[0] != cap:
            new[name] = val
            continue
        child = val[src]
        if name == "position":
            child = torch.where(cand_split[:, None], child + off, child)
        elif name == "scaling":
            child = torch.where(cand_split[:, None], child - shrink, child)
        o = val.clone()
        o[dst] = child[placed]
        new[name] = o
    used = torch.zeros((cap,), dtype=torch.bool, device=dev)
    used[dst] = True
    alive2 = alive | used
    start = (cum - n_child_o)[torch.argsort(order)]
    removed = split & (start + sn <= n_placed)
    alive2 = alive2 & ~removed
    opa = torch.sigmoid(new["opacity"][:, 0])
    size = torch.max(torch.exp(new["scaling"]), dim=-1).values > 0.1 * dc["cameras_extent"]
    if not dc["size_prune_always"]:
        size = size & (step > dc["opacity_reset_interval"])
    prune = ((opa < dc["min_opacity"]) | size) & ~used
    n_pruned = torch.sum(prune & alive2)
    alive2 = alive2 & ~prune
    counts = {"num_cloned": int(torch.sum((c < n_placed) & valid & ~cand_split)), "num_split": int(torch.sum(removed)),
              "num_pruned": int(n_pruned), "dropped": int(torch.sum(cand_parent >= 0) - n_placed),
              "num_alive": int(torch.sum(alive2))}
    return new, alive2, used, counts
