"""Synthetic video clips with ground-truth tracks, depth and masks
(counterpart of `splatter_a_video_tpu/data/synthetic.py`).

An in-memory clip (images, fg masks, disparity, TAPIR-style per-pair
tracks) with known motion, so that lifting, spline fitting, training and
tracking evaluation run without data on disk. Both variants draw from a
`RandomState` in the JAX package's order and give byte-identical clips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from .video_flow import VideoFlowData


@dataclass
class SyntheticClipConfig:
    width: int = 64
    height: int = 48
    num_frames: int = 12
    num_blobs: int = 4
    blob_radius: float = 6.0
    track_grid: int = 4      # query-point stride, like TAPIR grid_size=4
    seed: int = 0
    # --- adversarial "textured" variant ------------------------------
    # The flat-colored blob clip is trivially trackable: the photometric
    # term alone solves correspondence (which is why the blob harness
    # needs loss_flow_weight=20 vs the production 2). With texture=True
    # the clip becomes a scene where photometric loss CANNOT cheat:
    #   * fg blobs and bg carry procedural random-Fourier noise textures,
    #   * each blob rotates (rot_turns over the clip) and oscillates in
    #     scale (1 ± scale_amp) — nonrigid 2D deformation that per-point
    #     trajectories must absorb,
    #   * a textured occluder bar sweeps across the frame in front of
    #     everything, producing real occlusion crossings in the GT tracks.
    # texture=False output stays byte-identical to the original clip.
    texture: bool = False
    occluder: bool = True     # textured variant only: moving occluder bar
    rot_turns: float = 0.5    # fg rotation over the whole clip (turns)
    scale_amp: float = 0.25   # fg scale oscillation amplitude


def _blob_centers(cfg: SyntheticClipConfig, t: float, rng_phase: np.ndarray) -> np.ndarray:
    """[K, 2] pixel centers at normalized time t — smooth sinusoid paths."""
    K = cfg.num_blobs
    W, H = cfg.width, cfg.height
    base = np.stack(
        [
            W * (0.25 + 0.5 * (np.arange(K) % 2)),
            H * (0.3 + 0.4 * (np.arange(K) // 2 % 2)),
        ],
        axis=1,
    )
    amp = np.array([W * 0.12, H * 0.12])
    ang = 2 * np.pi * (t + rng_phase[:, None])
    return base + amp * np.concatenate([np.sin(ang), np.cos(ang * 1.5)], axis=1)[:, :2]


def _fourier_tex(rng: np.random.RandomState, freq: float, n: int = 24):
    """Smooth procedural RGB texture sampled at continuous 2D coords.

    Random Fourier features (cos of random-frequency planes) mixed into 3
    channels — band-limited so bilinear track sampling stays faithful, yet
    rich enough that a local patch is unique (photometric matching has a
    single basin). `freq` is the frequency std in rad/px.
    """
    Wf = rng.normal(0.0, freq, (n, 2))
    ph = rng.uniform(0.0, 2 * np.pi, n)
    A = rng.normal(0.0, 1.0, (n, 3)) / np.sqrt(n)

    def tex(pts: np.ndarray) -> np.ndarray:  # [N, 2] -> [N, 3] in [0, 1]
        v = np.cos(pts @ Wf.T + ph) @ A
        return (0.5 + 0.45 * np.tanh(1.8 * v)).astype(np.float32)

    return tex


def _rot2(theta: np.ndarray) -> np.ndarray:
    """[..., 2, 2] rotation matrices."""
    c, s = np.cos(theta), np.sin(theta)
    return np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
    )


def _make_textured_clip(cfg: SyntheticClipConfig) -> VideoFlowData:
    """The adversarial variant: textured fg/bg, per-blob rotation + scale
    oscillation, and a textured occluder bar sweeping in front of
    everything. GT tracks follow the similarity transform of their owner
    object and carry real occlusion logits (occluder crossings, inter-blob
    cover, out-of-frame).

    The blob clip binds tracking only at flow weight 20; this clip is
    trained at the production weight 2.
    """
    rng = np.random.RandomState(cfg.seed)
    W, H, T, K = cfg.width, cfg.height, cfg.num_frames, cfg.num_blobs
    phases = rng.rand(K)
    depths_k = np.linspace(0.8, 1.6, K)
    # per-blob pose parameters
    rot_dirs = np.where(rng.rand(K) < 0.5, -1.0, 1.0)
    scale_ph = rng.uniform(0.0, 2 * np.pi, K)
    # textures: one per blob (sampled in the blob's local frame, units of
    # pixels at scale 1), one for bg, one for the occluder
    tex_scale = max(cfg.blob_radius / 6.0, 1.0)  # keep features ~4-8 px
    blob_tex = [_fourier_tex(rng, 0.9 / tex_scale) for _ in range(K)]
    bg_tex = _fourier_tex(rng, 0.35 / tex_scale)
    occ_tex = _fourier_tex(rng, 0.7 / tex_scale)
    occ_w = 0.14 * W            # occluder bar half-... full width
    occ_depth = 0.5             # in front of every blob (min blob 0.8)

    def blob_theta(t: float) -> np.ndarray:  # [K]
        return 2 * np.pi * cfg.rot_turns * t * rot_dirs

    def blob_scale(t: float) -> np.ndarray:  # [K]
        return 1.0 + cfg.scale_amp * np.sin(2 * np.pi * t + scale_ph)

    def occ_cx(t: float) -> float:
        # sweep fully across: starts just off the left edge, exits right
        return -occ_w + t * (W + 2 * occ_w) if cfg.occluder else -1e9

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pix = np.stack([xx, yy], axis=-1)  # [H, W, 2]
    frames, masks, disps = [], [], []
    centers_t, theta_t, scale_t, occx_t = [], [], [], []
    # the background texture is static — evaluate the Fourier features once
    # (was ~40% of generation time at 480p x 48 frames)
    bg_img = bg_tex(pix.reshape(-1, 2)).reshape(H, W, 3)
    for f in range(T):
        t = f / max(T - 1, 1)
        centers = _blob_centers(cfg, t, phases)
        th, sc, ocx = blob_theta(t), blob_scale(t), occ_cx(t)
        centers_t.append(centers); theta_t.append(th)
        scale_t.append(sc); occx_t.append(ocx)
        img = bg_img.copy()
        depth = (2.0 + 0.8 * (yy / H) + 0.2 * (xx / W)).astype(np.float32)
        mask = np.zeros((H, W), bool)
        for k in np.argsort(-depths_k):  # back-to-front
            rel = pix - centers[k]
            inside = (rel**2).sum(-1) < (cfg.blob_radius * sc[k]) ** 2
            local = (rel[inside] @ _rot2(np.float64(th[k]))) / sc[k]
            img[inside] = blob_tex[k](local)
            depth[inside] = depths_k[k]
            mask |= inside
        if cfg.occluder:
            occ_in = np.abs(xx - ocx) < occ_w / 2
            img[occ_in] = occ_tex(
                (pix[occ_in] - [ocx, 0.0]).astype(np.float32))
            depth[occ_in] = occ_depth
            mask |= occ_in
        frames.append(img)
        masks.append(mask)
        disps.append(1.0 / depth)
    centers_t = np.stack(centers_t)         # [T, K, 2]
    theta_t = np.stack(theta_t)             # [T, K]
    scale_t = np.stack(scale_t)             # [T, K]
    occx_t = np.asarray(occx_t)             # [T]

    # GT tracks: owner = occluder > nearest covering blob > static bg.
    # target(tt) = similarity transform of the owner; occlusion checks
    # out-of-frame, occluder cover, and any nearer blob's cover.
    tracks: Dict[Tuple[int, int], np.ndarray] = {}
    g = cfg.track_grid
    OCC_ID, BG_ID = K, -1
    for q in range(T):
        qy, qx = np.mgrid[0:H:g, 0:W:g]
        pts = np.stack([qx.ravel(), qy.ravel()], axis=1).astype(np.float64)
        n = len(pts)
        rel = pts[:, None, :] - centers_t[q][None]          # [n, K, 2]
        in_blob = (rel**2).sum(-1) < (cfg.blob_radius * scale_t[q]) ** 2
        owner = np.where(
            in_blob.any(1), np.argmin(np.where(
                in_blob, (rel**2).sum(-1), np.inf), axis=1), BG_ID)
        if cfg.occluder:
            owner = np.where(
                np.abs(pts[:, 0] - occx_t[q]) < occ_w / 2, OCC_ID, owner)
        # local coords in the owner's frame at q
        local = np.zeros_like(pts)
        for k in range(K):
            m = owner == k
            local[m] = (rel[m, k] @ _rot2(theta_t[q, k])) / scale_t[q, k]
        m = owner == OCC_ID
        local[m] = pts[m] - [occx_t[q], 0.0]
        own_depth = np.where(
            owner == OCC_ID, occ_depth,
            np.where(owner == BG_ID, np.inf,
                     depths_k[np.clip(owner, 0, K - 1)]))
        # all target frames at once (the python (q, tt) double loop was
        # ~2 min of the 480p clip's generation time); every op below is the
        # batched form of the per-tt computation it replaces — 2-term dots
        # and elementwise ops, so the f32 output is byte-identical
        target = np.broadcast_to(pts, (T, n, 2)).copy()   # bg stays static
        for k in range(K):
            m = owner == k
            if not m.any():
                continue
            # [T, nk, 2] = local[m] @ R(theta[tt, k]).T for every tt
            rot = np.matmul(local[m][None], _rot2(theta_t[:, k]).transpose(0, 2, 1))
            target[:, m] = (
                centers_t[:, None, k] + scale_t[:, k, None, None] * rot
            )
        m = owner == OCC_ID
        if m.any():
            target[:, m] = local[m][None] + np.stack(
                [occx_t, np.zeros(T)], axis=1)[:, None, :]
        inb = (
            (target[..., 0] >= 0) & (target[..., 0] <= W - 1)
            & (target[..., 1] >= 0) & (target[..., 1] <= H - 1)
        )                                                  # [T, n]
        covered = np.zeros((T, n), bool)
        if cfg.occluder:
            covered |= (own_depth[None] > occ_depth + 1e-6) & (
                np.abs(target[..., 0] - occx_t[:, None]) < occ_w / 2)
        for k in range(K):
            d2k = ((target - centers_t[:, None, k]) ** 2).sum(-1)
            covered |= (own_depth[None] > depths_k[k] + 1e-6) & (
                d2k < (cfg.blob_radius * scale_t[:, k, None]) ** 2)
        occ = np.where(inb & ~covered, -8.0, 8.0).astype(np.float32)
        trk = np.empty((T, n, 4), np.float32)
        trk[..., :2] = target
        trk[..., 2] = occ
        trk[..., 3] = -8.0
        for tt in range(T):
            tracks[(q, tt)] = trk[tt]

    data = VideoFlowData(
        frames=frames,
        depths_raw=[1.0 / d for d in disps],
        masks_raw=masks,
        tracks=tracks,
        mask_erosion_radius=2,
    )
    return data.setup()


def make_clip(cfg: SyntheticClipConfig) -> VideoFlowData:
    """Generate a clip and wrap it in a ready `VideoFlowData`."""
    if cfg.texture:
        return _make_textured_clip(cfg)
    rng = np.random.RandomState(cfg.seed)
    W, H, T, K = cfg.width, cfg.height, cfg.num_frames, cfg.num_blobs
    phases = rng.rand(K)
    colors = rng.uniform(0.3, 1.0, (K, 3))
    depths_k = np.linspace(0.8, 1.6, K)

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames, masks, disps = [], [], []
    centers_t = []
    for f in range(T):
        t = f / max(T - 1, 1)
        centers = _blob_centers(cfg, t, phases)
        centers_t.append(centers)
        # background: horizontal color gradient over a slanted depth plane
        # (flat depth would give the MAD-normalized depth loss a degenerate
        # scale and over-amplify its gradients)
        img = np.stack(
            [xx / W, 0.5 + 0.3 * yy / H, 1.0 - xx / W], axis=-1
        ).astype(np.float32) * 0.6
        depth = (2.0 + 0.8 * (yy / H) + 0.2 * (xx / W)).astype(np.float32)
        mask = np.zeros((H, W), bool)
        # paint blobs back-to-front
        order = np.argsort(-depths_k)
        for k in order:
            d2 = (xx - centers[k, 0]) ** 2 + (yy - centers[k, 1]) ** 2
            inside = d2 < cfg.blob_radius**2
            img[inside] = colors[k]
            depth[inside] = depths_k[k]
            mask |= inside
        frames.append(img)
        masks.append(mask)
        disps.append(1.0 / depth)
    centers_t = np.stack(centers_t)  # [T, K, 2]

    # TAPIR-style tracks: grid query points inside the fg mask of each query
    # frame, moved by the rigid motion of the blob they sit on; bg queries
    # follow the (static) background. occ/dist logits: visible & confident.
    tracks: Dict[Tuple[int, int], np.ndarray] = {}
    g = cfg.track_grid
    for q in range(T):
        qmask = masks[q]
        qy, qx = np.mgrid[0:H:g, 0:W:g]
        pts = np.stack([qx.ravel(), qy.ravel()], axis=1).astype(np.float32)
        # blob assignment in the query frame (nearest center if inside)
        d2 = ((pts[:, None, :] - centers_t[q][None]) ** 2).sum(-1)
        owner = np.argmin(d2, axis=1)
        on_blob = d2[np.arange(len(pts)), owner] < cfg.blob_radius**2
        pts_q = pts
        owner_q = owner
        for tt in range(T):
            delta = centers_t[tt][owner_q] - centers_t[q][owner_q]
            delta = np.where(on_blob[:, None], delta, 0.0)  # bg is static
            target = pts_q + delta
            inb = (
                (target[:, 0] >= 0)
                & (target[:, 0] <= W - 1)
                & (target[:, 1] >= 0)
                & (target[:, 1] <= H - 1)
            )
            occ = np.where(inb, -8.0, 8.0).astype(np.float32)  # visible logit
            dist = np.full(len(pts_q), -8.0, np.float32)       # confident
            tracks[(q, tt)] = np.concatenate(
                [target, occ[:, None], dist[:, None]], axis=1
            ).astype(np.float32)

    data = VideoFlowData(
        frames=frames,
        depths_raw=[1.0 / d for d in disps],
        masks_raw=masks,
        tracks=tracks,
        mask_erosion_radius=2,
    )
    return data.setup()


def dump_clip_to_disk(data: VideoFlowData, base_dir: str) -> str:
    """Write an in-memory clip in the on-disk DAVIS layout that
    `VideoFlowData.setup` reads:

      images/{name}.png                     uint8 frames
      masks/{name}.png                      255 = fg
      aligned_depth_anything_v2/{name}.npy  float disparity (1/depth)
      marigold/depth_npy/{name}_pred.npy    raw depth-loss GT ([0,1] scaled)
      bootstapir/{q}_{t}.npy                [N, 4] TAPIR tracks

    so the CLI path `apps.train --datadir ...` can be exercised
    hermetically. Returns base_dir.
    """
    import os

    import imageio.v2 as imageio

    names = data.frame_names or [f"{i:05d}" for i in range(len(data.frames))]
    for sub in (
        "images", "masks", "aligned_depth_anything_v2", "bootstapir",
        os.path.join("marigold", "depth_npy"),
    ):
        os.makedirs(os.path.join(base_dir, sub), exist_ok=True)
    dmax = max(float(np.max(d)) for d in data.depths_raw) or 1.0
    for i, name in enumerate(names):
        imageio.imwrite(
            os.path.join(base_dir, "images", f"{name}.png"),
            (np.clip(data.frames[i], 0, 1) * 255).astype(np.uint8),
        )
        imageio.imwrite(
            os.path.join(base_dir, "masks", f"{name}.png"),
            (np.asarray(data.masks_raw[i], np.uint8) * 255),
        )
        np.save(
            os.path.join(base_dir, "aligned_depth_anything_v2", f"{name}.npy"),
            (1.0 / np.maximum(np.asarray(data.depths_raw[i], np.float32), 1e-6)),
        )
        np.save(
            os.path.join(base_dir, "marigold", "depth_npy", f"{name}_pred.npy"),
            np.asarray(data.depths_raw[i], np.float32) / dmax,
        )
    for (q, t), arr in (data.tracks or {}).items():
        np.save(
            os.path.join(base_dir, "bootstapir", f"{names[q]}_{names[t]}.npy"),
            np.asarray(arr, np.float32),
        )
    return base_dir
