"""The benchmark's input clip, made on the device from the run's seed.

A PyTorch rewrite of the textured synthetic clip
(`splatter_a_video_tpu_torch/data/synthetic.py`, `texture=True`): a static
procedural background, `num_blobs` textured blobs that move on sinusoids,
rotate and breathe in scale, and a textured occluder bar that sweeps across
the frame in front of everything. It gives, per frame, the image, the layer
depth, the foreground mask and a 3-channel per-object stand-in for DINO
features, and for every pair of frames (q, t) the ground-truth tracks of a
pixel grid of stride `track_grid` in frame q: [n, 4] rows of (x, y,
occlusion logit, distance logit), as TAPIR would give them.

The same seed gives the same clip on any one device. The textures are drawn
from one `torch.Generator` on the device, the objects' motion from a fixed
draw (`GEOMETRY_SEED`); everything is computed there and copied to the host
once, where the program's `VideoFlowData` reads it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

OCC_DEPTH = 0.5          # the occluder lies in front of every blob (0.8 - 1.6)
# The objects' paths, turns and breathing are one fixed draw: every seed asks
# the same work of the fit (the same overlaps and occlusions, so the same
# intersection counts), and the seed draws the textures, the per-object
# feature codes and, in the fit, the track rows, frame pairs and samples.
GEOMETRY_SEED = 0


@dataclass(frozen=True)
class ClipSpec:
    width: int
    height: int
    num_frames: int
    num_blobs: int
    blob_radius: float
    track_grid: int
    dino: bool = False
    rot_turns: float = 0.5
    scale_amp: float = 0.25


@dataclass
class Clip:
    """The clip on the host, as numpy arrays (views into four blocks)."""

    frames: List[np.ndarray]            # [H, W, 3] float32 in [0, 1]
    depths: List[np.ndarray]            # [H, W] float32 layer depth
    masks: List[np.ndarray]             # [H, W] bool foreground
    dinos: Optional[List[np.ndarray]]   # [H, W, 3] float32 or None
    tracks: Dict[tuple, np.ndarray]     # (q, t) -> [n, 4] float32
    query_grid: np.ndarray              # [n, 2] float32 pixel coords (x, y)


def spec_from_config(cfg: dict) -> ClipSpec:
    W, H = cfg["frame_size"]
    return ClipSpec(width=W, height=H, num_frames=cfg["num_frames"], num_blobs=cfg["num_blobs"],
                    blob_radius=cfg["blob_radius"], track_grid=cfg["track_grid"], dino=bool(cfg["dino"]))


def _texture(gen: torch.Generator, freq: float, dev, n: int = 24):
    """Random Fourier features mixed into RGB in [0, 1]: band-limited, so a
    local patch is unique and bilinear sampling stays faithful."""
    Wf = torch.randn((n, 2), generator=gen, device=dev) * freq
    ph = torch.rand((n,), generator=gen, device=dev) * (2 * math.pi)
    A = torch.randn((n, 3), generator=gen, device=dev) / math.sqrt(n)

    def tex(pts: torch.Tensor) -> torch.Tensor:   # [m, 2] -> [m, 3]
        v = torch.cos(pts @ Wf.T + ph) @ A
        return 0.5 + 0.45 * torch.tanh(1.8 * v)

    return tex


def _rotate(xy: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 2] points by theta (broadcast over the leading axes)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c * xy[..., 0] - s * xy[..., 1], s * xy[..., 0] + c * xy[..., 1]], -1)


def make_clip(spec: ClipSpec, seed: int, device) -> Clip:
    """The clip of `spec` drawn from `seed` on `device`, copied to the host."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    geo = torch.Generator(device="cpu")
    geo.manual_seed(GEOMETRY_SEED)
    W, H, T, K, R = spec.width, spec.height, spec.num_frames, spec.num_blobs, spec.blob_radius
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.no_grad():
        phases = torch.rand((K,), generator=geo).to(dev)
        rot_dirs = torch.where(torch.rand((K,), generator=geo) < 0.5, -1.0, 1.0).to(dev)
        scale_ph = (torch.rand((K,), generator=geo) * (2 * math.pi)).to(dev)
        depths_k = torch.linspace(0.8, 1.6, K, **f32)
        tex_scale = max(R / 6.0, 1.0)          # texture features ~4-8 px wide
        blob_tex = [_texture(gen, 0.9 / tex_scale, dev) for _ in range(K)]
        bg_tex = _texture(gen, 0.35 / tex_scale, dev)
        occ_tex = _texture(gen, 0.7 / tex_scale, dev)
        # per-object feature codes: background, blobs, occluder
        codes = torch.rand((K + 2, 3), generator=gen, device=dev)
        occ_w = 0.14 * W

        k = torch.arange(K, device=dev)
        base = torch.stack([W * (0.25 + 0.5 * (k % 2)), H * (0.3 + 0.4 * ((k // 2) % 2))], 1).float()
        amp = torch.tensor([W * 0.12, H * 0.12], **f32)
        ts = torch.arange(T, **f32) / max(T - 1, 1)                              # [T]
        ang = 2 * math.pi * (ts[:, None] + phases[None])                          # [T, K]
        centers = base[None] + amp * torch.stack([torch.sin(ang), torch.cos(1.5 * ang)], -1)  # [T, K, 2]
        theta = 2 * math.pi * spec.rot_turns * ts[:, None] * rot_dirs[None]       # [T, K]
        scale = 1.0 + spec.scale_amp * torch.sin(2 * math.pi * ts[:, None] + scale_ph[None])  # [T, K]
        occ_x = -occ_w + ts * (W + 2 * occ_w)                                     # [T]

        yy, xx = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
        pix = torch.stack([xx, yy], -1)                                           # [H, W, 2]
        bg_img = bg_tex(pix.reshape(-1, 2)).reshape(H, W, 3)
        bg_depth = 2.0 + 0.8 * (yy / H) + 0.2 * (xx / W)

        frames = torch.empty((T, H, W, 3), dtype=torch.float32, pin_memory=dev.type == "cuda")
        depths = torch.empty((T, H, W), dtype=torch.float32, pin_memory=dev.type == "cuda")
        masks = torch.empty((T, H, W), dtype=torch.bool)
        dinos = torch.empty((T, H, W, 3), dtype=torch.float32) if spec.dino else None
        back_to_front = torch.argsort(-depths_k).tolist()
        for f in range(T):
            img = bg_img.clone()
            depth = bg_depth.clone()
            owner = torch.zeros((H, W), dtype=torch.int64, device=dev)      # 0 = background
            for kk in back_to_front:
                rel = pix - centers[f, kk]
                inside = (rel * rel).sum(-1) < (R * scale[f, kk]) ** 2
                local = _rotate(rel[inside], -theta[f, kk]) / scale[f, kk]
                img[inside] = blob_tex[kk](local)
                depth[inside] = depths_k[kk]
                owner[inside] = kk + 1
            occ_in = (xx - occ_x[f]).abs() < occ_w / 2
            img[occ_in] = occ_tex(pix[occ_in] - torch.stack([occ_x[f], occ_x.new_zeros(())]))
            depth[occ_in] = OCC_DEPTH
            owner[occ_in] = K + 1
            frames[f].copy_(img, non_blocking=True)
            depths[f].copy_(depth, non_blocking=True)
            masks[f].copy_(owner > 0)
            if dinos is not None:
                dinos[f].copy_(codes[owner])

        g = spec.track_grid
        qy, qx = torch.meshgrid(torch.arange(0, H, g, **f32), torch.arange(0, W, g, **f32), indexing="ij")
        pts = torch.stack([qx.reshape(-1), qy.reshape(-1)], 1)                    # [n, 2]
        n = pts.shape[0]
        tracks_host = torch.empty((T, T, n, 4), dtype=torch.float32, pin_memory=dev.type == "cuda")
        for q in range(T):
            rel = pts[:, None, :] - centers[q][None]                              # [n, K, 2]
            d2 = (rel * rel).sum(-1)
            in_blob = d2 < (R * scale[q]) ** 2
            owner = torch.where(in_blob.any(1), torch.argmin(torch.where(in_blob, d2, float("inf")), 1),
                                torch.full((n,), -1, device=dev))
            on_occ = (pts[:, 0] - occ_x[q]).abs() < occ_w / 2
            own_k = owner.clamp_min(0)
            # local coordinates in the owner's frame at q
            local = _rotate(rel[torch.arange(n, device=dev), own_k], -theta[q, own_k]) / scale[q, own_k, None]
            own_depth = torch.where(owner >= 0, depths_k[own_k], torch.full_like(pts[:, 0], float("inf")))
            own_depth = torch.where(on_occ, OCC_DEPTH, own_depth)
            # the targets in every frame t: the owner's similarity transform
            blob_t = centers[:, own_k] + scale[:, own_k, None] * _rotate(local[None], theta[:, own_k])  # [T, n, 2]
            occ_t = (pts - torch.stack([occ_x[q], occ_x.new_zeros(())]))[None] + \
                torch.stack([occ_x, torch.zeros_like(occ_x)], 1)[:, None, :]
            target = torch.where(on_occ[None, :, None], occ_t,
                                 torch.where((owner >= 0)[None, :, None], blob_t, pts[None].expand(T, n, 2)))
            inb = ((target[..., 0] >= 0) & (target[..., 0] <= W - 1)
                   & (target[..., 1] >= 0) & (target[..., 1] <= H - 1))
            covered = (own_depth[None] > OCC_DEPTH + 1e-6) & ((target[..., 0] - occ_x[:, None]).abs() < occ_w / 2)
            for kk in range(K):
                d2k = ((target - centers[:, None, kk]) ** 2).sum(-1)
                covered |= (own_depth[None] > depths_k[kk] + 1e-6) & (d2k < (R * scale[:, kk, None]) ** 2)
            trk = torch.empty((T, n, 4), **f32)
            trk[..., :2] = target
            trk[..., 2] = torch.where(inb & ~covered, -8.0, 8.0)
            trk[..., 3] = -8.0
            tracks_host[q].copy_(trk, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fr, de, ma, tr = frames.numpy(), depths.numpy(), masks.numpy(), tracks_host.numpy()
    return Clip(
        frames=[fr[f] for f in range(T)],
        depths=[de[f] for f in range(T)],
        masks=[ma[f] for f in range(T)],
        dinos=None if dinos is None else [dinos.numpy()[f] for f in range(T)],
        tracks={(q, t): tr[q, t] for q in range(T) for t in range(T)},
        query_grid=pts.cpu().numpy(),
    )


def to_video_flow(clip: Clip):
    """The clip as the program's `VideoFlowData` (its `setup` runs here)."""
    from splatter_a_video_tpu_torch.data.video_flow import VideoFlowData

    return VideoFlowData(frames=clip.frames, depths_raw=clip.depths, masks_raw=clip.masks,
                         dinos=clip.dinos, tracks=clip.tracks, mask_erosion_radius=2).setup()
