"""2D -> 3D track lifting and clip data access (counterpart of
`splatter_a_video_tpu/data/video_flow.py`; host-side numpy and scipy).

The port keeps its own copy so that it imports nothing of the JAX package.
Random draws come from a caller's `np.random.RandomState` in the same order
as the JAX package, so both packages lift the same tracks from the same
clip. `imageio` is imported only when frames are read from disk.

Expected data layout:
  images/<name>.{jpg,png}         RGB frames
  masks/<name>.png                fg masks
  <depth_dir>/<name>.npy          aligned monocular *disparity*
  <tracks_dir>/<q>_<t>.npy        [N, 4] = (x, y, occ_logit, expected_dist)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def parse_tapir_track_info(occlusions: np.ndarray, expected_dist: np.ndarray):
    """(visible, invisible, confidence) from TAPIR logits; the confidence
    is zeroed where neither test passes."""
    visibility = 1.0 - sigmoid(occlusions)
    confidence = 1.0 - sigmoid(expected_dist)
    valid_visible = visibility * confidence > 0.5
    valid_invisible = (1.0 - visibility) * confidence > 0.5
    confidence = confidence * (valid_visible | valid_invisible).astype(np.float32)
    return valid_visible, valid_invisible, confidence


def bilinear_sample(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Sample img [H, W, C] (or [H, W]) at pixel coords xy [N, 2] with
    border clamping (`grid_sample` with align_corners=True and border
    padding, given coords normalised by size - 1)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    x = np.clip(xy[:, 0], 0.0, W - 1.0)
    y = np.clip(xy[:, 1], 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    out = (
        img[y0, x0] * (1 - wx) * (1 - wy)
        + img[y0, x1] * wx * (1 - wy)
        + img[y1, x0] * (1 - wx) * wy
        + img[y1, x1] * wx * wy
    )
    return out[:, 0] if squeeze else out


def normalize_xy(xy: np.ndarray, W: int, H: int) -> np.ndarray:
    """Pixel coords -> [-1, 1] by half the image size (w / 2, not
    (w - 1) / 2: the lifting convention)."""
    wh = np.array([W, H], np.float32)
    return (xy - wh / 2.0) / (wh / 2.0)


@dataclass
class VideoFlowData:
    """A preprocessed clip and the lifting of its tracks to 3D.

    The in-memory fields (`frames`, `depths_raw`, `masks_raw`, `tracks` as
    dict[(q, t)] -> [N, 4]) may be given directly instead of read from disk.
    """

    img_dir: Optional[str] = None
    depth_dir: Optional[str] = None
    mask_dir: Optional[str] = None
    tracks_dir: Optional[str] = None
    # raw depth-loss ground truth, `<name>*.npy` (None: the lifting depth)
    loss_depth_dir: Optional[str] = None
    dino_dir: Optional[str] = None           # per-frame DINO feature images
    start: int = 0
    end: int = -1
    mask_erosion_radius: int = 3
    depth_range_min: float = 0.5   # global depth renormalisation range
    depth_range_max: float = 2.0

    frames: Optional[List[np.ndarray]] = None       # [H,W,3] float in [0,1]
    depths_raw: Optional[List[np.ndarray]] = None   # pre-filter depth [H,W]
    masks_raw: Optional[List[np.ndarray]] = None    # bool fg masks [H,W]
    loss_depths: Optional[List[np.ndarray]] = None  # raw loss-GT depth [H,W]
    dinos: Optional[List[np.ndarray]] = None        # [H,W,3] float in [0,1]
    tracks: Optional[Dict[Tuple[int, int], np.ndarray]] = None
    frame_names: Optional[List[str]] = None

    def setup(self) -> "VideoFlowData":
        if self.frames is None:
            import imageio.v2 as imageio

            names = sorted(os.listdir(self.img_dir))
            names = [os.path.splitext(n)[0] for n in names]
            if self.end == -1:
                self.end = len(names)
            self.frame_names = names[self.start : self.end]
            ext = os.path.splitext(sorted(os.listdir(self.img_dir))[0])[1]
            self.frames = [
                np.asarray(imageio.imread(f"{self.img_dir}/{n}{ext}"), np.float32)[..., :3] / 255.0
                for n in self.frame_names
            ]
            self.depths_raw = [self._load_depth(n) for n in self.frame_names]
            self.masks_raw = [self._load_mask(n) for n in self.frame_names]
            if self.loss_depth_dir and os.path.isdir(self.loss_depth_dir):
                self.loss_depths = [self._load_loss_depth(n) for n in self.frame_names]
            if self.dino_dir and os.path.isdir(self.dino_dir):
                self.dinos = [self._load_dino(n) for n in self.frame_names]
        elif self.frame_names is None:
            self.frame_names = [f"{i:05d}" for i in range(len(self.frames))]

        self._trinary_masks = [self._trinary(m) for m in self.masks_raw]
        d = np.stack(self.depths_raw)
        self.depths_min = float(d.min())
        self.depths_max = float(d.max())
        return self

    # --- per-frame accessors ------------------------------------------------

    @property
    def num_frames(self) -> int:
        return len(self.frames)

    @property
    def image_size(self) -> Tuple[int, int]:
        """(H, W)"""
        return self.frames[0].shape[:2]

    def _load_depth(self, name: str) -> np.ndarray:
        """disparity npy -> depth, median filtered 11x11."""
        from scipy.ndimage import median_filter

        disp = np.load(f"{self.depth_dir}/{name}.npy")
        depth = 1.0 / np.clip(disp, 1e-6, 1e6)
        return median_filter(depth.astype(np.float32), size=11)

    def _load_loss_depth(self, name: str) -> np.ndarray:
        """Raw depth-loss GT npy (`<name>_pred.npy` or `<name>.npy`), untouched."""
        for f in (f"{name}_pred.npy", f"{name}.npy"):
            p = os.path.join(self.loss_depth_dir, f)
            if os.path.isfile(p):
                return np.load(p).astype(np.float32)
        raise FileNotFoundError(f"no loss-depth npy for frame {name} in {self.loss_depth_dir}")

    def _load_dino(self, name: str) -> np.ndarray:
        """Per-frame DINO feature image, png/jpg / 255."""
        import imageio.v2 as imageio

        for ext in (".png", ".jpg"):
            p = os.path.join(self.dino_dir, name + ext)
            if os.path.isfile(p):
                return np.asarray(imageio.imread(p), np.float32)[..., :3] / 255.0
        raise FileNotFoundError(f"no dino image for frame {name} in {self.dino_dir}")

    def get_dino(self, i: int) -> Optional[np.ndarray]:
        return None if self.dinos is None else self.dinos[i]

    def _load_mask(self, name: str) -> np.ndarray:
        import imageio.v2 as imageio

        m = np.asarray(imageio.imread(f"{self.mask_dir}/{name}.png"))
        return m.reshape(m.shape[0], m.shape[1], -1).max(axis=-1) > 0

    def _trinary(self, fg_mask: np.ndarray) -> np.ndarray:
        """+1 eroded fg / -1 eroded bg / 0 boundary."""
        from scipy.ndimage import binary_erosion

        r = self.mask_erosion_radius
        struct = np.ones((r, r), bool)
        fg_e = binary_erosion(fg_mask, structure=struct)
        bg_e = binary_erosion(~fg_mask, structure=struct)
        out = np.zeros(fg_mask.shape, np.float32)
        out[bg_e] = -1.0
        out[fg_e] = 1.0
        return out

    def get_depth(self, i: int) -> np.ndarray:
        """Globally renormalised depth in [range_min, range_max]."""
        d = self.depths_raw[i]
        span = self.depths_max - self.depths_min
        if span <= 0:  # constant-depth clip: map everything to range_min
            return np.full_like(d, self.depth_range_min)
        return (d - self.depths_min) / span * (
            self.depth_range_max - self.depth_range_min
        ) + self.depth_range_min

    def get_loss_depth(self, i: int) -> np.ndarray:
        """Depth-loss ground truth: the raw depth when a `loss_depth_dir` is
        present, else the renormalised lifting depth."""
        if self.loss_depths is not None:
            return self.loss_depths[i]
        return self.get_depth(i)

    def get_mask(self, i: int) -> np.ndarray:
        return self._trinary_masks[i]

    def load_target_tracks(
        self, q: int, targets: List[int], dim: int = 1, rows: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """[N, T, 4] (dim=1) or [T, N, 4] (dim=0) tracks of query frame q.

        rows: optional [K] row subset applied per target before the stack,
        so only the kept rows are ever stacked.

        Aliasing contract: the per-target `np.asarray(..., np.float32)`
        views may alias the in-memory `self.tracks` store when those arrays
        are float32 already; the final `np.stack` always copies, so the
        returned array never aliases the store and is safe to mutate."""
        if self.tracks is not None:
            arrs = [np.asarray(self.tracks[(q, t)], np.float32) for t in targets]
        else:
            qn = self.frame_names[q]
            arrs = [
                np.asarray(np.load(f"{self.tracks_dir}/{qn}_{self.frame_names[t]}.npy"), np.float32)
                for t in targets
            ]
        if rows is not None:
            arrs = [a[rows] for a in arrs]
        return np.stack(arrs, axis=dim)

    def _num_tracks(self, q: int) -> int:
        """Row count of query frame q's track arrays."""
        if self.tracks is not None:
            return len(self.tracks[(q, q)])
        qn = self.frame_names[q]
        return len(np.load(f"{self.tracks_dir}/{qn}_{self.frame_names[q]}.npy", mmap_mode="r"))

    # --- lifting ------------------------------------------------------------

    def get_tracks_3d(self, num_samples: int, extract_fg: bool = True,
                      rng: Optional[np.random.RandomState] = None):
        """Sample tracks per query frame and lift them to 3D.

        Returns (tracks_3d [N, T, 3], visibles, invisibles, confidences
        [N, T], colors [N, 3]). `rng.choice` runs before each query frame's
        tracks are loaded, in the JAX package's order.
        """
        rng = rng or np.random.RandomState(0)
        T = self.num_frames
        idcs = list(range(T))
        depths = np.stack([self.get_depth(i) for i in idcs])
        masks = np.stack([self.get_mask(i) for i in idcs])
        mask_val = 1.0 if extract_fg else -1.0
        fg_masks = (masks == mask_val).astype(np.float32)
        thresh = 0.9 if extract_fg else 0.99

        per_q = int(np.ceil(num_samples / T))
        outs = []
        cur = 0
        for q in idcs:
            n_tr = self._num_tracks(q)
            nsel = int(min(per_q, num_samples - cur, n_tr))
            if nsel <= 0:
                break
            rows = rng.choice(n_tr, nsel, replace=False) if nsel < n_tr else None
            tr = self.load_target_tracks(q, idcs, rows=rows)  # [nsel, T, 4]
            cur += len(tr)
            outs.append(self._lift_query(q, tr, depths, fg_masks, extract_fg, thresh))
        cat = lambda i: np.concatenate([o[i] for o in outs], axis=0)
        return cat(0), cat(2), cat(3), cat(4), cat(1)

    def _lift_query(self, q, tracks_2d, depths, fg_masks, extract_fg, thresh):
        T, H, W = depths.shape
        xy = tracks_2d[..., :2].swapaxes(0, 1)  # [T, N, 2]
        occs = tracks_2d[..., 2].swapaxes(0, 1)
        dists = tracks_2d[..., 3].swapaxes(0, 1)
        visibles, invisibles, confidences = parse_tapir_track_info(occs, dists)

        track_depths = np.stack([bilinear_sample(depths[t], xy[t]) for t in range(T)])  # [T, N]
        xy_norm = normalize_xy(xy.reshape(-1, 2), W, H).reshape(T, -1, 2)
        tracks_3d = np.concatenate([xy_norm, track_depths[..., None]], axis=-1)

        in_mask = np.stack([bilinear_sample(fg_masks[t], xy[t]) == 1.0 for t in range(T)])
        visibles = visibles & in_mask
        invisibles = invisibles & in_mask
        confidences = confidences * in_mask

        valid = in_mask[q].copy()
        vc = visibles.sum(0)
        valid &= vc >= min(int(thresh * T), np.quantile(vc.astype(np.float32), thresh))
        cc = (confidences > 0.5).sum(0)
        valid &= cc >= min(int(thresh * T), np.quantile(cc.astype(np.float32), thresh))

        colors = bilinear_sample(self.frames[q], xy[q])
        return (
            tracks_3d[:, valid].swapaxes(0, 1),  # [Nv, T, 3]
            colors[valid],
            visibles[:, valid].swapaxes(0, 1),
            invisibles[:, valid].swapaxes(0, 1),
            confidences[:, valid].swapaxes(0, 1),
        )

    def extend_track3d(self, track3d: np.ndarray, grid_size: int = 64, margin: float = 0.25):
        """Pad the bg point set with left / right frame-border grids that
        follow the mean track translation.

        track3d: [N, T, 3]. Returns (points_3d_seq [M, T, 3], colors [M, 3]).
        """
        H, W = self.image_size
        out_pts, out_cols = [], []
        for side, frame_idx, anchor in (("left", 0, 0), ("right", track3d.shape[1] - 1, -1)):
            if side == "left":
                xs = np.linspace(0, int((W - 1) * margin), W // grid_size)
            else:
                xs = np.linspace(int((W - 1) * (1 - margin)), W - 1, W // grid_size)
            ys = np.linspace(0, H - 1, H // int(grid_size * margin))
            gx, gy = np.meshgrid(xs, ys, indexing="ij")
            px = np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)

            depth = bilinear_sample(self.get_depth(frame_idx), px)
            colors = bilinear_sample(self.frames[frame_idx], px)
            mask_at = bilinear_sample(self.get_mask(frame_idx), px)
            valid = mask_at != 1.0  # exclude fg

            p2 = normalize_xy(px, W, H)
            p3 = np.concatenate([p2[valid], depth[valid][:, None]], axis=-1)
            ref = track3d[:, anchor : anchor + 1] if anchor == 0 else track3d[:, -1:]
            delta = track3d - ref
            seq = p3[:, None] + delta.mean(axis=0, keepdims=True)  # [M, T, 3]
            out_pts.append(seq)
            out_cols.append(colors[valid])
        return np.concatenate(out_pts, axis=0), np.concatenate(out_cols, axis=0)


# depth -> point / normal helpers (the reference's `video3Dflow/utils.py`
# ships them unused; kept as the JAX package keeps them)


def depth_to_points_world(depth: np.ndarray, intrinsic: np.ndarray, extrinsic: np.ndarray) -> np.ndarray:
    """Unproject a depth image [H, W] to world points [H*W, 3]: pixel
    centres on the (size - 1)-normalised grid, K^-1 backprojection, then the
    inverse of the 4x4 world->camera extrinsic."""
    H, W = depth.shape
    x = np.arange(W, dtype=np.float32) / (W - 1)
    y = np.arange(H, dtype=np.float32) / (H - 1)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    cam_xy = np.stack([xx * (W - 1), yy * (H - 1)], axis=-1) * depth[..., None]
    cam_xyz = np.concatenate([cam_xy, depth[..., None]], axis=-1)
    cam_xyz = cam_xyz.reshape(-1, 3) @ np.linalg.inv(intrinsic.T)
    ones = np.ones((cam_xyz.shape[0], 1), cam_xyz.dtype)
    world = np.concatenate([cam_xyz, ones], axis=-1) @ np.linalg.inv(extrinsic).T
    return world[:, :3]


def points_to_normals(xyz: np.ndarray) -> np.ndarray:
    """Central-difference unit normals of an organised point image
    [H, W, 3], with a one-pixel zero border."""
    lr = xyz[1:-1, 2:, :] - xyz[1:-1, :-2, :]
    bt = xyz[:-2, 1:-1, :] - xyz[2:, 1:-1, :]
    n = np.cross(lr, bt)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    out = np.zeros_like(xyz)
    out[1:-1, 1:-1, :] = n
    return out


def normal_from_depth_image(depth: np.ndarray, intrinsic: np.ndarray, extrinsic: np.ndarray) -> np.ndarray:
    """Normals [H, W, 3] of a depth image through its world points."""
    return points_to_normals(depth_to_points_world(depth, intrinsic, extrinsic).reshape(*depth.shape, 3))
