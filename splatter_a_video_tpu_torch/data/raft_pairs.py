"""RAFT-exhaustive pair sampling for the legacy Omnimotion-style datasets
(counterpart of `splatter_a_video_tpu/data/raft_pairs.py`, numpy only,
drawing from its `RandomState` in the same order).

`RaftExhaustivePairs.sample(idx)` draws a frame pair (id1 by step or by a
per-frame error file, id2 by the flow-stats weights biased 0.5 toward the
neighbours, inside a max-interval curriculum) and `num_pts` pixels under
the cycle / occlusion masks (uniform, or weighted by an error map or a
count map), with cos pair weights and a random direction swap that zeroes
the non-covisible weights; `full_grids` adds the coordinate grids and both
images. Image 2 is sampled by `_bilinear` (align_corners=True, zero
padding). `load_ba_depth` reads a `BA_full/*.npz` depth and pose bundle.

On-disk layout:
  color/*.png|jpg                frames
  raft_exhaustive/{n1}_{n2}.npy  [H, W, 2] forward flow
  raft_masks/{n1}_{n2}.png       [H, W, 3] cycle/occlusion masks (255 = on)
  flow_stats.json                {name1: {name2: count}}
  count_maps/*.png               optional visit counts
  BA_full/*.npz                  optional depth/pose bundle (point variant)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def get_sample_weights(flow_stats: Dict) -> Dict:
    """Per-source-frame normalized pair counts (`raft.py:14-21`)."""
    out = {}
    for k, row in flow_stats.items():
        total = float(np.array(list(row.values())).sum())
        out[k] = {j: v / total for j, v in row.items()}
    return out


def _imread(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def _bilinear(img: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Sample img [H, W, C] at float pixel coords pts [N, 2] (x, y),
    matching `F.grid_sample(..., align_corners=True)` with its default
    padding_mode='zeros': out-of-frame corner taps contribute 0, so points
    flowing past the border fade to black exactly as in the reference
    (`loaders/raft.py` pair supervision)."""
    H, W = img.shape[:2]
    x = pts[:, 0].astype(np.float64)
    y = pts[:, 1].astype(np.float64)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def tap(yy, xx):
        ok = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[:, None]
        v = img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(np.float64)
        return np.where(ok, v, 0.0)

    a, b = tap(y0, x0), tap(y0, x1)
    c, d = tap(y1, x0), tap(y1, x1)
    return ((a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy)


def load_ba_depth(base_dir: str) -> Dict:
    """Parse a `BA_full/*.npz` bundle: depth = 1/(disp+1e-8) normalized by
    the global max, per-frame c2w poses and a constant K
    (`point.py:27-70`; the reference asserts K is shared across frames)."""
    result_dir = os.path.join(base_dir, "BA_full")
    files = sorted(
        f for f in os.listdir(result_dir) if f.endswith(".npz")
    )
    c2ws, Ks, depths = [], [], []
    K0 = None
    for i, name in enumerate(files):
        assert int(os.path.splitext(name)[0]) == i, name
        info = np.load(os.path.join(result_dir, name))
        depth = 1.0 / (info["disp"] + 1e-8)
        c2w = np.eye(4)
        c2w[:3, :3] = info["R"]
        c2w[:3, 3] = info["t"]
        K = np.eye(4)
        K[:3, :3] = info["K"]
        if K0 is None:
            K0 = K
        else:
            assert np.sum(np.abs(K0 - K)) < 1e-5, "intrinsics drift"
        c2ws.append(c2w)
        Ks.append(K)
        depths.append(depth)
    depths = np.stack(depths, axis=0)
    depths = depths / depths.max()
    return {"c2w": c2ws, "K": Ks, "depth": depths}


@dataclass
class RaftPairsConfig:
    data_dir: str
    num_imgs: int = 250
    num_pts: int = 256
    max_interval: Optional[int] = None   # None = num_imgs - 1
    use_error_map: bool = False
    use_count_map: bool = False
    error_map_dir: Optional[str] = None  # cached predicted-flow dir
    full_grids: bool = False             # PointRAFT variant: emit pts*_all
    seed: int = 0


class RaftExhaustivePairs:
    """Seeded sampler over precomputed exhaustive RAFT flow.

    `sample(idx)` mirrors one `__getitem__` of the reference datasets;
    `set_max_interval`/`increase_max_interval_by` mirror the curriculum
    hooks the trainer calls (`src/train.py:201`,
    `create_training_dataset.py:134-141`).
    """

    def __init__(self, cfg: RaftPairsConfig):
        self.cfg = cfg
        self.img_dir = os.path.join(cfg.data_dir, "color")
        self.flow_dir = os.path.join(cfg.data_dir, "raft_exhaustive")
        names = sorted(os.listdir(self.img_dir))
        self.num_imgs = min(cfg.num_imgs, len(names))
        self.img_names: List[str] = names[: self.num_imgs]
        first = _imread(os.path.join(self.img_dir, names[0]))
        self.h, self.w = first.shape[:2]
        g = np.stack(
            np.meshgrid(np.arange(self.w), np.arange(self.h)), axis=-1
        )
        self.grid = g.astype(np.float64)  # [H, W, 2] (x, y)
        with open(os.path.join(cfg.data_dir, "flow_stats.json")) as f:
            self.sample_weights = get_sample_weights(json.load(f))
        self._max_interval = (
            cfg.max_interval if cfg.max_interval else self.num_imgs - 1
        )
        self.rng = np.random.RandomState(cfg.seed)

    def __len__(self) -> int:  # infinite stream (`raft.py:45-46`)
        return self.num_imgs * 100000

    def set_max_interval(self, v: int) -> None:
        self._max_interval = min(v, self.num_imgs - 1)

    def increase_max_interval_by(self, inc: int) -> None:
        self.set_max_interval(self._max_interval + inc)

    # -- internals ---------------------------------------------------------

    def _pick_pair(self, idx: int):
        cfg = self.cfg
        err_file = os.path.join(cfg.data_dir, "flow_error.txt")
        if os.path.exists(err_file):
            err = np.loadtxt(err_file)
            id1 = int(self.rng.choice(self.num_imgs, p=err / err.sum()))
        else:
            id1 = idx % self.num_imgs
        name1 = self.img_names[id1]
        mi = min(self._max_interval, self.num_imgs - 1)
        cands = sorted(self.sample_weights[name1].keys())
        cands = cands[max(id1 - mi, 0) : min(id1 + mi, self.num_imgs - 1)]
        id2s = np.array([self.img_names.index(n) for n in cands])
        w = np.array([self.sample_weights[name1][n] for n in cands])
        w = w / w.sum()
        w[np.abs(id2s - id1) <= 1] = 0.5  # bias to i±1 (`raft.py:71-75`)
        w = w / w.sum()
        name2 = self.rng.choice(cands, p=w)
        return id1, int(self.img_names.index(name2)), mi

    def _pixel_select(self, mask, error_map, name1):
        cfg = self.cfg
        n_on = int(mask.sum())
        replace = n_on < cfg.num_pts
        if error_map is not None:
            sel = error_map[mask]
            p = sel / sel.sum()
            ids_e = self.rng.choice(n_on, cfg.num_pts, replace=replace, p=p)
            ids_r = self.rng.choice(n_on, cfg.num_pts, replace=replace)
            return self.rng.choice(
                np.concatenate([ids_e, ids_r]), cfg.num_pts, replace=False
            )
        if cfg.use_count_map:
            cm_path = os.path.join(
                cfg.data_dir, "count_maps",
                os.path.splitext(name1)[0] + ".png",
            )
            cm = _imread(cm_path).astype(np.float64)
            p = 1.0 / np.sqrt(cm + 1.0)
            p = p[mask]
            p = p / p.sum()
            return self.rng.choice(n_on, cfg.num_pts, replace=replace, p=p)
        return self.rng.choice(n_on, cfg.num_pts, replace=replace)

    def _error_map(self, id1: int, name1: str):
        cfg = self.cfg
        if not (cfg.use_error_map and cfg.error_map_dir):
            return None
        preds = sorted(os.listdir(cfg.error_map_dir))
        if not preds:
            return None
        pred_name = preds[id1]
        assert name1 + "_" in pred_name
        pred = np.load(os.path.join(cfg.error_map_dir, pred_name))
        sup = np.load(os.path.join(self.flow_dir, pred_name))
        err = np.linalg.norm(pred - sup, axis=-1)
        # 5x5 gaussian blur (sigma from kernel size, cv2 convention)
        try:
            import scipy.ndimage as ndi

            err = ndi.gaussian_filter(err, sigma=1.1, truncate=2.0)
        except ImportError:
            pass
        return err

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        id1, id2, mi = self._pick_pair(idx)
        name1, name2 = self.img_names[id1], self.img_names[id2]
        interval = abs(id1 - id2)

        img1 = _imread(os.path.join(self.img_dir, name1)) / 255.0
        img2 = _imread(os.path.join(self.img_dir, name2)) / 255.0
        flow = np.load(os.path.join(self.flow_dir, f"{name1}_{name2}.npy"))
        masks = (
            _imread(
                os.path.join(
                    cfg.data_dir, "raft_masks", f"{name1}_{name2}.png"
                )
            )
            / 255.0
        )
        cyc = masks[..., 0] > 0
        occ = masks[..., 1] > 0
        mask = np.ones_like(cyc) if interval == 1 else (cyc | occ)
        invalid = mask.sum() == 0
        if invalid:
            mask = np.ones_like(cyc)

        sel = self._pixel_select(mask, self._error_map(id1, name1), name1)
        coord2 = self.grid + flow
        pts1 = self.grid[mask][sel].astype(np.float32)
        pts2 = coord2[mask][sel].astype(np.float32)
        covis = cyc[mask][sel].astype(np.float32)[:, None]
        pair_weight = np.cos((interval - 1.0) / mi * np.pi / 2)
        weights = np.ones_like(covis) * pair_weight
        gt_rgb1 = img1[mask][sel].astype(np.float32)
        gt_rgb2 = _bilinear(img2, pts2).astype(np.float32)
        if invalid:
            weights = np.zeros_like(weights)

        # random direction swap; swapped pairs lose occluded supervision
        # (`raft.py:149-151`)
        if self.rng.choice([0, 1]):
            id1, id2 = id2, id1
            pts1, pts2 = pts2, pts1
            gt_rgb1, gt_rgb2 = gt_rgb2, gt_rgb1
            weights = np.where(covis == 0.0, 0.0, weights)

        out = {
            "ids1": np.int32(id1),
            "ids2": np.int32(id2),
            "pts1": pts1,
            "pts2": pts2,
            "gt_rgb1": gt_rgb1,
            "gt_rgb2": gt_rgb2,
            "weights": weights.astype(np.float32),
            "covisible_mask": covis,
            "gt_img": img1.astype(np.float32).transpose(2, 0, 1),
            "gt_flow": (
                flow / np.array([self.w, self.h])[None, None] * 2
            ).astype(np.float32).transpose(2, 0, 1),
        }
        if cfg.full_grids:  # PointRAFT variant (`point.py:278-287`)
            out["pts1_all"] = self.grid.astype(np.float32)
            out["pts2_all"] = coord2.astype(np.float32)
            out["gt_img1"] = img1.astype(np.float32)
            out["gt_img2"] = img2.astype(np.float32)
        return out
