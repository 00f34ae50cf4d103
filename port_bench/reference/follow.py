"""The reference's run of a cell's first train steps and its density event.

`follow` starts from the program's initial scene, which `scene.py`'s own
initial scene holds by itself (`PERF.md` says why the steps do not start
from the reference's), and steps it itself: the same frame pairs and
track rows drawn from the fit's seed, the same ARAP draws, its own render,
losses, gradients and Adam. `event` computes one density event from the
program's state before it. Inputs come from the benchmark's clip.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import plain, prng


def frame_targets(clip, t: int, dev, need_mask: bool, need_dino: bool) -> dict:
    """The per-frame supervision: rgb, the lifting depth renormalised over
    the clip to [0.5, 2], the mask and the DINO stand-in."""
    lo = min(float(d.min()) for d in clip.depths)
    hi = max(float(d.max()) for d in clip.depths)
    d = torch.from_numpy(clip.depths[t]).to(dev)
    out = {"rgb": torch.from_numpy(clip.frames[t]).to(dev),
           "depth": (d - lo) / (hi - lo) * (2.0 - 0.5) + 0.5}
    if need_mask:
        out["mask"] = torch.from_numpy(clip.masks[t].astype(np.float32)).to(dev)
    if need_dino:
        out["dino"] = torch.from_numpy(clip.dinos[t]).to(dev)
    return out


class Batches:
    """Frame pairs (t1 = step mod T, t2 uniform) and track rows (a sample of
    the query frame's grid without replacement), each stream from its own
    `RandomState(seed)`."""

    def __init__(self, clip, seed: int, num_tracks: int):
        self.clip, self.P = clip, num_tracks
        self.pairs = np.random.RandomState(seed)
        self.rows = np.random.RandomState(seed)
        self.T = len(clip.frames)

    def next(self, step: int) -> dict:
        t1, t2 = step % self.T, int(self.pairs.randint(0, self.T))
        q = self.clip.tracks[(t1, t1)]
        n = q.shape[0]
        if n >= self.P:
            sel = self.rows.choice(n, self.P, replace=False)
            qp, tt, valid = q[sel, :2], self.clip.tracks[(t1, t2)][sel], np.ones((self.P,), bool)
        else:
            pad = self.P - n
            qp = np.concatenate([q[:, :2], np.zeros((pad, 2), np.float32)])
            tt = np.concatenate([self.clip.tracks[(t1, t2)], np.zeros((pad, 4), np.float32)])
            valid = np.arange(self.P) < n
        return {"t1": t1, "t2": t2, "query_px": qp.astype(np.float32), "target": tt.astype(np.float32),
                "valid": valid}


def render_inputs(p, alive, knots, cfg: dict, t1: int, t2: int):
    """The blend's per-Gaussian inputs of frame t1 with t2's positions as
    `track_gs`: (projection, positions at t1 and t2, features, bg, op mask,
    channel names and widths)."""
    r = cfg["recipe"]
    rc = r["raster"]
    T = cfg["num_frames"]
    W, H = cfg["frame_size"]
    pos1 = plain.position(p, knots, cfg["traj"], t1, T)
    pos2 = plain.position(p, knots, cfg["traj"], t2, T)
    rot = plain.rotation(p, t1, T)
    op = torch.sigmoid(p["opacity"][:, 0]) * alive
    extr = torch.eye(3, 4, device=pos1.device)
    pr = plain.project(pos1, rot, torch.exp(p["scaling"]), op, extr, W, H, rc["nearest"], rc["extent"],
                       rc["block"], rc["max_tiles_per_gaussian"])
    vis = pr.visible[:, None].to(torch.float32)
    groups = [("rgb", plain.sh_colour(torch.cat([p["features_dc"], p["features_rest"]], 1)) * vis,
               1.0 if rc["white_bg"] else 0.0, True),
              ("depth", pr.depth[:, None], rc["depth_bg"], True),
              ("track_gs", pos2, 0.0, False)]
    lc = r["loss"]
    if lc["train_render_attributes"] or lc["mask_attr_weight"] or lc["dino_attr_weight"]:
        for name in ("mask_attribute", "pos_poly_feat", "dino_attribute"):
            if name in p:
                v = p[name].reshape(p[name].shape[0], -1)
                groups.append((name, v if name == "pos_poly_feat" else torch.sigmoid(v), 0.0, False))
    feats = torch.cat([g[1] for g in groups], 1)
    dev = feats.device
    bg = torch.cat([torch.full((g[1].shape[1],), float(g[2]), device=dev) for g in groups])
    op_mask = torch.cat([torch.full((g[1].shape[1],), g[3], dtype=torch.bool, device=dev) for g in groups])
    widths = [(g[0], g[1].shape[1]) for g in groups]
    return pr, pos1, pos2, feats, bg, op_mask, widths


def step_grads(p0: Dict[str, torch.Tensor], alive, knots, batch: dict, frames: dict, key, cfg: dict,
               half: bool = False, drop_depth_grad: bool = False):
    """(loss, gradients of every attribute) of one train step."""
    r = cfg["recipe"]
    rc, lc = r["raster"], r["loss"]
    W, H = cfg["frame_size"]
    T = cfg["num_frames"]
    p = {k: v.detach().requires_grad_(True) for k, v in p0.items()}
    pr, pos1, pos2, feats, bg, op_mask, widths = render_inputs(p, alive, knots, cfg, batch["t1"], batch["t2"])
    bins = plain.bin_pairs(pr, W, H, rc["block"], rc["max_tiles_per_gaussian"], cfg["max_intersections"])
    leaves = [x.detach().requires_grad_(True) for x in (pr.uv, pr.conic, pr.opacity, feats)]
    image = plain.blend(bins, *(x.detach() for x in leaves), bg, op_mask, W, H, rc["block"])
    image.requires_grad_(True)
    feat, off = {}, 0
    for name, c in widths:
        feat[name] = image[..., off:off + c]
        off += c
    dev = image.device
    b = {**frames, "t1": batch["t1"], "t2": batch["t2"],
         "query_px": torch.from_numpy(batch["query_px"]).to(dev),
         "target": torch.from_numpy(batch["target"]).to(dev),
         "valid": torch.from_numpy(batch["valid"]).to(dev)}
    loss_img, _ = plain.image_losses(feat, b, lc, H, W, T, half=half)
    (dimg,) = torch.autograd.grad(loss_img, image)
    if drop_depth_grad:                     # a planted fault: the depth channel's gradient lost
        dimg[..., 3] = 0.0
    plain.blend(bins, *leaves, bg, op_mask, W, H, rc["block"], grad_image=dimg)
    outs = [pr.uv, pr.conic, pr.opacity, feats]
    grads = [l.grad if l.grad is not None else torch.zeros_like(l) for l in leaves]
    loss = loss_img.detach()
    if lc["arap_weight"]:
        term = lc["arap_weight"] * plain.arap(pos1, pos2, alive, key, lc["arap_knn"], lc["arap_sample_num"])
        outs.append(term)
        grads.append(torch.ones_like(term))
        loss = loss + term.detach()
    torch.autograd.backward(outs, grads)
    return loss, {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in p.items()}


def follow(init: dict, clip, cfg: dict, seed: int, steps: int, device, half: bool = False,
           drop_depth_grad: bool = False) -> dict:
    """`steps` train steps from the program's initial state `init` (params,
    alive, knots on the host): each step's loss, the first step's gradient
    norm per attribute and each attribute's change after the last step."""
    dev = torch.device(device)
    lc = cfg["recipe"]["loss"]
    p = {k: v.to(dev) for k, v in init["params"].items()}
    p_start = {k: v.clone() for k, v in p.items()}
    alive = init["alive"].to(dev)
    knots = init["knots"].to(dev) if init["knots"] is not None else None
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    count, key = 0, prng.key(seed)
    batches = Batches(clip, seed, cfg["recipe"]["fit"]["num_track_samples"])
    need_mask, need_dino = bool(lc["mask_attr_weight"]), bool(lc["dino_attr_weight"])
    losses, pairs, g1 = [], [], None
    for s in range(steps):
        batch = batches.next(s)
        pairs.append((batch["t1"], batch["t2"]))
        ks = prng.split(key)
        key, sub = ks[0], ks[1]
        frames = frame_targets(clip, batch["t1"], dev, need_mask, need_dino)
        loss, grads = step_grads(p, alive, knots, batch, frames, sub, cfg, half, drop_depth_grad)
        if g1 is None:
            g1 = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        p, mu, nu, count = plain.adam(cfg["recipe"]["optim"], p, grads, mu, nu, count)
        losses.append(float(loss))
        del grads
    change = {k: float(torch.linalg.vector_norm(p[k] - p_start[k])) for k in p}
    return {"losses": losses, "grad_norms": g1, "change_norms": change, "pairs": pairs}


def event(pre: dict, cfg: dict, device) -> dict:
    """The density event on the program's state before it: (params, alive,
    used slots, counts)."""
    dev = torch.device(device)
    params = {k: v.to(dev) for k, v in pre["params"].items()}
    cap = pre["alive"].shape[0]
    noise = prng.normal(prng.split(pre["key"])[1], (cap, 3)).to(dev)
    dc = {**cfg["recipe"]["density"], "densify_start_iter": cfg["densify_start_iter"]}
    new, alive, used, counts = plain.density_event(
        params, pre["alive"].to(dev), pre["accum"].to(dev), pre["denom"].to(dev), pre["step"], dc, noise)
    return {"params": new, "alive": alive, "used": used, "counts": counts}
