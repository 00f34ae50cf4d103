"""Tutorial: fit a 2D image with Gaussian splatting, stage by stage, on the
PyTorch/CUDA port.

Counterpart of `examples/gs_2d.py` (the dptr tutorial `gs_2d.py`): random
colourful Gaussians and Adam, driven through the *staged* rasterization
API (projection -> cov3d -> EWA -> rasterize) rather than the fused
`render_gaussians`, because showing the stages is the point of the
tutorial. It draws JAX's initial values (`train/prng.py`, from the same
key) and steps optax's `adam(lr)` (`train/optim.adam_update` with eps
1e-8), so both tutorials fit the same numbers.

Every Gaussian sits at depth 1.0 through the whole fit (the orthographic
projection gives z no gradient, so Adam never moves it): each tile's blend
order is the tie rule alone, Gaussian index.

Run:  python examples/torch_gs_2d.py [--points 10000] [--iters 2000] [--size 256]
      python examples/torch_gs_2d.py --device cpu --points 300 --iters 50 --size 32
The default device is cuda (the port's kernels); `--device cpu` runs their
plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from splatter_a_video_tpu_torch.device import resolve_device
from splatter_a_video_tpu_torch.ops import projection, quaternion, rasterize
from splatter_a_video_tpu_torch.train import losses, optim, prng

ADAM = optim.OptimConfig(eps=1e-8)   # optax.adam's b1, b2 and eps


def make_target(size: int) -> np.ndarray:
    """A colorful procedural target (the reference fits its logo png)."""
    y, x = np.mgrid[0:size, 0:size] / size
    r = 0.5 + 0.5 * np.sin(6.28 * (x * 2 + y))
    g = 0.5 + 0.5 * np.cos(6.28 * (x - y * 3))
    b = ((x - 0.5) ** 2 + (y - 0.5) ** 2) < 0.16
    return np.stack([r, g, b.astype(np.float64)], axis=-1).astype(np.float32)


def init_params(key: torch.Tensor, n: int, device="cpu"):
    """Random raw attributes, JAX's draws from `key`; activations keep them
    in range (README.md:165-172): |scale|+eps, normalized quaternion,
    sigmoid opacity and color."""
    ks = prng.split(key, 5)
    xyz = prng.uniform(ks[0], (n, 3), -1.0, 1.0)
    xyz[:, 2] = 1.0
    params = {
        "xyz": xyz,
        "scale": prng.uniform(ks[1], (n, 3)) * 0.5,
        "rotate": prng.normal(ks[2], (n, 4)),
        "opacity": prng.normal(ks[3], (n,)),
        "rgb": prng.normal(ks[4], (n, 3)),
    }
    return {k: v.to(device) for k, v in params.items()}


def project_2d(params, cfg: rasterize.RasterizeConfig, extr) -> rasterize.Projected:
    """The stages before the blend, one stage per line (cf. dptr's
    project_point / compute_cov3d / ewa_project chain)."""
    scale = params["scale"].abs() * 0.02 + 1e-8
    opacity = torch.sigmoid(params["opacity"])
    rgb = torch.sigmoid(params["rgb"])

    uv, depth = projection.project_ortho(params["xyz"], extr, cfg.width, cfg.height)
    visible = depth != 0
    cov3d = quaternion.build_cov3d(scale, params["rotate"], visible)
    max_r = projection.max_radius_for_tile_cap(cfg.max_tiles_per_gaussian, cfg.block)
    # the rect follows the opacity but passes it no gradient (JAX's stop_gradient)
    conic, radius, tiles, rmin, rmax = projection.ewa_ortho(
        cov3d, extr, uv, cfg.width, cfg.height, visible, cfg.block, max_r,
        cfg.rect_mode, opacity.detach(),
    )
    return rasterize.Projected(uv, depth, conic, radius, tiles, rmin, rmax, opacity,
                               {"rgb": (rgb, 1.0, True)})


def render_2d(params, cfg: rasterize.RasterizeConfig, extr) -> torch.Tensor:
    """The staged pipeline: `project_2d`, then the blend (dptr's
    sort_gaussian / alpha_blending). Returns the [H, W, 3] image."""
    return rasterize.rasterize(*project_2d(params, cfg, extr), cfg).features["rgb"]


def loss_and_grads(params, cfg: rasterize.RasterizeConfig, extr, gt):
    """(L1 loss, image, {name: gradient}) of the render against `gt`."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    img = render_2d(leaves, cfg, extr)
    loss = losses.l1_loss(img, gt)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), img.detach(), dict(zip(leaves, grads))


def step(params, opt_state: optim.AdamState, cfg: rasterize.RasterizeConfig, extr, gt, lr: torch.Tensor):
    """One Adam step on the L1 loss: (params, opt_state, loss before it)."""
    loss, _, grads = loss_and_grads(params, cfg, extr, gt)
    params, opt_state = optim.adam_update(ADAM, params, grads, opt_state, lr=lr)
    return params, opt_state, loss


def fit(target: np.ndarray, num_points: int, iters: int, lr: float = 0.01,
        seed: int = 0, log_every: int = 200, max_intersections: int = 1 << 18, device="cuda"):
    """Fit `num_points` Gaussians to `target` [H, W, 3] for `iters` Adam
    steps: (params, final image, [(iteration, loss, psnr after it)])."""
    dev = resolve_device(device)
    H, W = target.shape[:2]
    cfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=max_intersections)
    extr = torch.eye(3, 4, device=dev)
    gt = torch.as_tensor(target, device=dev)
    params = init_params(prng.key(seed), num_points, dev)
    opt_state = optim.adam_init(params)
    lr_t = torch.tensor(lr, dtype=torch.float32)

    history = []
    for i in range(iters):
        params, opt_state, loss = step(params, opt_state, cfg, extr, gt, lr_t)
        if i % log_every == 0 or i == iters - 1:
            with torch.no_grad():
                p = float(losses.psnr(render_2d(params, cfg, extr), gt))
            history.append((i, float(loss), p))
            print(f"iter {i:5d}  l1 {float(loss):.4f}  psnr {p:.2f}", flush=True)
    with torch.no_grad():
        img = render_2d(params, cfg, extr)
    return params, img, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=2_000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--out", type=str, default="out/torch_gs2d.png")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the port's kernels) or cpu")
    args = ap.parse_args(argv)

    target = make_target(args.size)
    _, img, history = fit(target, args.points, args.iters, args.lr, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        try:
            import imageio.v2 as imageio

            pair = np.concatenate([target, img.cpu().numpy()], axis=1)
            imageio.imwrite(args.out, (np.clip(pair, 0, 1) * 255).astype(np.uint8))
            print(f"wrote {args.out}")
        except ImportError:
            pass
    assert history[-1][2] > history[0][2], "no convergence"


if __name__ == "__main__":
    main()
