"""Tutorial: render a 3D Gaussian scene along an orbiting camera path, on
the PyTorch/CUDA port.

Counterpart of `examples/gs_3d.py` (the dptr tutorial `gs_3d.py`): build a
colorful 3D point cloud (a torus), splat it through the perspective
pipeline with the fov-parametrized legacy renderer surface
(`models/legacy_render.GaussianSplattingRender.render_iter`), and write an
orbit of frames. Doubles as a perspective-path smoke check. The inputs are
the JAX tutorial's, drawn from the same numpy seeds.

Run:  python examples/torch_gs_3d.py [--points 20000] [--frames 12] [--size 256]
      python examples/torch_gs_3d.py --device cpu --points 2000 --frames 3 --size 64
The default device is cuda (the port's kernels); `--device cpu` runs their
plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from splatter_a_video_tpu_torch.device import resolve_device
from splatter_a_video_tpu_torch.models import camera, legacy_render
from splatter_a_video_tpu_torch.ops.quaternion import quat_normalize

FOV = math.pi / 3


def make_torus(n: int, seed: int = 0):
    """Colorful torus point cloud: color = position-derived rainbow."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    R, r = 0.6, 0.22
    x = (R + r * np.cos(v)) * np.cos(u)
    y = (R + r * np.cos(v)) * np.sin(u)
    z = r * np.sin(v)
    pos = np.stack([x, y, z], axis=1).astype(np.float32)
    col = np.stack(
        [0.5 + 0.5 * np.cos(u), 0.5 + 0.5 * np.sin(v), 0.5 + 0.5 * np.sin(u)],
        axis=1,
    ).astype(np.float32)
    return pos, col


def colors_to_shs(col: np.ndarray) -> np.ndarray:
    """DC-only SH so eval_sh(deg 0) reproduces the color: the RGB2SH
    convention (color - 0.5) / C0 (`gaussian_utils.py` / `sh_utils`)."""
    C0 = 0.28209479177387814
    shs = np.zeros((col.shape[0], 16, 3), np.float32)
    shs[:, 0] = (col - 0.5) / C0
    return shs


def orbit_world_view(theta: float, radius: float = 2.5, height: float = 0.8):
    """Row-vector (transposed) world->view transform of a camera orbiting
    the origin — the storage convention of the legacy Camera
    (`camera.py:141+`)."""
    eye = np.array(
        [radius * math.cos(theta), radius * math.sin(theta), height]
    )
    R = camera.look_at_rotation(
        eye.astype(np.float32), np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0], np.float32)
    )
    w2c = np.eye(4, dtype=np.float32)  # R rows are camera axes (w2c)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c.T  # stored transposed


def render_orbit(points: int, frames: int, size: int, device="cuda"):
    """`render_iter`'s output dict for each of `frames` views on the orbit
    (each view draws new random rotations, as the JAX tutorial does), on
    `device`."""
    dev = resolve_device(device)
    pos, col = make_torus(points)
    rng = np.random.RandomState(1)
    render = legacy_render.GaussianSplattingRender()
    render.active_sh_degree = 0
    position = torch.from_numpy(pos).to(dev)
    shs = torch.from_numpy(colors_to_shs(col)).to(dev)
    outs = []
    with torch.no_grad():
        for f in range(frames):
            theta = 2 * math.pi * f / frames
            outs.append(render.render_iter(
                FovX=FOV, FovY=FOV, height=size, width=size,
                world_view_transform=torch.from_numpy(orbit_world_view(theta)).to(dev),
                full_proj_transform=None,
                camera_center=torch.zeros(3, device=dev),
                position=position,
                opacity=torch.full((points,), 0.8, device=dev),
                scaling=torch.full((points, 3), 0.02, device=dev),
                rotation=quat_normalize(torch.from_numpy(rng.randn(points, 4).astype(np.float32)).to(dev)),
                shs=shs,
            ))
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", type=str, default="out/torch_gs3d")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the port's kernels) or cpu")
    args = ap.parse_args(argv)

    frames = []
    for f, out in enumerate(render_orbit(args.points, args.frames, args.size, args.device)):
        img = np.clip(out["rgb"].cpu().numpy(), 0, 1)
        frames.append(img)
        print(
            f"frame {f:02d}  visible {int(out['visibility'].sum())}"
            f"  mean {img.mean():.3f}",
            flush=True,
        )

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        try:
            import imageio.v2 as imageio

            for f, img in enumerate(frames):
                imageio.imwrite(
                    os.path.join(args.out, f"{f:03d}.png"),
                    (img * 255).astype(np.uint8),
                )
            print(f"wrote {len(frames)} frames to {args.out}")
        except ImportError:
            pass
    # smoke assertion: the torus is visible and moves across frames
    assert all(f.min() < 0.95 for f in frames), "nothing rendered"
    assert np.abs(frames[0] - frames[len(frames) // 2]).max() > 0.1


if __name__ == "__main__":
    main()
