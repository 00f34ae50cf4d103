"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode: without a CUDA device these tests skip.
On a GPU machine (without JAX, so without the JAX tests' conftest):
`python -m pytest --noconftest tests/test_torch_kernels.py -q`.
The kernels are built with --fmad=false and repeat the plain versions'
arithmetic, so results are compared for equality."""

import numpy as np
import pytest
import torch

from splatter_a_video_tpu_torch.ops import binning, projection, quaternion, rasterize_gpu

# evaluated when each test runs, not at import
pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="CUDA kernels need an NVIDIA GPU"
)

W, H = 200, 120


def projected(seed, n=3000, block=(16, 16)):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.cat([torch.rand(n, 2, generator=g) * 1.8 - 0.9,
                     torch.rand(n, 1, generator=g) * 1.5 + 0.5], 1)
    scale = torch.exp(torch.rand(n, 3, generator=g) * 1.5 - 4.0)
    quat = torch.randn(n, 4, generator=g)
    xyz, scale, quat = xyz.cuda(), scale.cuda(), quat.cuda()
    extr = torch.eye(3, 4, device="cuda")
    uv, depth = projection.project_ortho(xyz, extr, W, H)
    vis = depth != 0
    cov = quaternion.build_cov3d(scale, quat, vis)
    conic, radius, tiles, rmin, rmax = projection.ewa_ortho(cov, extr, uv, W, H, vis, block)
    opacity = (torch.rand(n, generator=g) * 0.9 + 0.05).cuda()
    feats = torch.rand(n, 20, generator=g).cuda()
    return uv, depth, conic, tiles, rmin, rmax, opacity, feats


@pytest.mark.parametrize("M", [1 << 16, 1000])   # roomy and saturated budgets
def test_expand_intersections_matches_plain(M):
    uv, depth, conic, tiles, rmin, rmax, *_ = projected(0)
    tiles = tiles.clamp_max(64)
    offs = torch.cumsum(tiles, 0, dtype=torch.int32) - tiles
    tgx, _ = projection.tile_grid(W, H)
    args = (offs, tiles, rmin.contiguous(), rmax.contiguous(), depth, M, tgx)
    before = rasterize_gpu.LAUNCHES["expand_intersections"]
    keys, gid = rasterize_gpu.expand_intersections(*args)
    assert rasterize_gpu.LAUNCHES["expand_intersections"] == before + 1
    keys_p, gid_p = rasterize_gpu.expand_intersections_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_p) and torch.equal(gid, gid_p)


@pytest.mark.parametrize("tile,K,bias", [((16, 16), 0, False), ((16, 16), 8, True), ((32, 16), 4, False)])
def test_blend_forward_matches_plain(tile, K, bias):
    uv, depth, conic, tiles, rmin, rmax, opacity, feats = projected(1, block=tile)
    b = binning.bin_intersections(depth, tiles, rmin, rmax, W, H, 1 << 16, block=tile)
    ob = torch.rand(uv.shape[0], device="cuda") * 0.1 if bias else None
    bg = torch.linspace(0.0, 1.0, feats.shape[1], device="cuda")
    args = (b.gid, b.edges, uv.contiguous(), conic.contiguous(), opacity, feats, bg, W, H, tile, K, ob)
    before = rasterize_gpu.LAUNCHES["blend_forward"]
    out = rasterize_gpu.blend_forward(*args)
    assert rasterize_gpu.LAUNCHES["blend_forward"] == before + 1
    ref = rasterize_gpu.blend_forward_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    assert np.isfinite(out[0].cpu().numpy()).all() and int(out[2].sum()) > 0
