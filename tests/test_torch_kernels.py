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


def projected(seed, n=3000, block=(16, 16), C=20, dense=False):
    """A random scene; `dense` has 8x the Gaussians at opacities of 0.01-0.06,
    so tiles hold several hundred slots and few pixels saturate."""
    g = torch.Generator().manual_seed(seed)
    if dense:
        n = 8 * n
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
    lo, span = (0.01, 0.05) if dense else (0.05, 0.9)
    opacity = (torch.rand(n, generator=g) * span + lo).cuda()
    feats = torch.rand(n, C, generator=g).cuda()
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


# (tile, C, K_idx, opacity_bias, dense): C at the edges of K3's channel
# buckets 8 / 16 / 32 (K1's are every multiple of 4), every block size, and
# tiles with many batches
BLEND_CASES = [
    ((16, 16), 20, 0, False, False),
    ((16, 16), 20, 8, True, False),
    ((32, 16), 20, 4, False, False),
    ((16, 16), 1, 0, False, False),
    ((16, 16), 8, 0, False, False),
    ((16, 16), 9, 0, True, False),
    ((16, 16), 16, 0, False, False),
    ((16, 16), 17, 0, False, False),
    ((16, 16), 32, 0, False, False),
    ((32, 16), 32, 0, True, False),
    ((16, 16), 7, 4, True, True),
    ((32, 16), 20, 0, False, True),
]
FORWARD_CASES = BLEND_CASES + [
    ((16, 16), 4, 0, False, False),
    ((16, 16), 5, 4, False, False),
    ((16, 16), 21, 0, True, False),
    ((16, 16), 28, 0, False, False),
    ((32, 32), 20, 0, False, False),
    ((32, 32), 32, 8, True, False),
    ((32, 32), 7, 0, False, True),
]


def _case_id(case):
    (tw, th), C, K, bias, dense = case
    return f"{tw}x{th}-C{C}-K{K}" + ("-bias" if bias else "") + ("-dense" if dense else "")


def _binned(seed, tile, C, dense):
    uv, depth, conic, tiles, rmin, rmax, opacity, feats = projected(seed, block=tile, C=C, dense=dense)
    b = binning.bin_intersections(depth, tiles, rmin, rmax, W, H, 1 << 18, block=tile)
    assert int(b.num_intersections) <= 1 << 18
    if dense:   # more than two batches of K1 (128 slots) and K3 (32 slots)
        assert int((b.edges[1:] - b.edges[:-1]).max()) > 2 * 128
    return b, uv, conic, opacity, feats   # any layout: the wrappers pack them


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_case_id)
def test_blend_forward_matches_plain(case):
    tile, C, K, bias, dense = case
    b, uv, conic, opacity, feats = _binned(1, tile, C, dense)
    ob = torch.rand(uv.shape[0], device="cuda") * 0.1 if bias else None
    bg = torch.linspace(0.0, 1.0, C, device="cuda")
    args = (b.gid, b.edges, uv, conic, opacity, feats, bg, W, H, tile, K, ob)
    before = rasterize_gpu.LAUNCHES["blend_forward"]
    out = rasterize_gpu.blend_forward(*args)
    assert rasterize_gpu.LAUNCHES["blend_forward"] == before + 1
    ref = rasterize_gpu.blend_forward_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    assert np.isfinite(out[0].cpu().numpy()).all() and int(out[2].sum()) > 0


def _backward_inputs(tile, bias, C=7, seed=2, dense=False):
    b, uv, conic, opacity, feats = _binned(seed, tile, C, dense)
    ob = torch.rand(uv.shape[0], device="cuda") * 0.1 if bias else None
    bg = torch.linspace(0.0, 1.0, C, device="cuda")
    mask = (torch.arange(C, device="cuda") < 4).float()   # rgb + depth reach opacity
    image, final_T, ncontrib, _ = rasterize_gpu.blend_forward(
        b.gid, b.edges, uv, conic, opacity, feats, bg, W, H, tile, 0, ob)
    grad = torch.randn(H, W, C, generator=torch.Generator().manual_seed(seed)).cuda()
    args = (b.gid, b.edges, uv, conic, opacity, feats, bg, mask, image, final_T, grad, W, H, tile, ob)
    return b, args, ncontrib


@pytest.mark.parametrize(
    "case", [((16, 16), 7, 0, False, False), ((16, 16), 7, 0, True, False), ((32, 16), 7, 0, False, False)]
    + BLEND_CASES, ids=_case_id)
def test_blend_backward_matches_plain(case):
    """K3 repeats the plain version's arithmetic and its fixed summation
    tree, and its replay applies exactly K1's Gaussians."""
    tile, C, _, bias, dense = case
    b, args, k1_ncontrib = _backward_inputs(tile, bias, C=C, dense=dense)
    before = rasterize_gpu.LAUNCHES["blend_backward"]
    dgrad, ncontrib = rasterize_gpu.blend_backward(*args, return_ncontrib=True)
    assert rasterize_gpu.LAUNCHES["blend_backward"] == before + 1
    ref, ref_nc = rasterize_gpu.blend_backward_plain(*args, return_ncontrib=True)
    torch.cuda.synchronize()
    n = int(b.edges[-1])
    assert torch.equal(ncontrib, k1_ncontrib) and torch.equal(ref_nc, k1_ncontrib)
    assert torch.isfinite(dgrad[:n]).all()
    assert torch.equal(dgrad[:n], ref[:n])
    assert float(dgrad[:n].abs().sum()) > 0


@pytest.mark.parametrize("name,C,tile", [
    ("blend_forward", 20, (16, 16)), ("blend_forward", 7, (32, 32)),
    ("blend_backward", 7, (16, 16)), ("blend_backward", 32, (32, 16)),
    ("expand_intersections", 0, (16, 16)), ("reduce_gaussians", 0, (16, 16)),
])
def test_kernel_attributes(name, C, tile):
    """Each library reports its instance's registers, spills and shared bytes."""
    a = rasterize_gpu.kernel_attributes(name, C, tile)
    assert set(a) == {"regs", "local_bytes", "shared_bytes"}
    assert 0 < a["regs"] <= 255 and a["local_bytes"] >= 0 and a["shared_bytes"] >= 0


def test_reduce_gaussians_matches_plain_and_is_deterministic():
    b, args, _ = _backward_inputs((16, 16), False)
    dgrad = rasterize_gpu.blend_backward(*args)
    before = rasterize_gpu.LAUNCHES["reduce_gaussians"]
    red = rasterize_gpu.reduce_gaussians(dgrad, b.order, b.offs, b.tiles)
    assert rasterize_gpu.LAUNCHES["reduce_gaussians"] == before + 1
    ref = rasterize_gpu.reduce_gaussians_plain(dgrad, b.order, b.offs, b.tiles)
    again = rasterize_gpu.reduce_gaussians(rasterize_gpu.blend_backward(*args), b.order, b.offs, b.tiles)
    torch.cuda.synchronize()
    assert torch.equal(red, ref)
    assert torch.equal(red, again)   # no atomics: bit-identical from run to run
    assert float(red.abs().sum()) > 0
