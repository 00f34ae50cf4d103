"""The port's CUDA kernels against their plain PyTorch versions, and one
density event against the CPU, on the card. CUDA kernels have no CPU mode:
without a CUDA device these tests skip.
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
EDGE_W, EDGE_H = 256, 192   # a 16x12 tile grid: room for rects of 64 tiles and more
EDGE_CASES = ("zero_run", "cap", "mid_run", "tiny")


def edge_footprints(case):
    """Synthetic tile footprints (numpy) for the expansion's edge cases, on
    the EDGE_W x EDGE_H frame with a 64-tile cap; depths repeat, so equal
    keys are ordered by Gaussian index. Returns (depth, tiles, rect_min,
    rect_max, M).

      zero_run: 5,000 Gaussians without tiles in a row, among live and
        culled ones: more Gaussians than one block of K2 has slots;
      cap: rects of 64, 81 and 96 tiles, cut to their first 64 in
        row-major order;
      mid_run: the zero run, and a budget M that ends inside a run;
      tiny: N = 5, fewer Gaussians than one block has threads.
    """
    rng = np.random.RandomState(EDGE_CASES.index(case))
    n = {"zero_run": 8000, "cap": 600, "mid_run": 8000, "tiny": 5}[case]
    tgx, tgy = projection.tile_grid(EDGE_W, EDGE_H)
    rw, rh = rng.randint(1, 5, n), rng.randint(1, 5, n)
    if case == "cap":
        big = rng.randint(0, 4, n)   # 0: small, 1: 8x8, 2: 9x9, 3: 12x8
        rw = np.choose(big, [rw, 8, 9, 12])
        rh = np.choose(big, [rh, 8, 9, 8])
    rmx = rng.randint(0, tgx - rw + 1)
    rmy = rng.randint(0, tgy - rh + 1)
    depth = (rng.randint(1, 40, n) / 8).astype(np.float32)
    dead = rng.rand(n) < 0.25
    if case in ("zero_run", "mid_run"):
        dead[1500:6500] = True
    if case == "tiny":
        dead[:] = [False, True, False, False, True]
    depth[dead] = 0.0
    tiles = np.where(dead, 0, rw * rh).astype(np.int32)
    rect_min = np.stack([rmx, rmy], 1).astype(np.int32)
    rect_max = np.stack([rmx + rw, rmy + rh], 1).astype(np.int32)
    clamped = np.minimum(tiles, 64)
    M = 1 << 15
    if case == "mid_run":   # inside the run of the first Gaussian of >= 4 tiles after the zero run
        g = 6500 + int(np.argmax(clamped[6500:] >= 4))
        M = int(clamped[:g].sum()) + 2
    assert M != int(clamped.sum())
    return depth, tiles, rect_min, rect_max, M


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


# roomy and saturated budgets, even and odd (an odd M ends in a lone slot)
@pytest.mark.parametrize("M", [1 << 16, (1 << 16) + 1, 1000, 1001])
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


@pytest.mark.parametrize("case", EDGE_CASES)
def test_expand_intersections_edge_cases(case):
    """The inputs of `test_torch_binning.test_edge_cases_match_jax_exact`."""
    *arrays, M = edge_footprints(case)
    depth, tiles, rmin, rmax = (torch.from_numpy(a).cuda() for a in arrays)
    tiles = tiles.clamp_max(64)
    offs = torch.cumsum(tiles, 0, dtype=torch.int32) - tiles
    tgx, _ = projection.tile_grid(EDGE_W, EDGE_H)
    args = (offs, tiles, rmin, rmax, depth, M, tgx)
    keys, gid = rasterize_gpu.expand_intersections(*args)
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
# C above 32 and tiles above 1024 pixels (K1's wide instance: blocks of at
# most 256 pixels and 64 channels), and K3's wide instance (any C above 32,
# tiles above 512 pixels or not of whole warps; in passes of 256 pixels
# above 256, its channels in chunks of 16)
WIDE_CASES = [
    ((16, 16), 33, 0, False, False),
    ((32, 16), 40, 0, False, False),
    ((16, 16), 52, 8, True, False),
    ((16, 16), 64, 0, False, True),
    ((16, 16), 200, 0, False, False),
    ((32, 32), 7, 0, False, True),
    ((32, 32), 52, 4, True, False),
    ((12, 12), 7, 0, False, False),
    ((12, 12), 52, 0, True, True),
    ((4, 4), 3, 0, False, False),
    ((64, 32), 7, 0, False, False),
    ((48, 48), 52, 0, False, False),
    # one case per wide instance, at phase 23's widths: K1's groups of 8
    # (K3 with one chunk, fused with the base rows), 16 (one chunk, not
    # fused), 32 and 64 on tiles of several passes, many batches and a bias
    ((64, 32), 7, 4, True, True),
    ((48, 48), 16, 0, False, True),
    ((64, 32), 32, 8, True, False),
    ((48, 48), 72, 0, True, False),
]
FORWARD_CASES = BLEND_CASES + WIDE_CASES + [
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


def _binned(seed, tile, C, dense, saturate=False):
    uv, depth, conic, tiles, rmin, rmax, opacity, feats = projected(seed, block=tile, C=C, dense=dense)
    M = 1 << 18
    if saturate:   # a budget that ends inside the expansion
        M = int(tiles.clamp_max(64).sum()) * 2 // 3
    b = binning.bin_intersections(depth, tiles, rmin, rmax, W, H, M, block=tile)
    assert (int(b.num_intersections) > M) == saturate
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


def _backward_inputs(tile, bias, C=7, seed=2, dense=False, saturate=False):
    b, uv, conic, opacity, feats = _binned(seed, tile, C, dense, saturate)
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
    + BLEND_CASES + WIDE_CASES, ids=_case_id)
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
    ("reduce_gaussians", 41, (16, 16)),
    ("blend_forward", 52, (16, 16)), ("blend_forward", 200, (16, 16)), ("blend_forward", 52, (32, 32)),
    ("blend_backward", 52, (16, 16)), ("blend_backward", 200, (16, 16)), ("blend_backward", 7, (32, 32)),
    ("blend_backward", 52, (32, 32)), ("blend_backward", 7, (12, 12)),
    ("reduce_gaussians", 60, (16, 16)), ("reduce_gaussians", 208, (16, 16)),
    ("blend_forward", 7, (64, 32)), ("blend_forward", 52, (48, 48)), ("blend_backward", 7, (64, 32)),
    ("blend_backward", 52, (48, 48)),
])
def test_kernel_attributes(name, C, tile):
    """Each library reports its instance's registers, spills and shared bytes;
    no blend instance spills."""
    a = rasterize_gpu.kernel_attributes(name, C, tile)
    assert set(a) == {"regs", "local_bytes", "shared_bytes"}
    assert 0 < a["regs"] <= 255 and a["local_bytes"] >= 0 and a["shared_bytes"] >= 0
    if name.startswith("blend"):
        assert a["local_bytes"] == 0


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


# around the staging kernel's widest row (41; 48 KB without opt-in), then
# the wide kernel: rows of float4s (R % 4 == 0) on a half-warp up to 64 and
# on a warp past it, rows of floats (R % 4 != 0), and rows wider than one
# warp's pass (128 floats of float4s, 32 floats of floats)
@pytest.mark.parametrize("R", [1, 15, 41, 42, 43, 44, 60, 61, 64, 65, 72, 82, 83, 128, 129, 200, 201, 208,
                               256, 512])
def test_reduce_gaussians_any_row_count(R):
    """K4 alone on seeded rows of R columns launches, equals its plain
    version, and repeats bit for bit twice."""
    b = _binned(3, (16, 16), 3, False, False)[0]
    rows = torch.randn(b.order.shape[0], R, generator=torch.Generator().manual_seed(R)).cuda()
    before = rasterize_gpu.LAUNCHES["reduce_gaussians"]
    red = rasterize_gpu.reduce_gaussians(rows, b.order, b.offs, b.tiles)
    assert rasterize_gpu.LAUNCHES["reduce_gaussians"] == before + 1
    ref = rasterize_gpu.reduce_gaussians_plain(rows, b.order, b.offs, b.tiles)
    again = [rasterize_gpu.reduce_gaussians(rows, b.order, b.offs, b.tiles) for _ in range(2)]
    torch.cuda.synchronize()
    assert red.shape == (b.offs.shape[0], R)
    assert torch.equal(red, ref) and float(red.abs().sum()) > 0
    assert all(torch.equal(red, a) for a in again)


@pytest.mark.parametrize("R", [15, 41, 44, 60, 61, 208])
@pytest.mark.parametrize("saturate", [False, True])
def test_reduce_gaussians_full_runs(R, saturate):
    """Runs of the full 64 slots (the first and last Gaussians, one in the
    middle, 40 in a row) among short and empty ones, on a permutation
    that keeps the unused slots in place; saturated, the budget ends 37
    slots into one of the 40. Equal to the plain version, twice."""
    rng = np.random.RandomState(R)
    N = 3000
    tiles = rng.randint(0, 9, N)
    tiles[rng.rand(N) < 0.2] = 0
    tiles[[0, 1234, N - 1]] = 64
    tiles[2000:2040] = 64
    offs = np.cumsum(tiles) - tiles
    total = int(tiles.sum())
    M = int(offs[2020]) + 37 if saturate else total + 1000
    used = min(total, M)
    order = np.concatenate([rng.permutation(used), np.arange(used, M)])
    args = (torch.randn(M, R, generator=torch.Generator().manual_seed(R)).cuda(), torch.from_numpy(order).cuda(),
            torch.from_numpy(offs.astype(np.int32)).cuda(), torch.from_numpy(tiles.astype(np.int32)).cuda())
    red = rasterize_gpu.reduce_gaussians(*args)
    ref = rasterize_gpu.reduce_gaussians_plain(*args)
    again = [rasterize_gpu.reduce_gaussians(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(red, ref) and all(torch.equal(red, a) for a in again)
    assert float(red[N - 1].abs().sum()) > 0 if not saturate else not bool(red[2021:].any())


@pytest.mark.parametrize("C,bias,saturate", [(7, False, True), (32, True, False), (32, True, True),
                                             (52, False, False), (52, True, True), (200, False, False)])
def test_reduce_gaussians_wide_rows_and_saturated_budget(C, bias, saturate):
    """R = 8 + 32 + 1 = 41 rows (more than one 32-lane group's pass), rows
    of the wide kernel (R = 60, 61 and 208 > 41) and a budget that ends
    inside the expansion, twice for determinism."""
    b, args, _ = _backward_inputs((16, 16), bias, C=C, saturate=saturate)
    dgrad = rasterize_gpu.blend_backward(*args)
    assert dgrad.shape[1] == 8 + C + bias
    red = rasterize_gpu.reduce_gaussians(dgrad, b.order, b.offs, b.tiles)
    ref = rasterize_gpu.reduce_gaussians_plain(dgrad, b.order, b.offs, b.tiles)
    again = rasterize_gpu.reduce_gaussians(rasterize_gpu.blend_backward(*args), b.order, b.offs, b.tiles)
    torch.cuda.synchronize()
    assert torch.equal(red, ref) and torch.equal(red, again)
    assert float(red.abs().sum()) > 0


def test_density_event_on_the_card_equals_the_cpu():
    """One density event at the production size (131,072 slots, 123,800
    alive, tied `grads`, a binding 5% budget, clones and splits) on the card
    and on the CPU: every count, mask, parameter and moment equal, but the
    split children's positions within 1e-6 (their offsets' exp and products
    round otherwise on the card). The split's shrink, log(1.6), was once
    taken on the card and moved every split child's scaling off the CPU's."""
    from splatter_a_video_tpu_torch.models.gaussians import GaussianScene, SceneConfig
    from splatter_a_video_tpu_torch.train import density, optim, prng

    rng = np.random.RandomState(15)
    cap, n = 131_072, 123_800
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n]] = True
    scaling = np.log(rng.uniform(0.0008, 0.012, (cap, 3))).astype(np.float32)
    # 3% with log-scales in (-1, 0.3): a child's log-scale less the shrink then
    # lies in binades below 1, where one ulp of the shrink shows
    wide = rng.uniform(0, 1, cap) < 0.03
    scaling[wide] = rng.uniform(-1.0, 0.3, (wide.sum(), 3)).astype(np.float32)
    params = {"position": rng.randn(cap, 3).astype(np.float32), "scaling": scaling,
              "rotation": rng.randn(cap, 4).astype(np.float32),
              "opacity": rng.uniform(-3.4, 2.5, (cap, 1)).astype(np.float32),
              "features_dc": rng.randn(cap, 1, 3).astype(np.float32)}
    big = np.exp(scaling).max(-1) > 0.005
    pool_d = rng.randint(1, 60, 300).astype(np.float32)
    pool_g = np.exp(rng.normal(np.log(4e-5), 1.0, 300)).astype(np.float32)
    pick = rng.randint(0, 300, cap)
    stats = [np.zeros(cap, np.float32), (pool_g[pick] * pool_d[pick] * np.where(big, 4, 1)).astype(np.float32),
             pool_d[pick]]
    cfg = density.DensifyConfig(max_growth_frac=0.05, size_prune_always=True)
    out = []
    for dev in ("cuda", "cpu"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        scene = GaussianScene(params=t, aux={"alive": torch.from_numpy(alive).to(dev)},
                              cfg=SceneConfig(capacity=cap, num_frames=2, traj="static"))
        opt = optim.AdamState(1500, {k: v * 1e-3 for k, v in t.items()}, {k: v * v * 1e-6 for k, v in t.items()})
        out.append(density.densify_and_prune(scene, opt, density.DensifyState(*(torch.from_numpy(a).to(dev)
                                                                                 for a in stats)),
                                             1500, cfg, key=prng.key(15)))
    (gs, go, _, gi), (cs, co, _, ci) = out
    assert [int(x) for x in gi] == [int(x) for x in ci]
    assert int(ci.num_cloned) > 0 and int(ci.num_split) > 0 and int(ci.dropped) > 0
    assert torch.equal(gs.alive.cpu(), cs.alive)
    kids = cs.alive & ~torch.from_numpy(alive)
    for k, v in cs.params.items():
        g = gs.params[k].cpu()
        if k == "position":
            assert torch.equal(g[~kids], v[~kids]) and float((g[kids] - v[kids]).abs().max()) <= 1e-6
        else:
            assert torch.equal(g, v), k
    for k in co.mu:
        assert torch.equal(go.mu[k].cpu(), co.mu[k]) and torch.equal(go.nu[k].cpu(), co.nu[k]), k
