"""Port parity: binning (`splatter_a_video_tpu_torch.ops.binning`) against a
brute-force tile membership, against JAX `bin_sort_pack(sort_mode="exact")`
and, for the plain expansion, against the Pallas monotone expansion
(interpret mode) on the inputs of `test_rasterize.TestMonotoneExpand`.
All comparisons are exact (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.ops import binning as jbin
from splatter_a_video_tpu.ops import projection as jproj
from splatter_a_video_tpu.ops import quaternion as jquat
from splatter_a_video_tpu_torch.ops import binning as tbin
from splatter_a_video_tpu_torch.ops import rasterize_gpu as tgpu
from test_torch_kernels import EDGE_CASES, EDGE_H, EDGE_W, edge_footprints

W, H = 64, 48


def projected(seed, n=120, block=16):
    """JAX-projected random scene, as numpy (inputs for both packages)."""
    rng = np.random.RandomState(seed)
    xyz = np.concatenate(
        [rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1
    ).astype(np.float32)
    xyz[:6, 2] = -10.0                               # dead slots: parked, culled
    scale = np.exp(rng.uniform(-3.5, -2.0, (n, 3))).astype(np.float32)
    quat = rng.randn(n, 4).astype(np.float32)
    extr = jnp.eye(3, 4)
    uv, depth = jproj.project_ortho(jnp.asarray(xyz), extr, W, H)
    vis = depth != 0
    cov = jquat.build_cov3d(jnp.asarray(scale), jnp.asarray(quat), vis)
    conic, radius, tiles, rmin, rmax = jproj.ewa_ortho(cov, extr, uv, W, H, vis, block)
    return {k: np.array(v) for k, v in dict(
        uv=uv, depth=depth, conic=conic, radius=radius, tiles=tiles, rmin=rmin, rmax=rmax
    ).items()}


def port_binning(s, M, cap=64, block=16):
    return tbin.bin_intersections(
        torch.from_numpy(s["depth"]), torch.from_numpy(s["tiles"]),
        torch.from_numpy(s["rmin"]), torch.from_numpy(s["rmax"]), W, H,
        max_intersections=M, max_tiles_per_gaussian=cap, block=block,
    )


@pytest.mark.parametrize("block", [16, (32, 16)])
def test_counts_membership_and_depth_order(block):
    s = projected(0, block=block)
    b = port_binning(s, 1 << 14, block=block)
    gid, edges = b.gid.numpy(), b.edges.numpy()
    total = int(s["tiles"].sum())
    assert int(b.num_intersections) == total == edges[-1]
    assert (gid[total:] == -1).all()
    assert (s["tiles"][:6] == 0).all()              # dead slots own no tiles
    tgx, tgy = jproj.tile_grid(W, H, block)
    for tile in range(tgx * tgy):
        ty, tx = divmod(tile, tgx)
        seg = gid[edges[tile]:edges[tile + 1]]
        want = [i for i in range(len(s["depth"]))
                if s["radius"][i] > 0 and s["rmin"][i, 0] <= tx < s["rmax"][i, 0]
                and s["rmin"][i, 1] <= ty < s["rmax"][i, 1]]
        assert sorted(seg.tolist()) == sorted(want), f"tile {tile}"
        assert (np.diff(s["depth"][seg]) >= 0).all(), f"tile {tile} not depth sorted"


@pytest.mark.parametrize(
    "seed,cap,M",
    # plain; clamped rects; saturated budgets, even and odd
    [(1, 64, 1 << 14), (2, 4, 1 << 14), (3, 64, 200), (4, 64, 201)],
)
def test_matches_jax_exact(seed, cap, M):
    s = projected(seed)
    channels = jnp.concatenate([jnp.asarray(s["uv"]), jnp.asarray(s["conic"])], axis=1)
    j = jbin.bin_sort_pack(
        jnp.asarray(s["depth"]), jnp.asarray(s["tiles"]), jnp.asarray(s["rmin"]),
        jnp.asarray(s["rmax"]), channels, W, H, max_intersections=M,
        max_tiles_per_gaussian=cap, sort_mode="exact",
    )
    b = port_binning(s, M, cap=cap)
    assert int(b.num_intersections) == int(j.num_intersections)
    if M in (200, 201):
        assert int(b.num_intersections) > M            # the saturated case really saturates
    np.testing.assert_array_equal(b.edges.numpy(), np.asarray(j.edges))
    np.testing.assert_array_equal(b.gid.numpy(), np.asarray(j.gid)[:M])
    np.testing.assert_array_equal(b.offs.numpy(), np.asarray(j.offs))
    np.testing.assert_array_equal(b.tiles.numpy(), np.asarray(j.tiles))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_cases_match_jax_exact(case):
    """The expansion's edge cases (`test_torch_kernels.edge_footprints`):
    a run of 5,000 Gaussians without tiles, rects at the 64-tile cap, a
    budget that ends inside a run, N = 5. Culled Gaussians are interspersed,
    so these go through `bin_sort_pack`, not the Pallas expansion."""
    depth, tiles, rmin, rmax, M = edge_footprints(case)
    clamped = np.minimum(tiles, 64)
    offs = np.cumsum(clamped) - clamped
    if case in ("zero_run", "mid_run"):
        assert (tiles[1500:6500] == 0).all() and 0 < offs[1500] < M
    if case == "cap":
        assert ((tiles > 64).sum() > 50) and ((tiles == 64).sum() > 50)
    if case == "mid_run":
        assert ((offs < M) & (M < offs + clamped)).sum() == 1
    j = jbin.bin_sort_pack(
        jnp.asarray(depth), jnp.asarray(tiles), jnp.asarray(rmin), jnp.asarray(rmax),
        jnp.asarray(depth)[:, None], EDGE_W, EDGE_H, max_intersections=M,
        max_tiles_per_gaussian=64, sort_mode="exact",
    )
    b = tbin.bin_intersections(
        torch.from_numpy(depth), torch.from_numpy(tiles), torch.from_numpy(rmin),
        torch.from_numpy(rmax), EDGE_W, EDGE_H, max_intersections=M, max_tiles_per_gaussian=64,
    )
    assert int(b.num_intersections) == int(j.num_intersections) == int(clamped.sum())
    np.testing.assert_array_equal(b.edges.numpy(), np.asarray(j.edges))
    np.testing.assert_array_equal(b.gid.numpy(), np.asarray(j.gid)[:M])
    np.testing.assert_array_equal(b.offs.numpy(), np.asarray(j.offs))
    np.testing.assert_array_equal(b.tiles.numpy(), np.asarray(j.tiles))


def _expand_inputs(seed, n, frac_dead):
    """`TestMonotoneExpand._random_binning_inputs`, with live Gaussians first
    (the Pallas expansion's precondition: offs strictly increasing over the
    live prefix, as the presorted binning arranges)."""
    rng = np.random.RandomState(seed)
    depth = np.abs(rng.randn(n).astype(np.float32)) + 0.01
    depth[rng.rand(n) < frac_dead] = 0.0
    tgx, tgy = jproj.tile_grid(W, H)
    rmx = rng.randint(0, max(tgx - 3, 1), n)
    rmy = rng.randint(0, max(tgy - 3, 1), n)
    rw = rng.randint(1, 4, n)
    rh = rng.randint(1, 4, n)
    tiles = np.where(depth > 0, rw * rh, 0).astype(np.int32)
    rect_min = np.stack([rmx, rmy], 1).astype(np.int32)
    rect_max = np.stack([rmx + rw, rmy + rh], 1).astype(np.int32)
    order = np.argsort(tiles == 0, kind="stable")
    return depth[order], tiles[order], rect_min[order], rect_max[order], tgx


@pytest.mark.parametrize(
    "seed,n,frac_dead",
    [
        (0, 700, 0.3),
        (1, 64, 0.0),
        (2, 300, 0.95),   # nearly all dead
        (3, 900, 0.2),    # saturated budget (2937 slots > 2048)
        (4, 128, 1.0),    # all dead
    ],
)
def test_plain_expansion_matches_pallas(seed, n, frac_dead):
    M = 1 << 11
    depth, tiles, rect_min, rect_max, tgx = _expand_inputs(seed, n, frac_dead)
    offs = (np.cumsum(tiles) - tiles).astype(np.int32)
    total = int(tiles.sum())
    word_f, j = jbin._monotone_expand_pallas(
        jnp.asarray(offs), jnp.arange(n, dtype=jnp.int32), M, total, interpret=True
    )
    keys, gid = tgpu.expand_intersections_plain(
        torch.from_numpy(offs), torch.from_numpy(tiles), torch.from_numpy(rect_min),
        torch.from_numpy(rect_max), torch.from_numpy(depth), M, tgx,
    )
    used = min(total, M)
    if seed == 3:
        assert total > M
    gid, keys = gid.numpy(), keys.numpy()
    np.testing.assert_array_equal(gid[:used], np.asarray(word_f)[:used])
    assert (gid[used:] == -1).all() and (keys[used:] == np.iinfo(np.int64).max).all()
    # recover j from the slot's tile: tile = (rmy + j // rw) * tgx + rmx + j % rw
    g = gid[:used]
    tile = keys[:used] >> 32
    rw = np.maximum(rect_max[g, 0] - rect_min[g, 0], 1)
    j_port = (tile // tgx - rect_min[g, 1]) * rw + (tile % tgx - rect_min[g, 0])
    np.testing.assert_array_equal(j_port, np.asarray(j)[:used])
    depth_bits = np.maximum(depth, 0).view(np.int32)
    np.testing.assert_array_equal(keys[:used] & 0xFFFFFFFF, depth_bits[g])


def test_kernel_wrapper_rejects_other_devices():
    """For tensors that are neither on the CPU nor on a CUDA device the
    wrapper raises; it never substitutes the plain version."""
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tgpu.expand_intersections(meta, meta, meta, meta, meta.float(), 8, 4)
