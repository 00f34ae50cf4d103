"""Port parity: point-wise ops of `splatter_a_video_tpu_torch.ops` against
the JAX package on the same numpy inputs (CPU). Floats within atol 1e-6 /
rtol 1e-5 (float32 rounding of different op fusions); the integer EWA
outputs (radius, tiles, tile rects) must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.ops import projection as jproj
from splatter_a_video_tpu.ops import quaternion as jquat
from splatter_a_video_tpu.ops import sh as jsh
from splatter_a_video_tpu_torch.models import camera as tcam
from splatter_a_video_tpu_torch.ops import projection as tproj
from splatter_a_video_tpu_torch.ops import quaternion as tquat
from splatter_a_video_tpu_torch.ops import sh as tsh

W, H = 64, 48
ATOL, RTOL = 1e-6, 1e-5


def close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=ATOL, rtol=RTOL)


def t(a):
    return torch.from_numpy(np.array(a))


def gaussians(seed, n=120):
    rng = np.random.RandomState(seed)
    xyz = np.concatenate(
        [rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1
    ).astype(np.float32)
    xyz[:5, 2] = -1.0                      # behind the near plane: culled
    xyz[5:8, 0] = 2.0                      # beyond the frustum extent: culled
    scale = np.exp(rng.uniform(-3.5, -2.0, (n, 3))).astype(np.float32)
    quat = rng.randn(n, 4).astype(np.float32)
    opacity = rng.uniform(0.0, 0.95, n).astype(np.float32)
    return xyz, scale, quat, opacity


def extrinsics():
    base = tcam.canonical_camera(W, H)
    orbit = tcam.orbit_cameras(base, 3, radius=0.15)[1]
    return {"identity": base.extrinsic, "orbit": orbit.extrinsic}


class TestQuaternion:
    def test_normalize_rotmat_inverse_sigmoid(self):
        rng = np.random.RandomState(0)
        q = rng.randn(200, 4).astype(np.float32)
        close(jquat.quat_normalize(jnp.asarray(q)), tquat.quat_normalize(t(q)))
        qn = np.asarray(jquat.quat_normalize(jnp.asarray(q)))
        close(jquat.quat_to_rotmat(jnp.asarray(qn)), tquat.quat_to_rotmat(t(qn)))
        x = rng.uniform(0.01, 0.99, 200).astype(np.float32)
        close(jquat.inverse_sigmoid(jnp.asarray(x)), tquat.inverse_sigmoid(t(x)))

    @pytest.mark.parametrize("with_visible", [False, True])
    def test_build_cov3d(self, with_visible):
        _, scale, quat, _ = gaussians(1)
        vis = np.random.RandomState(2).rand(len(scale)) > 0.3 if with_visible else None
        j = jquat.build_cov3d(jnp.asarray(scale), jnp.asarray(quat),
                              None if vis is None else jnp.asarray(vis))
        p = tquat.build_cov3d(t(scale), t(quat), None if vis is None else t(vis))
        close(j, p)


class TestSH:
    @pytest.mark.parametrize("deg", [0, 1, 2, 3])
    def test_eval_sh(self, deg):
        rng = np.random.RandomState(deg)
        n = 150
        sh = (rng.randn(n, 16, 3) * 0.5).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        vis = rng.rand(n) > 0.2
        close(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d), jnp.asarray(vis)),
              tsh.eval_sh(deg, t(sh), t(d), t(vis)))

    def test_rgb_sh_roundtrip(self):
        rgb = np.random.RandomState(4).rand(50, 3).astype(np.float32)
        close(jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(t(rgb)))
        close(jsh.sh_to_rgb(jnp.asarray(rgb)), tsh.sh_to_rgb(t(rgb)))


class TestProjection:
    @pytest.mark.parametrize("pose", ["identity", "orbit"])
    def test_project_ortho(self, pose):
        xyz, *_ = gaussians(5)
        extr = extrinsics()[pose]
        ju, jd = jproj.project_ortho(jnp.asarray(xyz), jnp.asarray(extr), W, H)
        tu, td = tproj.project_ortho(t(xyz), t(extr), W, H)
        close(ju, tu)
        close(jd, td)
        np.testing.assert_array_equal(np.asarray(jd) == 0, td.numpy() == 0)

    def test_project_persp(self):
        xyz, *_ = gaussians(6)
        cam = tcam.canonical_camera(W, H)
        ju, jd = jproj.project_persp(jnp.asarray(xyz), jnp.asarray(cam.intrinsic),
                                     jnp.asarray(cam.extrinsic), W, H)
        tu, td = tproj.project_persp(t(xyz), t(cam.intrinsic), t(cam.extrinsic), W, H)
        close(ju, tu)
        close(jd, td)

    def test_tile_grid_and_radius_cap(self):
        for block in (16, (32, 16)):
            assert tproj.tile_grid(854, 480, block) == jproj.tile_grid(854, 480, block)
            for cap in (4, 12, 64):
                assert tproj.max_radius_for_tile_cap(cap, block) == jproj.max_radius_for_tile_cap(cap, block)


def _ewa_both(kind, seed, rect_mode, with_opacity, block, max_radius):
    xyz, scale, quat, opacity = gaussians(seed)
    cam = tcam.canonical_camera(W, H)
    extr = extrinsics()["orbit"]
    intr = cam.intrinsic
    if kind == "ortho":
        uv, depth = jproj.project_ortho(jnp.asarray(xyz), jnp.asarray(extr), W, H)
    else:
        uv, depth = jproj.project_persp(jnp.asarray(xyz), jnp.asarray(intr), jnp.asarray(extr), W, H)
    vis = depth != 0
    cov = jquat.build_cov3d(jnp.asarray(scale), jnp.asarray(quat), vis)
    op_j = jnp.asarray(opacity) if with_opacity else None
    op_t = t(opacity) if with_opacity else None
    if kind == "ortho":
        j = jproj.ewa_ortho(cov, jnp.asarray(extr), uv, W, H, vis, block, max_radius, rect_mode, op_j)
        p = tproj.ewa_ortho(t(cov), t(extr), t(uv), W, H, t(vis), block, max_radius, rect_mode, op_t)
    else:
        j = jproj.ewa_persp(jnp.asarray(xyz), cov, jnp.asarray(intr), jnp.asarray(extr), uv, W, H,
                            vis, block, max_radius, rect_mode, op_j)
        p = tproj.ewa_persp(t(xyz), t(cov), t(intr), t(extr), t(uv), W, H, t(vis), block,
                            max_radius, rect_mode, op_t)
    return j, p


@pytest.mark.parametrize("kind", ["ortho", "persp"])
@pytest.mark.parametrize("rect_mode", ["tight", "disc"])
@pytest.mark.parametrize("with_opacity", [False, True])
def test_ewa(kind, rect_mode, with_opacity):
    max_r = jproj.max_radius_for_tile_cap(12, 16)
    for block, max_radius in ((16, None), ((32, 16), max_r)):
        (jc, jr, jt, jmin, jmax), (pc, pr, pt, pmin, pmax) = _ewa_both(
            kind, 7, rect_mode, with_opacity, block, max_radius)
        close(jc, pc)
        for a, b in ((jr, pr), (jt, pt), (jmin, pmin), (jmax, pmax)):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert int(pt.sum()) > 0
