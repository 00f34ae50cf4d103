"""Port parity: the blend (`rasterize_gpu.splat_scene` on the CPU, i.e. the
plain versions of both kernels), the port's oracle and `render_gaussians`
against the JAX package on the same numpy inputs. Bars of
`test_rasterize.py`: image and final_T atol 2e-5, ncontrib and gs_idx exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.ops import projection as jproj
from splatter_a_video_tpu.ops import quaternion as jquat
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu.ops import rasterize_ref as jref
from splatter_a_video_tpu.ops import rasterize_tpu as jtpu
from splatter_a_video_tpu_torch.ops import rasterize as tras
from splatter_a_video_tpu_torch.ops import rasterize_gpu as tgpu
from splatter_a_video_tpu_torch.ops import rasterize_ref as tref

W, H = 64, 48
ATOL = 2e-5


def scene(seed, n=120, opacity_max=0.9, C=3, block=16):
    """Random Gaussians in the canonical ortho frustum, projected by JAX;
    numpy arrays for both packages."""
    rng = np.random.RandomState(seed)
    xyz = np.concatenate(
        [rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1
    ).astype(np.float32)
    scale = np.exp(rng.uniform(-3.5, -2.0, (n, 3))).astype(np.float32)
    quat = rng.randn(n, 4).astype(np.float32)
    extr = jnp.eye(3, 4)
    uv, depth = jproj.project_ortho(jnp.asarray(xyz), extr, W, H)
    vis = depth != 0
    cov = jquat.build_cov3d(jnp.asarray(scale), jnp.asarray(quat), vis)
    conic, radius, tiles, rmin, rmax = jproj.ewa_ortho(cov, extr, uv, W, H, vis, block)
    s = {k: np.array(v) for k, v in dict(
        uv=uv, depth=depth, conic=conic, radius=radius, tiles=tiles, rmin=rmin, rmax=rmax
    ).items()}
    s["opacity"] = rng.uniform(0.1, opacity_max, n).astype(np.float32)
    s["feats"] = rng.uniform(0.0, 1.0, (n, C)).astype(np.float32)
    s["bias"] = rng.uniform(0.0, 0.25, n).astype(np.float32)
    return s


def port_splat(s, bg, K_idx=0, block=(16, 16), bias=False):
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    return tgpu.splat_scene(
        T["uv"], T["conic"], T["opacity"], T["feats"], T["depth"], T["tiles"],
        T["rmin"], T["rmax"], W=W, H=H, bg=bg, K_idx=K_idx,
        max_intersections=1 << 14, block=block,
        opacity_bias=T["bias"] if bias else None,
    )


def jax_oracle(s, bg, K_idx=0, block=16, bias=False):
    args = [jnp.asarray(s[k]) for k in ("uv", "conic", "opacity", "feats", "depth", "radius", "rmin", "rmax")]
    if bias:
        return jref.splat_reference_with_bias(*args, W, H, jnp.asarray(bg), jnp.asarray(s["bias"]),
                                              K_idx=K_idx, block=block)
    return jref.splat_reference(*args, W, H, bg=jnp.asarray(bg), K_idx=K_idx, block=block)


def assert_blend_equal(port, ref, K_idx=0):
    img, final_T, ncontrib, gs_idx = port[:4]
    np.testing.assert_allclose(img.numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(final_T.numpy(), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(ncontrib.numpy(), np.asarray(ref[2]))
    if K_idx:
        np.testing.assert_array_equal(gs_idx.numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_and_oracle_match_jax_oracle(seed):
    s = scene(seed)
    ref = jax_oracle(s, (1.0, 1.0, 1.0), K_idx=8)
    out = port_splat(s, (1.0, 1.0, 1.0), K_idx=8)
    assert int(out[4]) == int(s["tiles"].sum())
    assert_blend_equal(out, ref, K_idx=8)
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    oracle = tref.splat_reference(
        T["uv"], T["conic"], T["opacity"], T["feats"], T["depth"], T["radius"],
        T["rmin"], T["rmax"], W, H, torch.ones(3), K_idx=8)
    assert_blend_equal(oracle, ref, K_idx=8)


def test_bias_variant_matches_jax_oracle():
    s = scene(3, opacity_max=0.6)
    bg = (0.0, 0.0, 0.0)
    assert_blend_equal(port_splat(s, bg, K_idx=8, bias=True), jax_oracle(s, bg, K_idx=8, bias=True), 8)
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    oracle = tref.splat_reference_with_bias(
        T["uv"], T["conic"], T["opacity"], T["feats"], T["depth"], T["radius"],
        T["rmin"], T["rmax"], W, H, torch.zeros(3), T["bias"], K_idx=8)
    assert_blend_equal(oracle, jax_oracle(s, bg, K_idx=8, bias=True), 8)


def test_matches_jax_splat_scene_multichannel_bg():
    """Against the JAX production path (Pallas kernel in interpret mode,
    exact sort), with a distinct background per channel and gs_idx."""
    s = scene(4, C=5)
    bg = (1.0, 0.5, 0.0, 0.25, 0.75)
    j = jtpu.splat_scene(
        jnp.asarray(s["uv"]), jnp.asarray(s["conic"]), jnp.asarray(s["opacity"]),
        jnp.asarray(s["feats"]), jnp.zeros((len(s["uv"]), 2)), jnp.asarray(s["depth"]),
        jnp.asarray(s["tiles"]), jnp.asarray(s["rmin"]), jnp.asarray(s["rmax"]),
        C=5, W=W, H=H, bg=bg, K_idx=8, max_intersections=1 << 14, sort_mode="exact",
    )
    out = port_splat(s, bg, K_idx=8)
    assert_blend_equal(out, j, K_idx=8)
    assert int(out[4]) == int(j[4])


def test_wide_tiles_match_jax_oracle():
    s = scene(5, block=(32, 16))
    assert_blend_equal(
        port_splat(s, (1.0, 1.0, 1.0), block=(32, 16)),
        jax_oracle(s, (1.0, 1.0, 1.0), block=(32, 16)),
    )


def test_opaque_early_termination():
    """Opacities near 1 exercise the T < 1e-4 stop rule."""
    s = scene(6, n=200, opacity_max=0.989)
    s["opacity"] = np.clip(s["opacity"] * 1.1, 0.0, 0.989).astype(np.float32)
    out = port_splat(s, (1.0, 1.0, 1.0))
    assert_blend_equal(out, jax_oracle(s, (1.0, 1.0, 1.0)))
    assert float(out[1].min()) < 1e-3


def test_render_gaussians_matches_jax():
    rng = np.random.RandomState(7)
    n = 120
    xyz = np.concatenate(
        [rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1
    ).astype(np.float32)
    scaling = np.exp(rng.uniform(-3.5, -2.0, (n, 3))).astype(np.float32)
    rotation = rng.randn(n, 4).astype(np.float32)
    opacity = rng.uniform(0.1, 0.9, n).astype(np.float32)
    shs = (rng.randn(n, 16, 3) * 0.4).astype(np.float32)
    extra = {"mask_attribute": rng.rand(n, 1).astype(np.float32),
             "dino_attribute": rng.rand(n, 3).astype(np.float32)}
    extr = np.eye(3, 4, dtype=np.float32)
    jcfg = jras.RasterizeConfig(width=W, height=H, max_intersections=1 << 14, sort_mode="exact", K_idx=4)
    tcfg = tras.RasterizeConfig(width=W, height=H, max_intersections=1 << 14, K_idx=4)
    j = jras.render_gaussians(
        *(jnp.asarray(a) for a in (xyz, scaling, rotation, opacity, shs, extr)), jcfg,
        extra_features={k: jnp.asarray(v) for k, v in extra.items()},
    )
    t = tras.render_gaussians(
        *(torch.from_numpy(a) for a in (xyz, scaling, rotation, opacity, shs, extr)), tcfg,
        extra_features={k: torch.from_numpy(v) for k, v in extra.items()},
    )
    assert list(t.features) == list(j.features) == ["rgb", "depth", "mask_attribute", "dino_attribute"]
    for k in j.features:
        np.testing.assert_allclose(t.features[k].numpy(), np.asarray(j.features[k]), atol=ATOL, err_msg=k)
    np.testing.assert_allclose(t.final_T.numpy(), np.asarray(j.final_T), atol=ATOL)
    np.testing.assert_array_equal(t.ncontrib.numpy(), np.asarray(j.ncontrib))
    np.testing.assert_array_equal(t.gs_idx.numpy(), np.asarray(j.gs_idx))
    np.testing.assert_array_equal(t.radius.numpy(), np.asarray(j.radius))
    assert int(t.num_intersections) == int(j.num_intersections)


def test_backward_is_not_silently_plain():
    """The blend is forward only until the backward kernel exists: asking
    for a gradient raises rather than differentiating the plain version."""
    s = scene(8)
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    feats = T["feats"].clone().requires_grad_(True)
    img, *_ = tgpu.splat_scene(
        T["uv"], T["conic"], T["opacity"], feats, T["depth"], T["tiles"], T["rmin"], T["rmax"],
        W=W, H=H, bg=(1.0, 1.0, 1.0), max_intersections=1 << 14,
    )
    with pytest.raises(NotImplementedError, match="training slice"):
        img.sum().backward()
