"""Port parity for the blend's backward: per-Gaussian gradients of
`rasterize_gpu.splat_scene` (on the CPU: the plain versions of K1, K3 and
K4) against `jax.grad` through `rasterize_tpu.splat_scene` (Pallas in
interpret mode), on the same 64x48 scene of ~120 Gaussians with opacity
< 0.9, so the 0.99 clamp stays inactive. Bars of `test_rasterize.py`:
atol 3e-4, rtol 2e-3. Also: masked channels send no gradient to opacity,
the final_T cotangent is ignored as in JAX, the renderer API carries
the masks and the abs sink, and `render_gaussians` differentiates through
the point-wise ops as JAX does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu.ops import rasterize_tpu as jtpu
from splatter_a_video_tpu_torch.ops import binning as tbin
from splatter_a_video_tpu_torch.ops import rasterize as tras
from splatter_a_video_tpu_torch.ops import rasterize_gpu as tgpu
from test_torch_rasterize import H, W, scene

ATOL, RTOL = 3e-4, 2e-3
NAMES = ("uv", "conic", "opacity", "features", "abs_sink", "opacity_bias")
CASES = {
    "C3": dict(C=3, mask=None, bias=False, block=(16, 16)),
    "C7_masked": dict(C=7, mask=(1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0), bias=False, block=(16, 16)),
    "bias": dict(C=3, mask=None, bias=True, block=(16, 16)),
    "tiles_32x16": dict(C=3, mask=None, bias=False, block=(32, 16)),
}


def case_inputs(C, block, seed=10):
    s = scene(seed, C=C, opacity_max=0.85, block=block)
    rng = np.random.RandomState(seed + 1)
    gimg = rng.randn(H, W, C).astype(np.float32)
    bg = tuple(float(x) for x in rng.uniform(0.0, 1.0, C))
    return s, gimg, bg


def jax_grads(s, gimg, bg, C, mask, bias, block):
    def loss(uv, conic, op, f, sink, b):
        out = jtpu.splat_scene(
            uv, conic, op, f, sink, jnp.asarray(s["depth"]), jnp.asarray(s["tiles"]),
            jnp.asarray(s["rmin"]), jnp.asarray(s["rmax"]), C=C, W=W, H=H, bg=bg,
            alpha_grad_mask=mask, max_intersections=1 << 14, block=block,
            opacity_bias=b if bias else None,
        )
        return jnp.sum(out[0] * gimg)

    args = [jnp.asarray(s[k]) for k in ("uv", "conic", "opacity", "feats")]
    args += [jnp.zeros((len(s["uv"]), 2)), jnp.asarray(s["bias"])]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(*args)]


def port_grads(s, gimg, bg, C, mask, bias, block, final_T_weight=0.0):
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    leaves = [T[k].clone().requires_grad_() for k in ("uv", "conic", "opacity", "feats")]
    leaves += [torch.zeros(len(s["uv"]), 2, requires_grad=True), T["bias"].clone().requires_grad_()]
    out = tgpu.splat_scene(
        *leaves[:4], T["depth"], T["tiles"], T["rmin"], T["rmax"], W=W, H=H, bg=bg,
        alpha_grad_mask=mask, abs_sink=leaves[4], max_intersections=1 << 14, block=block,
        opacity_bias=leaves[5] if bias else None,
    )
    loss = (out[0] * torch.from_numpy(gimg)).sum() + final_T_weight * out[1].sum()
    loss.backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_splat_gradients_match_jax(case):
    cfg = CASES[case]
    s, gimg, bg = case_inputs(cfg["C"], cfg["block"])
    assert s["opacity"].max() < 0.9
    ref = jax_grads(s, gimg, bg, **cfg)
    got = port_grads(s, gimg, bg, **cfg)
    for name, r, g in zip(NAMES, ref, got):
        if name == "opacity_bias" and not cfg["bias"]:
            assert g is None
            continue
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=RTOL, err_msg=name)


def test_masked_channels_send_no_gradient_to_opacity():
    """With features only on masked channels, opacity gets no gradient,
    while uv and conic still do (through dalpha_all); ignoring the mask
    would give opacity one."""
    C = 7
    s, gimg, bg = case_inputs(C, (16, 16), seed=12)
    gimg[..., :4] = 0.0                      # only the track_gs-like channels carry loss
    mask = (1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0)
    bg = (0.0,) * C
    got = port_grads(s, gimg, bg, C, mask, False, (16, 16))
    assert float(got[2].abs().max()) == 0.0
    assert float(got[0].abs().max()) > 0 and float(got[1].abs().max()) > 0
    unmasked = port_grads(s, gimg, bg, C, None, False, (16, 16))
    assert float(unmasked[2].abs().max()) > 1e-3
    ref = jax_grads(s, gimg, bg, C, mask, False, (16, 16))
    np.testing.assert_allclose(got[0].numpy(), ref[0], atol=ATOL, rtol=RTOL)


def test_final_T_cotangent_is_ignored_like_jax():
    s, gimg, bg = case_inputs(3, (16, 16))
    a = port_grads(s, gimg, bg, 3, None, False, (16, 16))
    b = port_grads(s, gimg, bg, 3, None, False, (16, 16), final_T_weight=5.0)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)


def test_reduce_gaussians_skips_slots_past_the_budget():
    """A saturated budget: Gaussians whose slots fall past M lose exactly
    those rows; K4's plain version sums runs in slot order."""
    s, _, _ = case_inputs(3, (16, 16))
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    total = int(T["tiles"].clamp_max(64).sum())
    M = total // 2
    b = tbin.bin_intersections(T["depth"], T["tiles"], T["rmin"], T["rmax"], W, H, M)
    dgrad = torch.arange(M * 2, dtype=torch.float32).reshape(M, 2) % 7 + 1.0
    red = tgpu.reduce_gaussians_plain(dgrad, b.order, b.offs, b.tiles)
    inv = torch.empty(M, dtype=torch.int64)
    inv[b.order] = torch.arange(M)
    for g in range(len(s["uv"])):
        o, n = int(b.offs[g]), int(b.tiles[g])
        want = torch.zeros(2)
        for j in range(n):
            if o + j < M:
                want = want + dgrad[inv[o + j]]
        assert torch.equal(red[g], want), g


def test_rasterize_api_masks_and_abs_sink_match_jax():
    """`rasterize` with three-field groups (rgb and depth reach opacity, an
    extra attribute does not) and an abs sink, against the JAX API."""
    s, _, _ = case_inputs(3, (16, 16), seed=14)
    rng = np.random.RandomState(3)
    extra = rng.uniform(0, 1, (len(s["uv"]), 2)).astype(np.float32)
    gimg = rng.randn(H, W, 6).astype(np.float32)
    keys = ("uv", "depth", "conic", "radius", "tiles", "rmin", "rmax")

    def jl(uv, op, f, ex, sink):
        groups = {"rgb": (f, 1.0, True), "depth": (jnp.asarray(s["depth"])[:, None], 2.0, True),
                  "extra": (ex, 0.0, False)}
        a = [jnp.asarray(s[k]) for k in keys]
        a[0] = uv
        out = jras.rasterize(*a, op, groups, jras.RasterizeConfig(
            width=W, height=H, max_intersections=1 << 14, sort_mode="exact"), abs_sink=sink)
        img = jnp.concatenate([out.features[k] for k in ("rgb", "depth", "extra")], -1)
        return jnp.sum(img * gimg)

    ref = jax.grad(jl, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(s["uv"]), jnp.asarray(s["opacity"]), jnp.asarray(s["feats"]),
        jnp.asarray(extra), jnp.zeros((len(s["uv"]), 2)))
    T = {k: torch.from_numpy(v) for k, v in s.items()}
    leaves = [T["uv"].clone().requires_grad_(), T["opacity"].clone().requires_grad_(),
              T["feats"].clone().requires_grad_(), torch.from_numpy(extra).requires_grad_(),
              torch.zeros(len(s["uv"]), 2, requires_grad=True)]
    groups = {"rgb": (leaves[2], 1.0, True), "depth": (T["depth"][:, None], 2.0, True),
              "extra": (leaves[3], 0.0, False)}
    a = [T[k] for k in keys]
    a[0] = leaves[0]
    out = tras.rasterize(*a, leaves[1], groups, tras.RasterizeConfig(
        width=W, height=H, max_intersections=1 << 14), abs_sink=leaves[4])
    img = torch.cat([out.features[k] for k in ("rgb", "depth", "extra")], -1)
    (img * torch.from_numpy(gimg)).sum().backward()
    for r, x in zip(ref, leaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


def test_render_gaussians_gradients_match_jax():
    """Gradients through the point-wise ops of PR 1 (SH, quaternion and
    cov3d, ortho projection, EWA) and the blend: `render_gaussians` with an
    extra attribute and an abs sink against `jax.grad` of the JAX API."""
    rng = np.random.RandomState(15)
    n = 120
    xyz = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(0.5, 2.0, (n, 1))], 1)
    inputs = [xyz, np.exp(rng.uniform(-3.5, -2.0, (n, 3))), rng.randn(n, 4),
              rng.uniform(0.1, 0.85, n), rng.randn(n, 16, 3) * 0.4, rng.rand(n, 2), np.zeros((n, 2))]
    inputs = [a.astype(np.float32) for a in inputs]
    extr = np.eye(3, 4, dtype=np.float32)
    gimg = {k: rng.randn(H, W, c).astype(np.float32) for k, c in (("rgb", 3), ("depth", 1), ("extra", 2))}

    def jl(pos, scale, rot, op, shs, extra, sink):
        out = jras.render_gaussians(pos, scale, rot, op, shs, jnp.asarray(extr), jras.RasterizeConfig(
            width=W, height=H, max_intersections=1 << 14, sort_mode="exact"),
            extra_features={"extra": extra}, abs_sink=sink)
        return sum(jnp.sum(out.features[k] * g) for k, g in gimg.items())

    ref = jax.grad(jl, argnums=tuple(range(7)))(*(jnp.asarray(a) for a in inputs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = tras.render_gaussians(*leaves[:5], torch.from_numpy(extr), tras.RasterizeConfig(
        width=W, height=H, max_intersections=1 << 14), extra_features={"extra": leaves[5]},
        abs_sink=leaves[6])
    sum((out.features[k] * torch.from_numpy(g)).sum() for k, g in gimg.items()).backward()
    for name, r, x in zip(("position", "scaling", "rotation", "opacity", "shs", "extra", "abs_sink"),
                          ref, leaves):
        assert np.abs(np.asarray(r)).max() > 0, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL, err_msg=name)
