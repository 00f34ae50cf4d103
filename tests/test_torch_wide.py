"""Port parity for the blend at any channel count and tile: the port's
`rasterize_gpu.splat_scene` (on the CPU, the plain versions of K1, K3 and
K4) against the JAX `rasterize_tpu.splat_scene` (Pallas in interpret mode,
exact sort) on the 64x48 scene, forward and gradients, at C = 33 and 52 on
16x16 tiles, at C = 7 on 32x32 tiles (1024 pixels) and 12x12 tiles (144
pixels, not whole warps of 32), and on tiles above the 1024 threads of a
block: C = 7 on 64x32 (2048 pixels) and C = 33 on 48x48 (2304); then one
train step that blends a 32-wide DINO attribute (C = 52) in both packages.
Bars of `test_rasterize.py`: image and final_T atol 2e-5, ncontrib exact,
gradients atol 3e-4 / rtol 2e-3; the train step's bars are those of
`test_torch_train_step.py`.

On the card the same widths and tiles run the kernels' wide instances;
`tests/test_torch_kernels.py` holds those to the plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.ops import rasterize_tpu as jtpu
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.ops import rasterize_gpu as tgpu
from splatter_a_video_tpu_torch.train import trainer as ttr
from test_torch_backward import ATOL as G_ATOL
from test_torch_backward import RTOL as G_RTOL
from test_torch_rasterize import ATOL, H, W, scene
from test_torch_train_step import ALIVE, CAP, T, batch_arrays, jax_state_arrays, trainer_cfg

NAMES = ("uv", "conic", "opacity", "features", "abs_sink", "opacity_bias")
# (C, tile, alpha_grad_mask: the first channels that reach opacity, bias)
CASES = {
    "C33_bias": (33, (16, 16), 33, True),
    "C52_masked": (52, (16, 16), 4, False),
    "C7_32x32": (7, (32, 32), 4, False),
    "C7_12x12": (7, (12, 12), 4, True),
    "C7_64x32": (7, (64, 32), 4, False),
    "C33_48x48": (33, (48, 48), 4, True),
}
DINO = 32


def case_inputs(C, block, seed=20):
    s = scene(seed, C=C, opacity_max=0.85, block=block)
    rng = np.random.RandomState(seed + 1)
    gimg = rng.randn(H, W, C).astype(np.float32)
    bg = tuple(float(x) for x in rng.uniform(0.0, 1.0, C))
    return s, gimg, bg


def jax_splat(s, gimg, bg, C, block, mask, bias):
    """JAX outputs and gradients (uv, conic, opacity, features, abs sink,
    bias) of sum(image * gimg)."""
    def fwd(uv, conic, op, f, sink, b):
        out = jtpu.splat_scene(
            uv, conic, op, f, sink, jnp.asarray(s["depth"]), jnp.asarray(s["tiles"]),
            jnp.asarray(s["rmin"]), jnp.asarray(s["rmax"]), C=C, W=W, H=H, bg=bg,
            alpha_grad_mask=mask, max_intersections=1 << 14, sort_mode="exact", block=block,
            opacity_bias=b if bias else None,
        )
        return out[0], out[:3]

    args = [jnp.asarray(s[k]) for k in ("uv", "conic", "opacity", "feats")]
    args += [jnp.zeros((len(s["uv"]), 2)), jnp.asarray(s["bias"])]
    img, vjp, outs = jax.vjp(fwd, *args, has_aux=True)
    grads = vjp(jnp.asarray(gimg))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def port_splat(s, gimg, bg, C, block, mask, bias):
    T_ = {k: torch.from_numpy(v) for k, v in s.items()}
    leaves = [T_[k].clone().requires_grad_() for k in ("uv", "conic", "opacity", "feats")]
    leaves += [torch.zeros(len(s["uv"]), 2, requires_grad=True), T_["bias"].clone().requires_grad_()]
    out = tgpu.splat_scene(
        *leaves[:4], T_["depth"], T_["tiles"], T_["rmin"], T_["rmax"], W=W, H=H, bg=bg,
        alpha_grad_mask=mask, abs_sink=leaves[4], max_intersections=1 << 14, block=block,
        opacity_bias=leaves[5] if bias else None,
    )
    (out[0] * torch.from_numpy(gimg)).sum().backward()
    return [o.detach().numpy() for o in out[:3]], [x.grad for x in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_blend_matches_jax(case):
    C, block, n_op, bias = CASES[case]
    mask = tuple(1.0 if c < n_op else 0.0 for c in range(C))
    s, gimg, bg = case_inputs(C, block)
    assert s["opacity"].max() < 0.9
    ref_out, ref_grads = jax_splat(s, gimg, bg, C, block, mask, bias)
    out, grads = port_splat(s, gimg, bg, C, block, mask, bias)
    np.testing.assert_allclose(out[0], ref_out[0], atol=ATOL, err_msg="image")
    np.testing.assert_allclose(out[1], ref_out[1], atol=ATOL, err_msg="final_T")
    np.testing.assert_array_equal(out[2], ref_out[2])
    assert int(out[2].sum()) > 0
    for name, r, g in zip(NAMES, ref_grads, grads):
        if name == "opacity_bias" and not bias:
            assert g is None
            continue
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=G_ATOL, rtol=G_RTOL, err_msg=name)


@pytest.mark.parametrize("P_", [144, 1, 31, 33, 1024, 2048, 2304])
def test_tile_tree_sum_pads_the_last_warp(P_):
    """A tile of P pixels sums like the same tile padded with zero pixels to
    whole warps: the tree of whole warps is unchanged, and absent lanes add
    nothing."""
    x = torch.from_numpy(np.random.RandomState(P_).randn(3, P_, 5).astype(np.float32))
    pad = -P_ % 32
    padded = torch.cat([x, torch.zeros(3, pad, 5)], 1)
    assert torch.equal(tgpu._tile_tree_sum(x), tgpu._tile_tree_sum(padded))
    np.testing.assert_allclose(tgpu._tile_tree_sum(x).numpy(), x.sum(1).numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# one train step blending a 32-wide DINO attribute: C = 3 + 1 + 3 + 1 + 12 + 32
# --------------------------------------------------------------------------


def wide_scene():
    rng = np.random.RandomState(5)
    cfg = jgs.SceneConfig(
        capacity=CAP, num_frames=T, traj="cubic_spline",
        render_attributes=(("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", DINO)),
    )
    pos = np.concatenate(
        [rng.uniform(-0.8, 0.8, (ALIVE, 2)), rng.uniform(0.8, 1.4, (ALIVE, 1))], 1
    ).astype(np.float32)
    t = np.linspace(0, 1, T, dtype=np.float32)[:, None, None]
    track = (pos[None] + 0.05 * np.sin(3.0 * t + rng.uniform(0, 6, (1, ALIVE, 3)))).astype(np.float32)
    track = track - (track[0] - pos)[None]
    s = jgs.create_scene(cfg, pos, rng.uniform(0, 1, (ALIVE, 3)).astype(np.float32), init_opacity=0.3,
                         track_seq=track)
    params = {k: np.array(v) for k, v in s.params.items()}
    params["scaling"][:ALIVE] = np.log(rng.uniform(0.02, 0.06, (ALIVE, 3))).astype(np.float32)
    params["rotation"][:ALIVE] = rng.randn(ALIVE, 4).astype(np.float32)
    params["opacity"][:ALIVE] = rng.uniform(-1.5, 1.5, (ALIVE, 1)).astype(np.float32)
    params["features_rest"][:ALIVE] = (rng.randn(ALIVE, 15, 3) * 0.1).astype(np.float32)
    params["mask_attribute"][:ALIVE] = rng.randn(ALIVE, 1).astype(np.float32)
    params["dino_attribute"][:ALIVE] = rng.randn(ALIVE, DINO).astype(np.float32)
    params["pos_poly_feat"][:ALIVE] = (rng.randn(ALIVE, 4, 3) * 0.01).astype(np.float32)
    return s.replace(params={k: jnp.asarray(v) for k, v in params.items()})


def wide_cfg(mod):
    """`test_torch_train_step`'s config, blending the render attributes and
    supervising the mask and DINO channels (the reference's weights, 20)."""
    return dataclasses.replace(trainer_cfg(mod), train_render_attributes=True, mask_attr_weight=20.0,
                               dino_attr_weight=20.0)


def wide_batch():
    rng = np.random.RandomState(6)
    b = batch_arrays()
    b["mask1"] = (rng.rand(H, W) < 0.5).astype(np.float32)
    b["dino1"] = rng.uniform(0, 1, (H, W, DINO)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def wide_run():
    scene_j = wide_scene()
    jcfg, tcfg = wide_cfg(jtr), wide_cfg(ttr)
    cam = jcam.canonical_camera(W, H)
    b = wide_batch()
    jbatch = jtr.Batch(t1=jnp.asarray(2, jnp.int32), t2=jnp.asarray(5, jnp.int32),
                       **{k: jnp.asarray(v) for k, v in b.items()})
    tbatch = ttr.Batch(t1=2, t2=5, **{k: torch.from_numpy(v) for k, v in b.items()})
    j_train, _, _ = jtr.make_train_step(jcfg, cam.extrinsic)
    t_train, _, _ = ttr.make_train_step(tcfg, cam.extrinsic, device="cpu")
    js0 = jtr.init_train_state(jcfg, scene_j)
    js1, jm = j_train(js0, jbatch)
    arrays = jax_state_arrays(js0)
    ts0 = convert.train_state_from_numpy(**arrays, device="cpu")
    ts1, tm = t_train(ts0, tbatch)
    return dict(js0=js0, js1=js1, jm=jm, ts0=ts0, ts1=ts1, tm=tm, arrays=arrays)


def test_wide_train_state_converts(wide_run):
    """`convert.train_state_from_numpy` carries the 32-wide attribute, its
    moments and the config's widths across."""
    ts0, arrays = wide_run["ts0"], wide_run["arrays"]
    assert ts0.scene.params["dino_attribute"].shape == (CAP, DINO)
    assert np.array_equal(ts0.scene.params["dino_attribute"].numpy(), arrays["params"]["dino_attribute"])
    assert ts0.opt_state.mu["dino_attribute"].shape == (CAP, DINO)
    assert dict(ts0.scene.cfg.render_attributes)["dino_attribute"] == DINO


@pytest.mark.parametrize("name", ["loss", "loss_rgb", "loss_mask_attr", "loss_dino_attr", "psnr",
                                  "num_intersections"])
def test_wide_train_step_metrics_match(wide_run, name):
    j, t = float(wide_run["jm"][name]), float(wide_run["tm"][name])
    assert np.isfinite(t)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["mu", "nu"])
def test_wide_train_step_adam_moments_match(wide_run, kind):
    """Every attribute's moment, the 32-wide DINO attribute's among them."""
    nonzero = set()
    js1, ts1 = wide_run["js1"], wide_run["ts1"]
    for name in sorted(js1.scene.params):
        jax_m = np.array(getattr(js1.opt_state.inner_states[name].inner_state[0], kind)[name])
        port_m = getattr(ts1.opt_state, kind)[name].numpy()
        scale = np.abs(jax_m).max()
        if scale > 0:
            nonzero.add(name)
        np.testing.assert_allclose(port_m, jax_m, rtol=G_RTOL, atol=G_ATOL * max(scale, 1e-30),
                                   err_msg=f"{kind}[{name}]")
    assert {"dino_attribute", "mask_attribute", "opacity", "position"} <= nonzero


def test_wide_train_step_params_and_densify_stats_match(wide_run):
    js1, ts1 = wide_run["js1"], wide_run["ts1"]
    compared = 0
    for name in sorted(js1.scene.params):
        g = np.array(js1.opt_state.inner_states[name].inner_state[0].mu[name]) / 0.1
        sel = np.abs(g) >= 1e-4 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
        np.testing.assert_allclose(ts1.scene.params[name].numpy()[sel], np.array(js1.scene.params[name])[sel],
                                   atol=1e-6, rtol=0, err_msg=name)
        compared += sel.sum()
    assert compared > 0
    for name in ("max_radii2d", "pos_grad_accum", "denom"):
        np.testing.assert_allclose(getattr(ts1.densify_state, name).numpy(),
                                   np.array(getattr(js1.densify_state, name)), rtol=1e-4, atol=1e-9,
                                   err_msg=name)
