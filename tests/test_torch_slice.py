"""Port parity for the whole render slice: a JAX `GaussianScene` carried into
the port with `scene_from_numpy`, rendered by both packages'
`inference.render_video` on the CPU (atol 2e-5 on every channel), and the
trajectory evaluators it runs (atol 1e-6 / rtol 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu import inference as jinf
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.models import trajectory as jtr
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch import inference as tinf
from splatter_a_video_tpu_torch.models import camera as tcam
from splatter_a_video_tpu_torch.models import trajectory as ttr
from splatter_a_video_tpu_torch.ops import rasterize as tras

W, H = 64, 48
FRAMES = 10
CAP, ALIVE = 256, 150
EXTRA = ("mask_attribute", "pos_poly_feat", "dino_attribute")
ATOL = 2e-5


def jax_scene(traj, seed=0):
    """A JAX scene with seeded, non-trivial values in every attribute."""
    rng = np.random.RandomState(seed)
    cfg = jgs.SceneConfig(
        capacity=CAP, num_frames=FRAMES, traj=traj,
        render_attributes=(("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", 3)),
    )
    pos = np.concatenate(
        [rng.uniform(-0.8, 0.8, (ALIVE, 2)), rng.uniform(0.5, 2.0, (ALIVE, 1))], 1
    ).astype(np.float32)
    t = np.linspace(0, 1, FRAMES, dtype=np.float32)[:, None, None]
    track = pos[None] + 0.05 * np.sin(2 * np.pi * t + rng.uniform(0, 6, (1, ALIVE, 3)))
    track = (track - (track[0] - pos)[None]).astype(np.float32)
    s = jgs.create_scene(cfg, pos, track_seq=track if traj == "cubic_spline" else None,
                         key=jax.random.PRNGKey(seed))
    params = {k: np.array(v) for k, v in s.params.items()}
    live = slice(0, ALIVE)
    params["scaling"][live] = rng.uniform(-3.5, -2.0, (ALIVE, 3))
    params["rotation"][live] = rng.randn(ALIVE, 4)
    params["opacity"][live] = rng.uniform(-1.5, 2.5, (ALIVE, 1))
    params["features_dc"][live] = rng.randn(ALIVE, 1, 3) * 0.5
    params["features_rest"][live] = rng.randn(ALIVE, 15, 3) * 0.2
    for k in ("pos_poly_feat", "pos_fourier_feat", "rot_poly_feat", "rot_fourier_feat"):
        params[k][live] = rng.randn(*params[k][live].shape) * 0.02
    params["mask_attribute"][live] = rng.randn(ALIVE, 1)
    params["dino_attribute"][live] = rng.randn(ALIVE, 3)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    aux = {k: np.array(v) for k, v in s.aux.items()}
    return jgs.GaussianScene(params={k: jnp.asarray(v) for k, v in params.items()},
                             aux={k: jnp.asarray(v) for k, v in aux.items()}, cfg=cfg), params, aux


@pytest.mark.parametrize("traj", ["cubic_spline", "poly_fourier"])
def test_render_video_matches_jax(traj):
    js, params, aux = jax_scene(traj)
    ts = convert.scene_from_numpy(params, aux, dataclasses.asdict(js.cfg), device="cpu")
    times = [0, 1.5, FRAMES - 1]
    jout = jinf.render_video(
        js, jcam.canonical_camera(W, H),
        jras.RasterizeConfig(width=W, height=H, max_intersections=1 << 14, sort_mode="exact"),
        times, extra_names=EXTRA,
    )
    tout = tinf.render_video(
        ts, tcam.canonical_camera(W, H),
        tras.RasterizeConfig(width=W, height=H, max_intersections=1 << 14),
        times, extra_names=EXTRA, device="cpu",
    )
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        np.testing.assert_allclose(tout[k], jout[k], atol=ATOL, err_msg=k)
    # the scene really moves and covers the frame
    assert np.abs(tout["rgb"][0] - tout["rgb"][-1]).max() > 0.01
    assert (tout["depth"][0] < 0.99).mean() > 0.05


def test_scene_roundtrip_and_checks():
    js, params, aux = jax_scene("cubic_spline", seed=1)
    cfg = dataclasses.asdict(js.cfg)
    ts = convert.scene_from_numpy(params, aux, cfg, device="cpu")
    p2, a2, c2 = convert.scene_to_numpy(ts)
    assert c2 == cfg
    for src, back in ((params, p2), (aux, a2)):
        assert sorted(src) == sorted(back)
        for k in src:
            assert back[k].dtype == src[k].dtype
            np.testing.assert_array_equal(back[k], src[k])
    assert int(ts.num_alive) == ALIVE

    bad_shape = dict(params, opacity=params["opacity"][:, 0])
    bad_dtype = dict(params, scaling=params["scaling"].astype(np.float64))
    missing = {k: v for k, v in params.items() if k != "dino_attribute"}
    for bad in (bad_shape, bad_dtype, missing):
        with pytest.raises(ValueError):
            convert.scene_from_numpy(bad, aux, cfg, device="cpu")
    with pytest.raises(ValueError):
        convert.scene_from_numpy(params, {"alive": aux["alive"]}, cfg, device="cpu")


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_trajectories_match_jax(t):
    rng = np.random.RandomState(3)
    n, k = 40, 5
    pos = rng.randn(n, 3).astype(np.float32)
    poly, four = rng.randn(n, 4, 3).astype(np.float32), rng.randn(n, 8, 3).astype(np.float32)
    rpoly, rfour = rng.randn(n, 4, 4).astype(np.float32), rng.randn(n, 8, 4).astype(np.float32)
    logits = rng.randn(n, k).astype(np.float32)
    bpoly, bfour = rng.randn(k, 4, 3).astype(np.float32), rng.randn(k, 8, 3).astype(np.float32)
    track = (pos[None] + 0.1 * rng.randn(FRAMES, n, 3)).astype(np.float32)
    coeff, knots = jtr.fit_cubic_spline(track)
    coeff_t, knots_t = ttr.fit_cubic_spline(track)
    np.testing.assert_array_equal(coeff_t, coeff)
    np.testing.assert_array_equal(knots_t, knots)
    J = lambda *a: [jnp.asarray(x) for x in a]
    T = lambda *a: [torch.from_numpy(x) for x in a]
    pairs = [
        (jtr.position_poly_fourier(*J(pos, poly, four), t), ttr.position_poly_fourier(*T(pos, poly, four), t)),
        (jtr.rotation_poly_fourier(*J(pos[:, :1].repeat(4, 1), rpoly, rfour), t),
         ttr.rotation_poly_fourier(*T(pos[:, :1].repeat(4, 1), rpoly, rfour), t)),
        (jtr.position_lbs(*J(pos, logits, bpoly, bfour), t), ttr.position_lbs(*T(pos, logits, bpoly, bfour), t)),
        (jtr.position_cubic_spline(*J(pos, coeff, knots), t), ttr.position_cubic_spline(*T(pos, coeff, knots), t)),
    ]
    for j, p in pairs:
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-6, rtol=1e-5)
