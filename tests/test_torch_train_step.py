"""Port parity for the training slice as a whole: one `make_train_step`
train step, then a density step and an opacity reset, on the same 64x48
scene (256 slots, 120 alive, cubic-spline trajectories) and batch in both
packages. JAX runs on the CPU with Pallas in interpret mode; the port on
the CPU runs the plain versions of K1-K4. The JAX random draws (ARAP
samples, split noise) are reproduced from the JAX key and handed to the
port, and the port's own key draws them too (`train/prng.py`). The JAX
step is compiled once for the module (about 40 s on a CPU).

Tolerances: the loss terms rtol 1e-5; the Adam moments (mu = 0.1 g and
nu = 0.001 g^2 after one step) at the blend's gradient bars, atol 3e-4 and
rtol 2e-3 relative to each attribute's largest gradient; updated params
atol 1e-6 where |g| >= 1e-4 max|g| (Adam's first step is close to
lr * sign(g), so entries with near-zero gradients may move either way);
densification statistics rtol 1e-4; the density and reset steps, fed the
same state, agree to atol 1e-6 with equal alive masks and counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import trainer as ttr

W, H, T = 64, 48, 8
CAP, ALIVE, P = 256, 120, 16
G_ATOL, G_RTOL = 3e-4, 2e-3


def jax_scene():
    rng = np.random.RandomState(0)
    cfg = jgs.SceneConfig(
        capacity=CAP, num_frames=T, traj="cubic_spline",
        render_attributes=(("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", 3)),
    )
    pos = np.concatenate(
        [rng.uniform(-0.8, 0.8, (ALIVE, 2)), rng.uniform(0.8, 1.4, (ALIVE, 1))], 1
    ).astype(np.float32)
    t = np.linspace(0, 1, T, dtype=np.float32)[:, None, None]
    track = (pos[None] + 0.05 * np.sin(3.0 * t + rng.uniform(0, 6, (1, ALIVE, 3)))).astype(np.float32)
    track = track - (track[0] - pos)[None]
    colors = rng.uniform(0, 1, (ALIVE, 3)).astype(np.float32)
    s = jgs.create_scene(cfg, pos, colors, init_opacity=0.3, track_seq=track)
    params = {k: np.array(v) for k, v in s.params.items()}
    params["scaling"][:ALIVE] = np.log(rng.uniform(0.02, 0.06, (ALIVE, 3))).astype(np.float32)
    params["rotation"][:ALIVE] = rng.randn(ALIVE, 4).astype(np.float32)
    params["opacity"][:ALIVE] = rng.uniform(-1.5, 1.5, (ALIVE, 1)).astype(np.float32)
    params["features_rest"][:ALIVE] = (rng.randn(ALIVE, 15, 3) * 0.1).astype(np.float32)
    return s.replace(params={k: jnp.asarray(v) for k, v in params.items()})


def trainer_cfg(mod):
    return mod.TrainerConfig(
        width=W, height=H, num_frames=T, max_intersections=1 << 13, num_track_samples=P,
        arap_sample_num=32,
        optim=mod._optim.OptimConfig(max_steps=200),
        densify=mod._density.DensifyConfig(densify_start_iter=0, duplicate_interval=1, min_opacity=0.1,
                                           densify_grad_threshold=2e-5, percent_dense=0.008),
    )


def batch_arrays():
    rng = np.random.RandomState(1)
    xx = np.linspace(0, 1, W, dtype=np.float32)[None, :, None]
    yy = np.linspace(0, 1, H, dtype=np.float32)[:, None, None]
    rgb = np.concatenate([xx + 0 * yy, yy + 0 * xx, 0.5 * (xx + yy)], axis=2).astype(np.float32)
    depth = (0.5 + 1.5 * yy[..., 0] + 0 * xx[..., 0]).astype(np.float32)
    qp = np.stack([rng.randint(0, W, P), rng.randint(0, H, P)], 1).astype(np.float32)
    tt = np.concatenate([qp + rng.randn(P, 2), rng.uniform(-6, 1, (P, 2))], 1).astype(np.float32)
    valid = np.arange(P) < P - 2
    return dict(rgb1=rgb, depth1=depth, query_px=qp, target_tracks=tt, track_valid=valid)


def jax_state_arrays(state):
    """The port's train-state carry of a JAX TrainState, key included."""
    inner = state.opt_state.inner_states
    adam = {k: v.inner_state[0] for k, v in inner.items()}
    counts = {int(a.count) for a in adam.values()}
    assert len(counts) == 1
    sc = state.scene
    return dict(
        params={k: np.array(v) for k, v in sc.params.items()},
        aux={k: np.array(v) for k, v in sc.aux.items()},
        cfg=dataclasses.asdict(sc.cfg),
        opt={"count": counts.pop(),
             "mu": {k: np.array(a.mu[k]) for k, a in adam.items()},
             "nu": {k: np.array(a.nu[k]) for k, a in adam.items()}},
        densify={k: np.array(v) for k, v in state.densify_state._asdict().items()},
        step=int(state.step),
        key=np.array(state.key),
    )


@pytest.fixture(scope="module")
def run():
    scene = jax_scene()
    jcfg, tcfg = trainer_cfg(jtr), trainer_cfg(ttr)
    cam = jcam.canonical_camera(W, H)
    b = batch_arrays()
    jbatch = jtr.Batch(t1=jnp.asarray(2, jnp.int32), t2=jnp.asarray(5, jnp.int32),
                       **{k: jnp.asarray(v) for k, v in b.items()})
    tbatch = ttr.Batch(t1=2, t2=5, **{k: torch.from_numpy(v) for k, v in b.items()})
    j_train, j_density, j_reset = jtr.make_train_step(jcfg, cam.extrinsic)
    t_train, t_density, t_reset = ttr.make_train_step(tcfg, cam.extrinsic, device="cpu")

    js0 = jtr.init_train_state(jcfg, scene)
    # the JAX step's ARAP draw, reproduced from its key
    _, sub = jax.random.split(js0.key)
    alive = js0.scene.alive.astype(jnp.float32)
    arap_idx = jax.random.choice(sub, CAP, (32,), replace=True, p=alive / jnp.maximum(alive.sum(), 1.0))

    # the JAX gradient of the step's loss, for the comparison of moments
    js1, jm = j_train(js0, jbatch)
    ts0 = convert.train_state_from_numpy(**jax_state_arrays(js0), device="cpu")
    ts1, tm = t_train(ts0, tbatch, arap_idx=torch.from_numpy(np.array(arap_idx)))

    # density and reset from the same (JAX) state in both packages
    _, dsub = jax.random.split(js1.key)
    noise = jax.random.normal(dsub, (CAP, 3))
    js2, jinfo = j_density(js1)
    ts1j = convert.train_state_from_numpy(**jax_state_arrays(js1), device="cpu")
    ts2, tinfo = t_density(ts1j, noise=torch.from_numpy(np.array(noise)))
    js3 = j_reset(js2)
    ts3 = t_reset(convert.train_state_from_numpy(**jax_state_arrays(js2), device="cpu"))
    # the same steps drawing from the port's own key
    ts1_own, _ = t_train(ts0, tbatch)
    ts2_own, tinfo_own = t_density(ts1j)
    return dict(js0=js0, js1=js1, jm=jm, ts1=ts1, tm=tm, js2=js2, jinfo=jinfo, ts2=ts2,
                tinfo=tinfo, js3=js3, ts3=ts3, ts1_own=ts1_own, ts2_own=ts2_own, tinfo_own=tinfo_own)


@pytest.mark.parametrize("name", ["loss", "loss_rgb", "loss_flow", "loss_depth", "loss_arap",
                                  "psnr", "num_intersections"])
def test_train_step_metrics_match(run, name):
    j, t = float(run["jm"][name]), float(run["tm"][name])
    assert np.isfinite(t)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)


def _attrs(run):
    return sorted(run["js1"].scene.params)


def _jax_grad(run, name):
    """g from the JAX moments after one step: mu = (1 - b1) g."""
    mu = run["js1"].opt_state.inner_states[name].inner_state[0].mu[name]
    return np.array(mu) / 0.1


@pytest.mark.parametrize("kind", ["mu", "nu"])
def test_train_step_adam_moments_match(run, kind):
    nonzero = 0
    for name in _attrs(run):
        jax_m = np.array(getattr(run["js1"].opt_state.inner_states[name].inner_state[0], kind)[name])
        port_m = getattr(run["ts1"].opt_state, kind)[name].numpy()
        scale = np.abs(jax_m).max()
        nonzero += scale > 0
        np.testing.assert_allclose(port_m, jax_m, rtol=G_RTOL, atol=G_ATOL * max(scale, 1e-30),
                                   err_msg=f"{kind}[{name}]")
    assert run["ts1"].opt_state.count == 1
    # position, pos_cubic_coeff, scaling, rotation, opacity and both SH groups
    assert nonzero == 7


def test_train_step_params_match_where_gradient_is_clear(run):
    compared = total = 0
    for name in _attrs(run):
        g = _jax_grad(run, name)
        sel = np.abs(g) >= 1e-4 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
        j = np.array(run["js1"].scene.params[name])
        t = run["ts1"].scene.params[name].numpy()
        np.testing.assert_allclose(t[sel], j[sel], atol=1e-6, rtol=0, err_msg=name)
        compared += sel.sum()
        total += g.size
    assert compared > 0.05 * total, f"compared {compared} of {total} entries"


def test_train_step_densify_stats_match(run):
    for name in ("max_radii2d", "pos_grad_accum", "denom"):
        np.testing.assert_allclose(
            getattr(run["ts1"].densify_state, name).numpy(),
            np.array(getattr(run["js1"].densify_state, name)), rtol=1e-4, atol=1e-9, err_msg=name)
    assert run["ts1"].step == 1


def test_density_step_matches(run):
    for f in tden.DensifyInfo._fields:
        assert int(getattr(run["tinfo"], f)) == int(getattr(run["jinfo"], f)), f
    assert int(run["tinfo"].num_cloned) > 0 and int(run["tinfo"].num_split) > 0
    np.testing.assert_array_equal(run["ts2"].scene.alive.numpy(), np.array(run["js2"].scene.alive))
    for name in _attrs(run):
        np.testing.assert_allclose(run["ts2"].scene.params[name].numpy(),
                                   np.array(run["js2"].scene.params[name]), atol=1e-6, err_msg=name)
        inner = run["js2"].opt_state.inner_states[name].inner_state[0]
        np.testing.assert_array_equal(run["ts2"].opt_state.mu[name].numpy(), np.array(inner.mu[name]))
    for name in tden.DensifyState._fields:
        assert float(getattr(run["ts2"].densify_state, name).abs().sum()) == 0.0


def test_opacity_reset_matches(run):
    np.testing.assert_allclose(run["ts3"].scene.params["opacity"].numpy(),
                               np.array(run["js3"].scene.params["opacity"]), atol=1e-6)
    inner = run["js3"].opt_state.inner_states["opacity"].inner_state[0]
    assert float(np.abs(np.array(inner.mu["opacity"])).sum()) == 0.0
    assert float(run["ts3"].opt_state.mu["opacity"].abs().sum()) == 0.0
    np.testing.assert_array_equal(run["ts3"].opt_state.mu["position"].numpy(),
                                  np.array(run["js3"].opt_state.inner_states["position"].inner_state[0].mu["position"]))


def test_train_state_round_trip(run):
    arrays = convert.train_state_to_numpy(run["ts1"])
    back = convert.train_state_from_numpy(**arrays, device="cpu")
    for k, v in run["ts1"].opt_state.nu.items():
        assert torch.equal(back.opt_state.nu[k], v)
    assert back.step == 1 and back.opt_state.count == 1


def test_steps_draw_what_the_jax_steps_draw(run):
    """Without injected draws the port splits its key as the JAX steps split
    theirs: the train step draws JAX's ARAP samples (the same step, bit for
    bit, as with the injected draw) and the density step JAX's split noise
    (within float32 rounding of erfinv: atol 1e-6 on the params)."""
    for name, v in run["ts1"].scene.params.items():
        assert torch.equal(run["ts1_own"].scene.params[name], v), name
    assert np.array_equal(run["ts1_own"].key.numpy(), np.array(run["js1"].key))
    assert np.array_equal(run["ts2_own"].key.numpy(), np.array(run["js2"].key))
    for f in tden.DensifyInfo._fields:
        assert int(getattr(run["tinfo_own"], f)) == int(getattr(run["jinfo"], f)), f
    np.testing.assert_array_equal(run["ts2_own"].scene.alive.numpy(), np.array(run["js2"].scene.alive))
    for name in _attrs(run):
        np.testing.assert_allclose(run["ts2_own"].scene.params[name].numpy(),
                                   np.array(run["js2"].scene.params[name]), atol=1e-6, err_msg=name)
