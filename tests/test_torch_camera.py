"""Port parity for camera refinement on the CPU (JAX with Pallas in
interpret mode; the port with the plain versions of K1-K4):

  * `utils/pose`: `se3_exp`, `so3_exp`, `apply_se3_to_extrinsic` and their
    gradients at xi = 0, at a small angle (the Taylor branch) and at large
    angles, atol 1e-6; the qvec helpers atol 1e-6;
  * the twists' optax schedule (warm-up joined to a cosine decay) for
    k = 0..60 rtol 1e-6 (atol 2 ulps of the cosine), and the twists after the 61 Adam updates it
    drives atol 1e-6 x the sum of the 61 lrs (each update to rtol 1e-6);
  * 2 iterations of `refine_camera_poses` on 2 frames: the losses rtol
    1e-5, the twists atol 1e-6 + lr x 2e-3 after the second iteration (the
    second update carries the gradients' rtol 2e-3 bar, as in
    `test_torch_edit.py`);
  * 2 joint steps (`make_joint_train_step`, a 1-step warm-up: the first
    step freezes the scene and boosts the camera lr, the second does not),
    each fed the same JAX state: the twists' and the scene's Adam moments
    at the blend's gradient bars (atol 3e-4 of the largest, rtol 2e-3),
    the twists and params atol 1e-6 where the gradient is at least 1e-4 of
    its largest, the density statistics rtol 1e-4, the loss rtol 1e-5;
  * `fit_clip(refine_camera=True)` and `apps.train --refine_camera 1` run,
    and `--resume` restores the twists and their Adam state bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu.train import camera_refine as jcr
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu.utils import pose as jpose
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.apps import train as tapp
from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.ops import rasterize as tras
from splatter_a_video_tpu_torch.train import camera_refine as tcr
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import hooks as thooks
from splatter_a_video_tpu_torch.train import optim as topt
from splatter_a_video_tpu_torch.train import trainer as ttr
from splatter_a_video_tpu_torch.utils import pose as tpose

from test_torch_train_step import G_ATOL, G_RTOL, H, W, batch_arrays, jax_scene, jax_state_arrays, trainer_cfg

POSE_ATOL = 1e-6
TWISTS = {
    "zero": np.zeros(6),
    "small": np.array([1e-3, -2e-3, 5e-4, 3e-5, -4e-5, 2e-5]),   # theta^2 < 1e-8: Taylor
    "medium": np.array([0.01, -0.02, 0.015, 0.01, 0.01, -0.01]),
    "large": np.array([0.3, -0.2, 0.5, 1.1, -0.7, 0.4]),
    "pi": np.array([0.1, 0.2, -0.1, 0.0, 0.0, 3.1]),
}


@pytest.mark.parametrize("name", sorted(TWISTS))
def test_se3_exp_and_gradient_match(name):
    xi = TWISTS[name].astype(np.float32)
    extr = np.asarray(jcam.canonical_camera(W, H).extrinsic, np.float32)
    w = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    we = np.random.RandomState(1).randn(3, 4).astype(np.float32)

    jf = lambda x: (jnp.sum(jpose.se3_exp(x) * w) + jnp.sum(jpose.so3_exp(x[3:]) * w[:3, :3])
                    + jnp.sum(jpose.apply_se3_to_extrinsic(jnp.asarray(extr), x) * we))
    tf = lambda x: (torch.sum(tpose.se3_exp(x) * torch.from_numpy(w))
                    + torch.sum(tpose.so3_exp(x[3:]) * torch.from_numpy(w[:3, :3]))
                    + torch.sum(tpose.apply_se3_to_extrinsic(torch.from_numpy(extr), x) * torch.from_numpy(we)))
    x = torch.from_numpy(xi).requires_grad_(True)
    (g,) = torch.autograd.grad(tf(x), [x])
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(xi))), atol=POSE_ATOL)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(tpose.se3_exp(torch.from_numpy(xi)).numpy(),
                               np.asarray(jpose.se3_exp(jnp.asarray(xi))), atol=POSE_ATOL)
    np.testing.assert_allclose(tpose.so3_exp(torch.from_numpy(xi[3:])).numpy(),
                               np.asarray(jpose.so3_exp(jnp.asarray(xi[3:]))), atol=POSE_ATOL)
    batch = np.stack([xi, xi * 0.5]).astype(np.float32)
    np.testing.assert_allclose(tpose.se3_exp(torch.from_numpy(batch)).numpy(),
                               np.asarray(jpose.se3_exp(jnp.asarray(batch))), atol=POSE_ATOL)


def test_qvec_helpers_match():
    rng = np.random.RandomState(2)
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = tpose.qvec2rotmat(torch.from_numpy(q))
    np.testing.assert_allclose(R.numpy(), np.asarray(jpose.qvec2rotmat(jnp.asarray(q))), atol=POSE_ATOL)
    np.testing.assert_allclose(tpose.rotmat2qvec(R).numpy(), np.asarray(jpose.rotmat2qvec(jnp.asarray(R.numpy()))),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(tcr.refined_extrinsics(np.eye(3, 4), q[:3, :3].repeat(2, 1)),
                               jcr.refined_extrinsics(np.eye(3, 4), q[:3, :3].repeat(2, 1)), atol=POSE_ATOL)


@pytest.mark.parametrize("warmup,decay", [(0, 0), (10, 0), (0, 40), (10, 40)])
def test_schedule_and_updates_match_optax(warmup, decay):
    lr = 3e-4
    scheds, bounds = [], []
    if warmup:
        scheds.append(optax.constant_schedule(lr * 10.0))
        bounds.append(warmup)
    scheds.append(optax.cosine_decay_schedule(lr, decay) if decay else optax.constant_schedule(lr))
    sched = optax.join_schedules(scheds, bounds) if bounds else scheds[0]
    port = tcr.make_cam_optimizer(lr, warmup, decay_steps=decay)
    ks = range(61)
    j = np.array([np.float32(sched(jnp.asarray(k, jnp.int32))) for k in ks])
    t = np.array([port.schedule(k).item() for k in ks], np.float32)
    # rtol 1e-6, and 2 ulps of the cosine factor (|cos| <= 1) in absolute
    # terms: near the end of the decay 1 + cos cancels
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=lr * 2.0 ** -22)
    if decay:
        assert t[-1] < t[warmup] and t[warmup + decay] == 0.0

    # the Adam updates the schedule drives (optax reads sched(k) at update k)
    jopt = jcr.make_cam_optimizer(lr, warmup, decay_steps=decay)
    rng = np.random.RandomState(3)
    jxi = jnp.zeros((3, 6))
    jst = jopt.init(jxi)
    txi = torch.zeros((3, 6))
    tst = port.init(txi)
    for k in ks:
        g = rng.randn(3, 6).astype(np.float32)
        up, jst = jopt.update(jnp.asarray(g), jst, jxi)
        jxi = optax.apply_updates(jxi, up)
        txi, tst = port.update(torch.from_numpy(g), tst, txi)
    # each update agrees to rtol 1e-6 (float32 rounding of Adam's arithmetic,
    # bias corrections included), summed over the 61 updates
    np.testing.assert_allclose(txi.numpy(), np.asarray(jxi), rtol=0, atol=1e-6 * j.sum())
    np.testing.assert_allclose(tst.nu["xi"].numpy(), np.asarray(jst[0].nu), rtol=1e-6)
    assert tst.count == int(jst[0].count) == 61


@pytest.fixture(scope="module")
def scene_pair():
    js = jax_scene()
    return js, convert.scene_from_numpy({k: np.array(v) for k, v in js.params.items()},
                                        {k: np.array(v) for k, v in js.aux.items()},
                                        dataclasses.asdict(js.cfg), device="cpu")


def test_refine_camera_poses_matches(scene_pair):
    js, ts = scene_pair
    cam = jcam.canonical_camera(W, H)
    xi_true = np.array([[0.01, -0.01, 0.01, 0.01, 0.01, -0.01],
                        [-0.01, 0.01, 0.0, -0.01, 0.01, 0.01]], np.float32)
    rcfg = tras.RasterizeConfig(width=W, height=H, max_intersections=1 << 13)
    frames = np.stack([
        tras.render_gaussians(ts.get_position(float(t)), ts.get_scaling(), ts.get_rotation(float(t)),
                              ts.get_opacity(), ts.get_shs(),
                              tpose.apply_se3_to_extrinsic(torch.from_numpy(cam.extrinsic.astype(np.float32)),
                                                           torch.from_numpy(xi_true[t])), rcfg).features["rgb"].numpy()
        for t in range(2)])
    lr = 3e-3
    jxi, jinfo = jcr.refine_camera_poses(js, frames, cam.extrinsic,
                                         jras.RasterizeConfig(width=W, height=H, max_intersections=1 << 13),
                                         num_iters=2, lr=lr)
    txi, tinfo = tcr.refine_camera_poses(ts, frames, cam.extrinsic, rcfg, num_iters=2, lr=lr, device="cpu")
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(tinfo[k], jinfo[k], rtol=1e-5)
    assert tinfo["loss_last"] < tinfo["loss_first"]
    np.testing.assert_allclose(txi, jxi, atol=1e-6 + lr * G_RTOL, rtol=0)
    assert np.abs(txi).max() > lr


def _cam_arrays(cs):
    adam = cs.cam_opt_state[0]
    return dict(xi=np.array(cs.cam_xi), opt={"count": int(adam.count), "mu": np.array(adam.mu),
                                             "nu": np.array(adam.nu)})


@pytest.fixture(scope="module")
def joint(scene_pair):
    js, _ = scene_pair
    jcfg, tcfg = trainer_cfg(jtr), trainer_cfg(ttr)
    cam = jcam.canonical_camera(W, H)
    kw = dict(cam_lr=1e-3, cam_prior_weight=1e-2, cam_warmup_iters=1, cam_decay_steps=5)
    jstep = jcr.make_joint_train_step(jcfg, cam.extrinsic, **kw)
    tstep = tcr.make_joint_train_step(tcfg, cam.extrinsic, device="cpu", **kw)
    b = batch_arrays()
    pairs = [(2, 5), (6, 1)]
    jstates = [jcr.init_cam_train_state(jcfg, js, cam_lr=1e-3, cam_warmup_iters=1, cam_decay_steps=5)]
    # a non-zero start for the twists, so that both frames' twists move the render
    xi0 = np.random.RandomState(5).uniform(-0.01, 0.01, (jcfg.num_frames, 6)).astype(np.float32)
    jstates[0] = jstates[0]._replace(cam_xi=jnp.asarray(xi0))
    out = []
    for (t1, t2), js_in in zip(pairs, jstates * 2):
        jb = jtr.Batch(t1=jnp.asarray(t1, jnp.int32), t2=jnp.asarray(t2, jnp.int32),
                       **{k: jnp.asarray(v) for k, v in b.items()})
        tb = ttr.Batch(t1=t1, t2=t2, **{k: torch.from_numpy(v) for k, v in b.items()})
        js_in = out[-1][1] if out else js_in
        js_out, jm = jstep(js_in, jb)
        base = convert.train_state_from_numpy(**jax_state_arrays(js_in.base), device="cpu")
        xi, cam_opt = convert.cam_state_from_numpy(**_cam_arrays(js_in), device="cpu")
        ts_out, tm = tstep(tcr.CamTrainState(base, xi, cam_opt), tb)
        out.append((js_in, js_out, jm, ts_out, tm))
    return out


@pytest.mark.parametrize("k", [0, 1], ids=["warmup", "after_warmup"])
def test_joint_step_matches(joint, k):
    js_in, js_out, jm, ts_out, tm = joint[k]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    # the twists' Adam moments and the twists
    adam = js_out.cam_opt_state[0]
    g = (np.array(adam.mu) - 0.9 * np.array(js_in.cam_opt_state[0].mu)) / 0.1
    for kind in ("mu", "nu"):
        j = np.array(getattr(adam, kind))
        np.testing.assert_allclose(getattr(ts_out.cam_opt_state, kind)["xi"].numpy(), j,
                                   rtol=G_RTOL, atol=G_ATOL * np.abs(j).max(), err_msg=kind)
    sel = np.abs(g) >= 1e-4 * np.abs(g).max()
    assert sel[[2, 5] if k == 0 else [6, 1]].sum() >= 6
    np.testing.assert_allclose(ts_out.cam_xi.numpy()[sel], np.array(js_out.cam_xi)[sel], atol=1e-6, rtol=0)
    assert ts_out.cam_opt_state.count == k + 1
    # the scene: frozen in the warm-up step, trained after it
    base_in = js_in.base
    inner = js_out.base.opt_state.inner_states
    moved = 0
    for name in js_out.base.scene.params:
        jmu = np.array(inner[name].inner_state[0].mu[name])
        tmu = ts_out.base.opt_state.mu[name].numpy()
        np.testing.assert_allclose(tmu, jmu, rtol=G_RTOL, atol=G_ATOL * max(np.abs(jmu).max(), 1e-30),
                                   err_msg=name)
        gs = (jmu - 0.9 * np.array(base_in.opt_state.inner_states[name].inner_state[0].mu[name])) / 0.1
        sel = np.abs(gs) >= 1e-4 * np.abs(gs).max() if np.abs(gs).max() > 0 else np.zeros(gs.shape, bool)
        np.testing.assert_allclose(ts_out.base.scene.params[name].numpy()[sel],
                                   np.array(js_out.base.scene.params[name])[sel], atol=1e-6, rtol=0, err_msg=name)
        moved += int(np.abs(jmu).max() > 0)
    assert moved == (0 if k == 0 else 7)
    for name in ("max_radii2d", "pos_grad_accum", "denom"):
        np.testing.assert_allclose(getattr(ts_out.base.densify_state, name).numpy(),
                                   np.array(getattr(js_out.base.densify_state, name)), rtol=1e-4, atol=1e-9)
    assert np.array_equal(ts_out.base.key.numpy(), np.array(js_out.base.key))


def _fit_cfgs(num_iters, out_every=2):
    fcfg = tfit.FitConfig(num_iters=num_iters, num_fg_samples=150, num_bg_samples=150, num_track_samples=32,
                          log_every=out_every, refine_camera=True, camera_lr=1e-3, camera_warmup=2)
    tcfg = ttr.TrainerConfig(width=64, height=48, num_frames=12, num_track_samples=32,
                             max_intersections=1 << 14, arap_sample_num=32, max_steps=num_iters,
                             optim=topt.OptimConfig(max_steps=num_iters),
                             densify=tden.DensifyConfig(densify_start_iter=10 ** 9))
    return fcfg, tcfg


def test_fit_clip_refine_camera_resumes_twists(tmp_path):
    torch.set_num_threads(1)
    clip = tsyn.make_clip(tsyn.SyntheticClipConfig())
    out = str(tmp_path)
    hooks = [thooks.CheckPointHook(every=2)]
    _, hist = tfit.fit_clip(clip, *_fit_cfgs(4), hooks=hooks, out_dir=out, device="cpu")
    assert np.isfinite(hist[-1]["loss"]) and hist[-1]["cam_xi_norm"] > 0
    saved = torch.load(tmp_path / "camera_refine.pt", weights_only=True)
    assert saved["count"] == 4 and np.array_equal(np.load(tmp_path / "camera_xi.npy"), saved["xi"].numpy())
    # a resume at the last step restores the twists and writes them back unchanged
    (tmp_path / "camera_xi.npy").unlink()
    tfit.fit_clip(clip, *_fit_cfgs(4), hooks=hooks, out_dir=out, resume=True, device="cpu")
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "camera_xi.npy")), saved["xi"])
    again = torch.load(tmp_path / "camera_refine.pt", weights_only=True)
    assert all(torch.equal(again[k], saved[k]) for k in ("xi", "mu", "nu")) and again["count"] == 4
    # and training continues from them
    _, hist = tfit.fit_clip(clip, *_fit_cfgs(6), hooks=hooks, out_dir=out, resume=True, device="cpu")
    assert [m["step"] for m in hist] == [6]
    after = torch.load(tmp_path / "camera_refine.pt", weights_only=True)
    assert after["count"] == 6 and not torch.equal(after["xi"], saved["xi"])


def test_train_cli_refine_camera(tmp_path, capsys):
    torch.set_num_threads(1)
    out = tmp_path / "run"
    state = tapp.main(["--synthetic", "--device", "cpu", "--num_iters", "2", "--i_print", "1",
                       "--tensorboard", "0", "--out_dir", str(out), "--max_intersections", str(1 << 14),
                       "--num_track_samples", "32", "--refine_camera", "1", "--camera_warmup", "1"])
    assert state.step == 2
    xi = np.load(out / "camera_xi.npy")
    assert xi.shape == (12, 6) and np.isfinite(xi).all() and np.abs(xi).max() > 0
