"""The fit path of the port on the CPU: `fit_clip` against the JAX
package's, then the port's hooks, checkpoints, resume, training CLI and
tracking evaluation.

Parity (JAX on the CPU, Pallas in interpret mode; the port on the CPU runs
the plain versions of K1-K4): both packages fit the default 64x48x12
synthetic clip for 4 steps from byte-identical scenes, pairs and track
batches, once with ARAP off and no density event, once with ARAP and a
density event at step 3, whose samples and split noise both packages
draw from their keys (the port with its copy of JAX's generator). The JAX
fit of each runs once for the module.

Tolerances: per-step loss, loss_rgb, psnr and alive rtol 1e-4. The end
state at the bars of `test_torch_train_step.py`: Adam moments atol 3e-4
relative to each attribute's largest moment, rtol 2e-3; the params'
change over the fit atol 1e-6 where the JAX first moment is at least 1e-4
of its attribute's largest (Adam's steps follow the sign of near-zero
gradients, which may differ). The change, not the params: the initial
scaling differs by the kNN rounding that `test_torch_data.py` bounds, and
so the change is compared on the slots alive at the start (a density
event's children copy a parent's scaling, init difference included).
With ARAP on, the bars are atol 2e-6 on the change and rtol 1e-3 on the
densification statistics: ARAP's gradients agree only to rtol 1e-3
(`test_torch_train_ops.py`, the batched SVD), which moved 2 of 461
compared spline coefficients by 1.13e-6 and one accumulated viewspace
gradient by 1.2e-4 relative (measured);
densification statistics rtol 1e-4. `track_correspondences` at 64x48:
predicted pixels atol 1e-3 px (the blend's 2e-5 bar on normalised
coordinates times W / 2 = 32); occlusion equal wherever moving the
tolerance by 1e-4 does not change the port's answer.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from splatter_a_video_tpu import inference as jinf
from splatter_a_video_tpu.data import synthetic as jsyn
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu.train import density as jden
from splatter_a_video_tpu.train import fit as jfit
from splatter_a_video_tpu.train import optim as jopt
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch import inference as tinf
from splatter_a_video_tpu_torch.apps import train as tapp
from splatter_a_video_tpu_torch.apps import train_state_io
from splatter_a_video_tpu_torch.data import pairs as tpairs
from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.eval import tapvid as ttap
from splatter_a_video_tpu_torch.models import camera as tcam
from splatter_a_video_tpu_torch.ops import rasterize as tras
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import hooks as thooks
from splatter_a_video_tpu_torch.train import optim as topt
from splatter_a_video_tpu_torch.train import trainer as ttr
from splatter_a_video_tpu_torch.utils import checkpoint as tckpt

W, H, T = 64, 48, 12
STEPS = 4
MAXI = 1 << 14
G_ATOL, G_RTOL = 3e-4, 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU steps are many small ops; one thread each keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VARIANTS = {
    # no random draw reaches the losses
    "plain": dict(arap_weight=0.0),
    # ARAP samples every step and a density event at step 3 (split noise),
    # both drawn from each package's key
    "arap_density": dict(arap_weight=1e-3, densify=dict(densify_start_iter=2, duplicate_interval=3,
                                                        densify_grad_threshold=2e-5)),
}


def fit_cfgs(fit, tr, opt, den, variant="plain", steps=STEPS):
    v = VARIANTS[variant]
    fcfg = fit.FitConfig(num_iters=steps, num_fg_samples=100, num_bg_samples=100,
                         num_track_samples=64, log_every=1)
    tcfg = tr.TrainerConfig(width=W, height=H, num_frames=T, num_track_samples=64, max_intersections=MAXI,
                            arap_sample_num=64, arap_weight=v["arap_weight"],
                            densify=den.DensifyConfig(**v.get("densify", {})),
                            optim=opt.OptimConfig(max_steps=steps))
    return fcfg, tcfg


@pytest.fixture(scope="module")
def clip():
    return tsyn.make_clip(tsyn.SyntheticClipConfig())


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def fits(clip, request):
    jclip = jsyn.make_clip(jsyn.SyntheticClipConfig())
    js, jh = jfit.fit_clip(jclip, *fit_cfgs(jfit, jtr, jopt, jden, request.param))
    ts, th = tfit.fit_clip(clip, *fit_cfgs(tfit, ttr, topt, tden, request.param), device="cpu")
    return js, jh, ts, th, jclip, request.param


@pytest.fixture(scope="module")
def initial_params(fits, clip):
    """Each package's initial scene params of the parity fit."""
    j = jfit.build_scene_from_clip(fits[4], fit_cfgs(jfit, jtr, jopt, jden)[0])[0]
    t = tfit.build_scene_from_clip(clip, fit_cfgs(tfit, ttr, topt, tden)[0], device="cpu")[0]
    return ({"_alive": np.array(j.alive), **{k: np.array(v) for k, v in j.params.items()}},
            {k: v.numpy() for k, v in t.params.items()})


@pytest.mark.parametrize("name", ["loss", "loss_rgb", "psnr", "alive"])
def test_fit_history_matches(fits, name):
    _, jh, _, th, _, variant = fits
    assert [m["step"] for m in th] == [m["step"] for m in jh] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([m[name] for m in th], [m[name] for m in jh], rtol=1e-4, atol=0)
    assert th[-1]["timing"]["steady_includes_hooks"]
    if variant == "plain":
        assert "densify" not in th[-1]
    else:
        assert th[-1]["densify_totals"] == jh[-1]["densify_totals"]
        assert th[-1]["densify_totals"]["events"] == 1 and th[-1]["alive"] > th[0]["alive"]


def jax_state_arrays(state):
    """The port's train-state carry of a JAX TrainState."""
    adam = {k: v.inner_state[0] for k, v in state.opt_state.inner_states.items()}
    counts = {int(a.count) for a in adam.values()}
    assert len(counts) == 1
    sc = state.scene
    return dict(
        params={k: np.array(v) for k, v in sc.params.items()},
        aux={k: np.array(v) for k, v in sc.aux.items()},
        cfg=dataclasses.asdict(sc.cfg),
        opt={"count": counts.pop(), "mu": {k: np.array(a.mu[k]) for k, a in adam.items()},
             "nu": {k: np.array(a.nu[k]) for k, a in adam.items()}},
        densify={k: np.array(v) for k, v in state.densify_state._asdict().items()},
        step=int(state.step),
        key=np.array(state.key),
    )


def test_fit_end_state_matches(fits, initial_params):
    js, _, ts, _, _, variant = fits
    p_atol, s_rtol = (1e-6, 1e-4) if variant == "plain" else (2e-6, 1e-3)
    j, t = jax_state_arrays(js), convert.train_state_to_numpy(ts)
    assert np.array_equal(t["key"], j["key"])
    j0, t0 = initial_params
    assert t["step"] == j["step"] == STEPS and t["opt"]["count"] == j["opt"]["count"] == STEPS
    assert t["cfg"] == j["cfg"]
    assert np.array_equal(t["aux"]["alive"], j["aux"]["alive"])
    born_alive = np.asarray(j0["_alive"])   # slots filled by a density event copy a parent instead
    compared = total = 0
    for name, jp in j["params"].items():
        for kind in ("mu", "nu"):
            jm = j["opt"][kind][name]
            np.testing.assert_allclose(t["opt"][kind][name], jm, rtol=G_RTOL,
                                       atol=G_ATOL * max(np.abs(jm).max(), 1e-30), err_msg=f"{kind}[{name}]")
        mu = np.abs(j["opt"]["mu"][name])
        sel = mu >= 1e-4 * mu.max() if mu.max() > 0 else np.zeros(mu.shape, bool)
        sel &= born_alive.reshape((-1,) + (1,) * (sel.ndim - 1))
        np.testing.assert_allclose((t["params"][name] - t0[name])[sel], (jp - j0[name])[sel], atol=p_atol,
                                   rtol=0, err_msg=name)
        compared += sel.sum()
        total += sel.size
    assert compared > 0.05 * total
    for name in tden.DensifyState._fields:
        np.testing.assert_allclose(t["densify"][name], j["densify"][name], rtol=s_rtol, atol=1e-9, err_msg=name)


@pytest.fixture(scope="module")
def tracked_scene(fits):
    """The JAX fit's end scene in both packages."""
    js = fits[0].scene
    ts = convert.scene_from_numpy({k: np.array(v) for k, v in js.params.items()},
                                  {k: np.array(v) for k, v in js.aux.items()},
                                  dataclasses.asdict(js.cfg), device="cpu")
    return js, ts


@pytest.mark.parametrize("t2", [0.0, 5.0, 11.0])
def test_track_correspondences_match(clip, tracked_scene, t2):
    js, ts = tracked_scene
    q = clip.load_target_tracks(0, [0])[:, 0, :2]
    jr = jras.RasterizeConfig(width=W, height=H, max_intersections=MAXI)
    tr = tras.RasterizeConfig(width=W, height=H, max_intersections=MAXI)
    jpx, jocc = jinf.track_correspondences(js, 0.0, q, t2, jcam.canonical_camera(W, H), jr)
    args = (ts, 0.0, q, t2, tcam.canonical_camera(W, H), tr)
    tpx, tocc = tinf.track_correspondences(*args, device="cpu")
    np.testing.assert_allclose(tpx, np.asarray(jpx), atol=1e-3, rtol=0)
    lo = tinf.track_correspondences(*args, occlusion_eps=0.02 - 1e-4, device="cpu")[1]
    hi = tinf.track_correspondences(*args, occlusion_eps=0.02 + 1e-4, device="cpu")[1]
    stable = lo == hi
    assert stable.mean() > 0.9
    assert np.array_equal(tocc[stable], np.asarray(jocc)[stable])


def test_gaussian_trajectories_match(tracked_scene):
    js, ts = tracked_scene
    j = jinf.gaussian_trajectories(js, [0, 3.5, 11], sample=20)
    t = tinf.gaussian_trajectories(ts, [0, 3.5, 11], sample=20, device="cpu")
    assert t.shape == (20, 3, 3)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_evaluate_scene_tracking_runs(clip, tracked_scene):
    m = ttap.evaluate_scene_tracking(tracked_scene[1], clip, tcam.canonical_camera(W, H),
                                     tras.RasterizeConfig(width=W, height=H, max_intersections=MAXI),
                                     num_queries=32, device="cpu")
    assert 0 <= m["average_jaccard"] <= 100 and 0 <= m["occlusion_accuracy"] <= 100


# ---- the port's fit loop alone ------------------------------------------------


def port_cfgs(steps, log_every=10, arap=True, densify=None, tracks=64, **fit_kw):
    fcfg = tfit.FitConfig(num_iters=steps, num_fg_samples=100, num_bg_samples=100, num_track_samples=tracks,
                          log_every=log_every, **fit_kw)
    tcfg = ttr.TrainerConfig(width=W, height=H, num_frames=T, num_track_samples=tracks, max_intersections=MAXI,
                             arap_sample_num=64, arap_weight=1e-3 if arap else 0.0,
                             optim=topt.OptimConfig(max_steps=20),
                             densify=densify or tden.DensifyConfig(densify_start_iter=10**9))
    return fcfg, tcfg


def test_checkpoint_cadence_not_multiple_of_log_every(clip, tmp_path):
    """CheckPointHook(every=7) saves at steps 7 and 14 with log_every=10."""
    tfit.fit_clip(clip, *port_cfgs(14), hooks=[thooks.CheckPointHook(every=7)], out_dir=str(tmp_path),
                  device="cpu")
    assert (tmp_path / "ckpt_000007" / "state.pt").exists(), "every=7 checkpoint missing"
    assert (tmp_path / "ckpt_000014" / "state.pt").exists()


class Recorder(thooks.Hook):
    """Records every hook site in the order it fires."""

    image_every = 3

    def __init__(self):
        self.sites, self.image_keys, self.val = [], set(), None

    def __getattribute__(self, name):
        if name in thooks.Hook.locations:
            def site(ctx, _n=name):
                self.sites.append(_n)
                if _n == "after_train_iter" and ctx.images:
                    self.image_keys |= set(ctx.images)
                if _n == "after_val":
                    self.val = dict(ctx.val_metrics)
            return site
        return object.__getattribute__(self, name)


def test_hook_sites_fire_in_order(clip, tmp_path):
    """All 12 sites fire, first in `Hook.locations` order, on a resumed run
    with validation, image panels and a final checkpoint."""
    tfit.fit_clip(clip, *port_cfgs(4), hooks=[thooks.CheckPointHook(every=0)], out_dir=str(tmp_path),
                  device="cpu")
    rec = Recorder()
    hooks = [thooks.CheckPointHook(every=0), thooks.LogHook(print_every=0, tensorboard=False), rec]
    tfit.fit_clip(clip, *port_cfgs(6, log_every=3, val_every=6, val_frames=2), hooks=hooks,
                  out_dir=str(tmp_path), resume=True, device="cpu")
    first = list(dict.fromkeys(rec.sites))
    assert first == list(thooks.Hook.locations)
    assert rec.sites.count("before_train_iter") == 2      # steps 5 and 6 after the resume at 4
    assert {"rgb_pred", "rgb_gt", "depth", "error", "tracks"} <= rec.image_keys
    assert rec.val["psnr"] > 0 and rec.val["num_frames"] == 2.0


@pytest.mark.parametrize("saturation_stop", [0.97, 0.0], ids=["latched", "off"])
def test_saturation_latch_stops_densification(clip, saturation_stop):
    """A capacity that fills at the first event: the latch stops the later
    events (steps 4 and 6); without it all three fire."""
    dcfg = tden.DensifyConfig(densify_start_iter=1, duplicate_interval=2, densify_grad_threshold=0.0,
                              min_opacity=0.0, saturation_stop=saturation_stop)
    cfgs = port_cfgs(6, log_every=2, densify=dcfg, capacity_factor=1.0, init_num_points=124)   # 124 of 128
    _, hist = tfit.fit_clip(clip, *cfgs, device="cpu")
    totals = hist[-1]["densify_totals"]
    assert hist[0]["saturation"] >= 0.97
    if saturation_stop:
        assert totals["events"] == 1 and totals["stopped_at_step"] == 2
    else:
        assert totals["events"] == 3 and "stopped_at_step" not in totals


def states_equal(a, b):
    for k in a.scene.params:
        assert torch.equal(a.scene.params[k], b.scene.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
    for k in a.scene.aux:
        assert torch.equal(a.scene.aux[k], b.scene.aux[k]), k
    for x, y in zip(a.densify_state, b.densify_state):
        assert torch.equal(x, y)
    assert a.scene.cfg == b.scene.cfg
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    assert torch.equal(a.key, b.key)


def test_checkpoint_round_trip_is_exact(fits, tmp_path):
    state = fits[2]
    tckpt.save_checkpoint(str(tmp_path), state, state.step)
    assert tckpt.latest_step(str(tmp_path)) == STEPS
    back, step = tckpt.restore_checkpoint(str(tmp_path), state)
    assert step == STEPS
    states_equal(state, back)
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), state) == (None, None)
    scene = train_state_io.load_scene_from_ckpt(str(tmp_path), device="cpu")
    assert all(torch.equal(scene.params[k], v) for k, v in state.scene.params.items())


class StepSampler:
    """(t1, t2) a function of the step alone, so a resumed run draws the
    pairs of the uninterrupted one."""

    def __init__(self, num_frames):
        self.cfg = tpairs.PairSamplerConfig(num_frames=num_frames)

    def sample(self, step):
        return step % self.cfg.num_frames, (3 * step + 1) % self.cfg.num_frames


def test_resume_equals_uninterrupted_run(clip, tmp_path):
    """6 steps in one run equal 4 steps, a checkpoint, a restore and 2 more,
    bit for bit, with ARAP drawing from the key, density events at
    steps 3 and 6 (split noise from the key, statistics across the
    checkpoint) and an opacity reset at step 6. The track batches are
    padded (256 >= the clip's 192 tracks a frame), so no track rows are
    drawn."""
    dcfg = tden.DensifyConfig(densify_start_iter=2, duplicate_interval=3, opacity_reset_interval=5,
                              densify_grad_threshold=1e-5)

    def run(steps, **fit_kw):
        return tfit.fit_clip(clip, *port_cfgs(steps, densify=dcfg, tracks=256), sampler=StepSampler(T),
                             device="cpu", **fit_kw)

    whole, hist = run(6)
    assert hist[-1]["densify_totals"]["events"] == 2
    run(4, hooks=[thooks.CheckPointHook(every=0)], out_dir=str(tmp_path))
    resumed, rhist = run(6, out_dir=str(tmp_path), resume=True)
    assert [m["step"] for m in rhist] == [6] and rhist[-1]["densify_totals"]["events"] == 1
    states_equal(whole, resumed)


def test_training_cli_trains_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "run")
    common = ["--synthetic", "--device", "cpu", "--i_print", "1", "--i_weight", "2", "--tensorboard", "0",
              "--out_dir", out, "--max_intersections", str(MAXI), "--num_track_samples", "64"]
    state = tapp.main(common + ["--num_iters", "3"])
    for f in ("args.json", "ckpt_000002", "ckpt_000003", "scene_cfg.json", "history.json"):
        assert (tmp_path / "run" / f).exists(), f
    read = lambda name: json.loads((tmp_path / "run" / name).read_text())
    assert state.step == 3 and read("args.json")["device"] == "cpu"
    state = tapp.main(common + ["--num_iters", "5", "--resume"])
    assert "resumed from" in capsys.readouterr().out and state.step == 5
    assert [m["step"] for m in read("history.json")] == [4, 5]
    scene = train_state_io.load_scene_from_ckpt(out, device="cpu")
    assert read("scene_cfg.json")["capacity"] == scene.cfg.capacity
    out = tinf.render_frame(scene, 2.0, tcam.canonical_camera(W, H).extrinsic,
                            tras.RasterizeConfig(width=W, height=H, max_intersections=MAXI), device="cpu")
    assert torch.isfinite(out.features["rgb"]).all()


def test_training_cli_lbs_runs_repeat(tmp_path):
    """`--traj lbs` draws its skinning logits from JAX's key (PRNGKey(0)),
    not from torch's unseeded generator: two runs end equal."""
    common = ["--synthetic", "--device", "cpu", "--traj", "lbs", "--num_iters", "3", "--i_weight", "0",
              "--tensorboard", "0", "--max_intersections", str(MAXI), "--num_track_samples", "64"]
    a, b = (tapp.main(common + ["--out_dir", str(tmp_path / run)]) for run in ("a", "b"))
    assert a.step == b.step == 3 and sorted(a.scene.params) == sorted(b.scene.params)
    assert "pos_lbs_logits" in a.scene.params
    for k in a.scene.params:
        assert torch.equal(a.scene.params[k], b.scene.params[k]), k


def test_profile_and_error_resampling(clip, tmp_path):
    fcfg, tcfg = port_cfgs(4, profile_dir=str(tmp_path / "prof"), profile_start=2, profile_count=1,
                           error_resample_every=2)
    tfit.fit_clip(clip, fcfg, tcfg, out_dir=str(tmp_path), device="cpu")
    assert (tmp_path / "prof" / "fit_steps_2_3.json").stat().st_size > 1000
    errs = np.loadtxt(tmp_path / "flow_error.txt")
    assert errs.shape == (T,) and (errs > 0).all() and np.isfinite(errs).all()


@pytest.mark.parametrize("field", ["distributed", "refine_camera"])
def test_unported_options_raise(clip, field):
    """Both options are ported now and fit: refine_camera=True
    (`train/camera_refine.py`), and distributed=True, which without a
    process group trains on one device (`parallel/dp.py`;
    `test_torch_parallel.py` holds it to the plain fit)."""
    fcfg, tcfg = port_cfgs(2, **{field: True})
    _, hist = tfit.fit_clip(clip, fcfg, tcfg, device="cpu")
    assert hist[-1]["step"] == 2
    if field == "refine_camera":
        assert hist[-1]["cam_xi_norm"] > 0


def test_port_quality_gate_holds_the_pinned_bands():
    """`eval.quality_gate` (run by `chip_smoke.py` on the card) copies the
    mini-fit's configuration and bands (it imports nothing of the JAX
    package); they stay equal."""
    import test_quality_gate as q

    from splatter_a_video_tpu_torch.eval import quality_gate as g

    assert g.PINNED == q.PINNED
    assert (g.PSNR_DROP, g.AJ_DROP, g.OA_DROP, g.ALIVE_REL) == (q.PSNR_DROP, q.AJ_DROP, q.OA_DROP, q.ALIVE_REL)
    assert (g.W, g.H, g.T, g.STEPS, g.MAX_INTERSECTIONS) == (q.W, q.H, q.T, q.STEPS, q.MAXI)
    clip_cfg, fcfg, tcfg = g.configs()
    assert (clip_cfg.num_blobs, clip_cfg.blob_radius, clip_cfg.track_grid, clip_cfg.texture) == (4, q.W / 9.0, 3, True)
    assert (fcfg.num_fg_samples, fcfg.num_bg_samples, fcfg.init_num_points, fcfg.capacity_factor) == (1200, 800, 3000, 1.31)
    d = tcfg.densify
    assert (d.densify_start_iter, d.opacity_reset_interval, d.size_prune_always, tcfg.arap_sample_num) == (100, 300, True, 128)
