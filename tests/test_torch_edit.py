"""Port parity for selection and editing, and the render, track and edit
CLIs, on the CPU (the port runs the plain versions of K1-K4; JAX runs
Pallas in interpret mode) at 64x48 with 150 of 256 slots alive:

  * `select_gaussians_by_mask` (K1's first-K ids at K_idx = 10): exact;
  * `optimize_appearance`, 3 steps, and `optimize_appearance_from_img`,
    2 steps, at the bars of `test_torch_train_step.py`: the edited
    `features_dc` / `features_rest` rows atol 1e-6 where the first step's
    gradient is at least 1e-4 of its largest (Adam moves entries with
    near-zero gradients by about lr either way), plus lr x 2e-3 for each
    step after the first: from the second step on, Adam's update
    mu_hat / sqrt(nu_hat) carries the gradients' rtol 2e-3 bar (measured:
    2.4e-7 after 3 masked steps, 3.8e-6 in 32 of 919 entries after 2
    steps over every alive Gaussian); every other row and attribute
    bit-identical to the input;
  * `split_layers` and `add_fg_copy`: exact;
  * the three CLIs end to end on a checkpoint of `apps.train --synthetic
    --device cpu`.
"""

import dataclasses
import pathlib

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu import inference as jinf
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch import inference as tinf
from splatter_a_video_tpu_torch.apps import edit as tedit
from splatter_a_video_tpu_torch.apps import render as trender
from splatter_a_video_tpu_torch.apps import track as ttrack
from splatter_a_video_tpu_torch.apps import train as ttrain
from splatter_a_video_tpu_torch.models import camera as tcam
from splatter_a_video_tpu_torch.ops import rasterize as tras

W, H, FRAMES = 64, 48, 6
CAP, ALIVE = 256, 150
MAXI = 1 << 14
ROW_ATOL, G_FRAC, G_RTOL, LR = 1e-6, 1e-4, 2e-3, 2.5e-3
SH = ("features_dc", "features_rest")


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.RandomState(4)
    cfg = jgs.SceneConfig(capacity=CAP, num_frames=FRAMES, render_attributes=(("mask_attribute", 1),))
    pos = np.concatenate([rng.uniform(-0.8, 0.8, (ALIVE, 2)), rng.uniform(0.5, 2.0, (ALIVE, 1))], 1)
    s = jgs.create_scene(cfg, pos.astype(np.float32), rng.uniform(0, 1, (ALIVE, 3)).astype(np.float32))
    params = {k: np.array(v) for k, v in s.params.items()}
    live = slice(0, ALIVE)
    params["scaling"][live] = rng.uniform(-3.2, -2.0, (ALIVE, 3))
    params["rotation"][live] = rng.randn(ALIVE, 4)
    params["opacity"][live] = rng.uniform(-1.5, 1.5, (ALIVE, 1))
    params["features_rest"][live] = rng.randn(ALIVE, 15, 3) * 0.2
    for k in ("pos_poly_feat", "rot_poly_feat"):
        params[k][live] = rng.randn(*params[k][live].shape) * 0.02
    params["mask_attribute"][live] = rng.randn(ALIVE, 1)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    aux = {k: np.array(v) for k, v in s.aux.items()}
    js = jgs.GaussianScene(params={k: jnp.asarray(v) for k, v in params.items()},
                           aux={k: jnp.asarray(v) for k, v in aux.items()}, cfg=cfg)
    return js, convert.scene_from_numpy(params, aux, dataclasses.asdict(cfg), device="cpu")


@pytest.fixture(scope="module")
def setup():
    jr = jras.RasterizeConfig(width=W, height=H, max_intersections=MAXI)
    tr = tras.RasterizeConfig(width=W, height=H, max_intersections=MAXI)
    mask = np.zeros((H, W), np.float32)
    mask[12:36, 16:48] = 1.0
    return jcam.canonical_camera(W, H), tcam.canonical_camera(W, H), jr, tr, mask


def _target(scene, setup):
    _, tc, _, tr, mask = setup
    rgb = tinf.render_frame(scene, 0.0, tc.extrinsic, tr, device="cpu").features["rgb"].numpy()
    return np.where(mask[..., None] > 0, rgb * np.float32([1.0, 0.6, 0.6]), rgb).astype(np.float32)


def _first_grads(scene, sel, target, setup):
    """The gradient of the edit's MSE at the unedited rows (port)."""
    _, tc, _, tr, _ = setup
    sel_t = torch.as_tensor(sel, dtype=torch.int64)
    rows = {n: scene.params[n][sel_t].clone().requires_grad_(True) for n in SH}
    params = dict(scene.params)
    for n in SH:
        params[n] = params[n].index_copy(0, sel_t, rows[n])
    sc = dataclasses.replace(scene, params=params)
    inp, _ = tinf._scene_inputs(sc, 0.0, ())
    out = tras.render_gaussians(inp["position"], inp["scaling"], inp["rotation"], inp["opacity"],
                                inp["shs"], torch.as_tensor(tc.extrinsic, dtype=torch.float32), tr)
    loss = torch.mean((out.features["rgb"] - torch.from_numpy(target)) ** 2)
    return dict(zip(SH, (g.numpy() for g in torch.autograd.grad(loss, [rows[n] for n in SH]))))


def test_select_ids_exact(scenes, setup):
    js, ts = scenes
    jc, tc, jr, tr, mask = setup
    a = jinf.select_gaussians_by_mask(js, mask, jc, jr)
    b = tinf.select_gaussians_by_mask(ts, mask, tc, tr, device="cpu")
    assert b.dtype == a.dtype and np.array_equal(a, b)
    assert 10 < len(b) < ALIVE


def _check_edit(js_out, ts_out, ts_in, sel, grads, steps):
    jp = {k: np.asarray(v) for k, v in js_out.params.items()}
    tp = {k: v.numpy() for k, v in ts_out.params.items()}
    other = np.setdiff1d(np.arange(CAP), sel)
    for k, v in ts_in.params.items():
        v = v.numpy()
        if k in SH:
            assert np.array_equal(tp[k][other], v[other]), k
            g = np.abs(grads[k])
            big = g >= G_FRAC * g.max()
            assert big.sum() >= 30, (k, big.sum())
            np.testing.assert_allclose(tp[k][sel][big], jp[k][sel][big], atol=ROW_ATOL + LR * G_RTOL * (steps - 1), rtol=0, err_msg=k)
            assert np.abs(tp[k][sel] - v[sel]).max() > 1e-3   # the rows moved
        else:
            assert np.array_equal(tp[k], v), k
    assert all(torch.equal(ts_out.aux[k], ts_in.aux[k]) for k in ts_in.aux)


def test_optimize_appearance_matches(scenes, setup):
    js, ts = scenes
    jc, tc, jr, tr, mask = setup
    sel = tinf.select_gaussians_by_mask(ts, mask, tc, tr, device="cpu")
    target = _target(ts, setup)
    ja = jinf.optimize_appearance(js, sel, target, jc, jr, steps=3)
    ta = tinf.optimize_appearance(ts, sel, target, tc, tr, steps=3, device="cpu")
    _check_edit(ja, ta, ts, sel, _first_grads(ts, sel, target, setup), 3)


def test_optimize_appearance_from_img_matches(scenes, setup):
    js, ts = scenes
    jc, tc, jr, tr, _ = setup
    target = _target(ts, setup)
    sel = np.nonzero(ts.alive.numpy())[0]
    ja = jinf.optimize_appearance_from_img(js, target, jc, jr, steps=2)
    ta = tinf.optimize_appearance_from_img(ts, target, tc, tr, steps=2, device="cpu")
    _check_edit(ja, ta, ts, sel, _first_grads(ts, sel, target, setup), 2)


def test_appearance_stops_below_tolerance(scenes, setup):
    _, ts = scenes
    _, tc, _, tr, mask = setup
    sel = tinf.select_gaussians_by_mask(ts, mask, tc, tr, device="cpu")
    target = _target(ts, setup)
    one = tinf.optimize_appearance(ts, sel, target, tc, tr, steps=1, device="cpu")
    stopped = tinf.optimize_appearance(ts, sel, target, tc, tr, steps=5, loss_tol=1.0, device="cpu")
    assert all(torch.equal(one.params[n], stopped.params[n]) for n in SH)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_split_layers_exact(scenes, threshold):
    js, ts = scenes
    for a, b in zip(jinf.split_layers(js, threshold), tinf.split_layers(ts, threshold)):
        assert np.array_equal(np.asarray(a.alive), b.alive.numpy())
        assert all(b.params[k] is ts.params[k] for k in ts.params)
    fg, bg = tinf.split_layers(ts, threshold)
    assert 0 < int(fg.num_alive) < ALIVE and int(fg.num_alive) + int(bg.num_alive) == ALIVE


@pytest.mark.parametrize("scale,free", [(1.0, CAP), (0.5, 20)], ids=["fits", "truncated"])
def test_add_fg_copy_exact(scenes, scale, free):
    js, ts = scenes
    if free < CAP:   # only `free` dead slots: the copy is truncated to them
        alive = np.arange(CAP) < CAP - free
        js = js.replace(aux={**js.aux, "alive": jnp.asarray(alive)})
        ts = dataclasses.replace(ts, aux={**ts.aux, "alive": torch.from_numpy(alive)})
    delta = np.array([0.2, 0.0, 0.0])
    a = jinf.add_fg_copy(js, delta, scale=scale)
    b = tinf.add_fg_copy(ts, delta, scale=scale)
    assert np.array_equal(np.asarray(a.alive), b.alive.numpy())
    for k in ts.params:
        assert np.array_equal(np.asarray(a.params[k]), b.params[k].numpy()), k
    n_fg = int(tinf.split_layers(ts)[0].num_alive)
    n_free = CAP - int(ts.num_alive)
    assert int(b.num_alive) == int(ts.num_alive) + min(n_fg, n_free) and (n_fg > n_free) == (free < CAP)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("run"))
    ttrain.main(["--synthetic", "--device", "cpu", "--num_iters", "2", "--i_print", "1",
                 "--tensorboard", "0", "--out_dir", out, "--max_intersections", str(MAXI),
                 "--num_track_samples", "64"])
    return pathlib.Path(out)


SIZE = ["--width", str(W), "--height", str(H), "--num_frames", "3", "--device", "cpu",
        "--max_intersections", str(MAXI)]


@pytest.mark.parametrize("mode", ["video", "depth", "nvs", "stereo", "interp"])
def test_render_cli(ckpt, mode):
    out = ckpt / f"r_{mode}.gif"
    trender.main(["--ckpt", str(ckpt), "--mode", mode, "--out", str(out), "--slowmo", "2"] + SIZE)
    frames = imageio.mimread(out)
    assert len(frames) == (5 if mode == "interp" else 3) and frames[0].shape[:2] == (H, W)


@pytest.mark.parametrize("mode", ["trajectories", "pixels", "eval"])
def test_track_cli(ckpt, mode, capsys):
    out = ckpt / ("eval.json" if mode == "eval" else f"t_{mode}.gif")
    extra = ["--synthetic", "--num_queries", "16"] if mode == "eval" else SIZE[:6]
    ttrack.main(["--ckpt", str(ckpt), "--mode", mode, "--out", str(out), "--device", "cpu",
                 "--max_intersections", str(MAXI)] + extra)
    assert out.exists()
    if mode == "eval":
        assert "average_jaccard" in out.read_text()


@pytest.mark.parametrize("mode", ["appearance", "appearance_img", "layers", "addfg"])
def test_edit_cli(ckpt, mode, capsys):
    target = np.full((H, W, 3), 200, np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[10:30, 20:40] = 255
    imageio.imwrite(ckpt / "target.png", target)
    imageio.imwrite(ckpt / "mask.png", mask)
    out = ckpt / f"e_{mode}"
    args = ["--ckpt", str(ckpt), "--mode", mode, "--steps", "2", "--target", str(ckpt / "target.png"),
            "--mask", str(ckpt / "mask.png")] + SIZE
    if mode == "layers":
        out.mkdir()
        tedit.main(args + ["--out", str(out)])
        assert [p.name.split(".")[0] for p in sorted(out.iterdir())] == ["layer_bg", "layer_fg"]
    else:
        tedit.main(args + ["--out", f"{out}.gif"])
        assert len(imageio.mimread(f"{out}.gif")) == 3
    if mode == "appearance":
        assert "re-optimizing appearance of" in capsys.readouterr().out
