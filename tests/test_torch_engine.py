"""Port parity for the perspective engine and its modules on the CPU (JAX
with Pallas in interpret mode; the port with the plain versions of K1-K4),
at 64x48:

  * `data/readers`: the COLMAP, NeRF-synthetic and image layouts of
    `tests/test_readers.py` give equal cameras, splits, point clouds and
    images (exact); in-memory images read as from files;
  * the perspective render's gradients (camera-centred SH directions,
    `project_persp` + `ewa_persp`, a 4-channel blend) w.r.t. every
    Gaussian input at the blend's gradient bars, atol 3e-4 of the largest
    and rtol 2e-3, with opacity < 0.9;
  * one `make_engine_train_step` step (active SH degree 1 of 3) on an orbit
    view of `tests/test_engine.py`'s ground-truth cluster, from the same
    state, with the image fed in memory on the port's side: loss rtol
    1e-5, Adam moments at the gradient bars, updated params atol 1e-6
    where the gradient is at least 1e-4 of its largest, densification
    statistics rtol 1e-4;
  * `GaussianSplattingRender.render_iter` atol 2e-5 (the blend's bar) on
    rgb and depth, radii exact;
  * the port's `Engine` end to end: steps, a density event, validation,
    test and novel-view export, `engine_from_dataset`.
"""

import dataclasses
import math
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.data import readers as jrd
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import legacy_render as jlr
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu.train import engine as jeng
from splatter_a_video_tpu.utils import registry as jreg
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.data import readers as trd
from splatter_a_video_tpu_torch.models import camera as tcam
from splatter_a_video_tpu_torch.models import legacy_render as tlr
from splatter_a_video_tpu_torch.ops import rasterize as tras
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import engine as teng
from splatter_a_video_tpu_torch.train import optim as topt
from splatter_a_video_tpu_torch.utils import registry as treg

from test_engine import _gt_scene, _orbit_camera
from test_legacy_render import _scene as _legacy_scene
import test_readers

W, H = 64, 48
G_ATOL, G_RTOL = 3e-4, 2e-3


def _cams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.width, x.height, x.fovx, x.fovy) == (y.width, y.height, y.fovx, y.fovy)
        assert np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t)
        assert np.array_equal(x.intrinsic, y.intrinsic)


def _frames_equal(a, b):
    _cams_equal(a.cameras, b.cameras)
    assert a.image_paths == b.image_paths and a.depth_paths == b.depth_paths and a.backgrounds == b.backgrounds
    assert (a.pointcloud is None) == (b.pointcloud is None)
    if a.pointcloud is not None:
        for f in ("positions", "colors", "normals"):
            x, y = getattr(a.pointcloud, f), getattr(b.pointcloud, f)
            assert (x is None and y is None) or np.array_equal(x, y), f
    for i in range(len(a)):
        assert np.array_equal(a.load_image(i), b.load_image(i))
    assert a.camera_extent() == b.camera_extent()


@pytest.mark.parametrize("split", ["train", "val"])
def test_colmap_reader_matches(tmp_path, split):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    test_readers._make_colmap_scene(root)
    os.makedirs(os.path.join(root, "depth"))
    for i in range(10):
        np.save(os.path.join(root, "depth", f"d{i:03d}.npy"), np.full((48, 64), i, np.float32))
    a, b = jrd.read_colmap_scene(root, split), trd.read_colmap_scene(root, split)
    _frames_equal(a, b)
    assert np.array_equal(a.load_depth(0), b.load_depth(0))


def test_nerf_and_image_readers_match(tmp_path):
    root = str(tmp_path / "nerf")
    test_readers.TestNerfSynthetic()._make(root, {"train": 3, "test": 2})
    for split in ("train", "val"):
        _frames_equal(jrd.parse_data_format("NerfReFormat")(root, split),
                      trd.parse_data_format("NerfReFormat")(root, split))
    img_dir = tmp_path / "img"
    os.makedirs(img_dir / "depth_npy")
    rng = np.random.RandomState(4)
    test_readers._write_png(str(img_dir / "a.png"), rng.randint(0, 255, (12, 16, 3)))
    np.save(str(img_dir / "depth_npy" / "a.npy"), rng.uniform(0.5, 2, (12, 16)).astype(np.float32))
    for fmt in ("ImageReFormat", "ImageDepthReFormat"):
        _frames_equal(jrd.parse_data_format(fmt)(str(img_dir / "a.png")),
                      trd.parse_data_format(fmt)(str(img_dir / "a.png")))
    with pytest.raises(KeyError, match="unknown"):
        trd.parse_data_format("NoSuchFormat")


def test_in_memory_images_read_as_files(tmp_path):
    root = str(tmp_path / "nerf")
    test_readers.TestNerfSynthetic()._make(root, {"train": 3})
    files = trd.read_nerf_synthetic_scene(root, "train")
    raw = [imageio.imread(p) for p in files.image_paths]
    for images in (tuple(raw), tuple(r.astype(np.float32) / 255.0 for r in raw)):
        mem = dataclasses.replace(files, images=images)
        for i in range(len(files)):
            assert np.array_equal(mem.load_image(i), files.load_image(i))


def test_registries_point_at_the_port():
    assert treg.RENDERER_REGISTRY.get("ortho") is tras.render_gaussians
    for reg, jr in ((treg.TRAJECTORY_REGISTRY, jreg.TRAJECTORY_REGISTRY), (treg.LOSS_REGISTRY, jreg.LOSS_REGISTRY)):
        for name in sorted(jr._lazy):
            assert reg.get(name).__module__.startswith("splatter_a_video_tpu_torch."), name
    assert sorted(trd.DATA_FORMAT._classes) == sorted(jrd.DATA_FORMAT._classes)


def test_sh_degree_mask_matches():
    for d in range(4):
        assert np.array_equal(teng._sh_degree_mask(d, 3).numpy(), np.array(jeng._sh_degree_mask(jnp.asarray(d), 3)))


def _persp_inputs():
    gt = _gt_scene()
    rng = np.random.RandomState(9)
    n = gt.alive.shape[0]
    shs = np.array(gt.get_shs())
    shs[:, 1:] = rng.randn(n, 15, 3) * 0.1
    op = rng.uniform(0.2, 0.85, n).astype(np.float32) * np.array(gt.alive)
    scaling = rng.uniform(0.04, 0.12, (n, 3)).astype(np.float32)
    rotation = rng.randn(n, 4).astype(np.float32)
    return dict(position=np.array(gt.get_position(0.0)), scaling=scaling, rotation=rotation, opacity=op,
                shs=shs.astype(np.float32))


def test_perspective_gradients_match():
    inp = _persp_inputs()
    cam = _orbit_camera(0.7)
    rng = np.random.RandomState(3)
    w_rgb = rng.randn(H, W, 3).astype(np.float32)
    w_d = rng.randn(H, W).astype(np.float32)
    names = list(inp)
    kw = dict(width=W, height=H, ortho=False, max_intersections=1 << 14, nearest=0.2)

    def jloss(*xs):
        out = jras.render_gaussians(*xs, jnp.asarray(cam.extrinsic), jras.RasterizeConfig(**kw),
                                    intr=jnp.asarray(cam.intrinsic), bg_color=0.0, view_dir_z=False)
        return jnp.sum(out.features["rgb"] * w_rgb) + jnp.sum(out.features["depth"][..., 0] * w_d)

    jg = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(inp[k]) for k in names))
    xs = [torch.from_numpy(inp[k]).requires_grad_(True) for k in names]
    out = tras.render_gaussians(*xs, torch.from_numpy(cam.extrinsic), tras.RasterizeConfig(**kw),
                                intr=torch.from_numpy(cam.intrinsic), bg_color=0.0, view_dir_z=False)
    loss = torch.sum(out.features["rgb"] * torch.from_numpy(w_rgb)) + torch.sum(
        out.features["depth"][..., 0] * torch.from_numpy(w_d))
    tg = torch.autograd.grad(loss, xs)
    for name, j, t in zip(names, jg, tg):
        j = np.array(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.numpy(), j, rtol=G_RTOL, atol=G_ATOL * np.abs(j).max(), err_msg=name)


def test_render_iter_matches():
    pos, scale, quat, op, shs = _legacy_scene()
    shs[:, 1:] = np.random.RandomState(5).randn(pos.shape[0], 15, 3) * 0.1
    fovx = math.pi / 2
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    wvt = np.eye(4, dtype=np.float32)
    wvt[3, :3] = [0.05, -0.02, 0.1]   # a translation, stored transposed
    jr, tr = jlr.GaussianSplattingRender(), tlr.GaussianSplattingRender()
    for step in (0, 1000, 2000):
        jr.update_sh_degree(step)
        tr.update_sh_degree(step)
        assert tr.active_sh_degree == jr.active_sh_degree
        common = dict(FovX=fovx, FovY=fovy, height=H, width=W, full_proj_transform=None, scaling_modifier=0.8)
        a = jr.render_iter(world_view_transform=jnp.asarray(wvt), camera_center=jnp.zeros(3),
                           position=jnp.asarray(pos), opacity=jnp.asarray(op), scaling=jnp.asarray(scale),
                           rotation=jnp.asarray(quat), shs=jnp.asarray(shs), **common)
        b = tr.render_iter(world_view_transform=torch.from_numpy(wvt), camera_center=torch.zeros(3),
                           position=torch.from_numpy(pos), opacity=torch.from_numpy(op),
                           scaling=torch.from_numpy(scale), rotation=torch.from_numpy(quat),
                           shs=torch.from_numpy(shs), **common)
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(b[k].numpy(), np.array(a[k]), atol=2e-5, err_msg=k)
        assert np.array_equal(b["radii"].numpy(), np.array(a["radii"]))
        assert np.array_equal(b["visibility"].numpy(), np.array(a["visibility"]))
    batch = tr.render_batch(dict(position=torch.from_numpy(pos), opacity=torch.from_numpy(op),
                                 scaling=torch.from_numpy(scale), rotation=torch.from_numpy(quat),
                                 shs=torch.from_numpy(shs)),
                            [dict(FovX=fovx, FovY=fovy, height=H, width=W, world_view_transform=torch.eye(4),
                                  full_proj_transform=None, camera_center=torch.zeros(3))] * 2)
    assert batch["images"].shape == (2, H, W, 3) and batch["radii"].shape == (pos.shape[0],)


def _views(n=8):
    """Orbit views of the ground-truth cluster, rendered by the port."""
    gt = _gt_scene()
    rcfg = tras.RasterizeConfig(width=W, height=H, ortho=False, max_intersections=1 << 14, nearest=0.2)
    cams, imgs = [], []
    for i in range(n):
        jc = _orbit_camera(2 * np.pi * i / n)
        cam = tcam.Camera(width=W, height=H, R=jc.R, t=jc.t)
        out = tras.render_gaussians(*(torch.from_numpy(np.array(x)) for x in (
            gt.get_position(0.0), gt.get_scaling(), gt.get_rotation(0.0), gt.get_opacity(), gt.get_shs())),
            torch.from_numpy(cam.extrinsic), rcfg, intr=torch.from_numpy(cam.intrinsic), bg_color=0.0,
            view_dir_z=False)
        cams.append(cam)
        imgs.append((np.clip(out.features["rgb"].numpy(), 0, 1) * 255).astype(np.uint8))
    return cams, imgs


def _engine_cfg(mod, dmod, omod, **kw):
    d = dict(width=W, height=H, capacity=256, max_intersections=1 << 14, random_init_points=160,
             sh_degree_interval=2,
             densify=dmod.DensifyConfig(percent_dense=0.01, densify_start_iter=1, densify_stop_iter=300,
                                        duplicate_interval=3, opacity_reset_interval=10_000, min_opacity=0.005,
                                        densify_grad_threshold=1e-6),
             optim=omod.OptimConfig(max_steps=400, lrs=tuple(sorted(mod.ENGINE_LRS.items())),
                                    schedules=tuple(sorted(mod.ENGINE_SCHEDULES.items()))))
    d.update(kw)
    return mod.EngineConfig(**d)


@pytest.fixture(scope="module")
def engine_step(tmp_path_factory):
    from splatter_a_video_tpu.train import density as jden
    from splatter_a_video_tpu.train import optim as jopt

    cams, imgs = _views()
    root = tmp_path_factory.mktemp("views")
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(root / f"v{i:02d}.png"))
        imageio.imwrite(paths[-1], img)
    jframes = jrd.SceneFrames(cameras=tuple(jcam.Camera(width=W, height=H, R=c.R, t=c.t) for c in cams),
                              image_paths=tuple(paths), backgrounds=(0.0,) * len(cams))
    eng = jeng.Engine(_engine_cfg(jeng, jden, jopt), jframes, out_dir=str(root / "out"), seed=0)
    jstate = eng.state
    batch = eng.train_batches[3]
    js1, jm = eng._train_step(jstate, batch, jnp.asarray(1))
    inner = jstate.opt_state.inner_states
    adam = {k: v.inner_state[0] for k, v in inner.items()}
    tstate = convert.engine_state_from_numpy(
        params={k: np.array(v) for k, v in jstate.scene.params.items()},
        aux={k: np.array(v) for k, v in jstate.scene.aux.items()}, cfg=dataclasses.asdict(jstate.scene.cfg),
        opt={"count": 0, "mu": {k: np.array(a.mu[k]) for k, a in adam.items()},
             "nu": {k: np.array(a.nu[k]) for k, a in adam.items()}},
        densify={k: np.array(v) for k, v in jstate.densify_state._asdict().items()}, step=0,
        key=np.array(jstate.key), device="cpu")
    tcfg = dataclasses.replace(_engine_cfg(teng, tden, topt),
                               optim=dataclasses.replace(_engine_cfg(teng, tden, topt).optim,
                                                         spatial_lr_scale=eng.cfg.optim.spatial_lr_scale),
                               densify=dataclasses.replace(_engine_cfg(teng, tden, topt).densify,
                                                           cameras_extent=eng.cfg.densify.cameras_extent))
    t_train, _, _, _ = teng.make_engine_train_step(tcfg, 0.0, device="cpu")
    tframes = trd.SceneFrames(cameras=tuple(cams), image_paths=(), backgrounds=(0.0,) * len(cams),
                              images=tuple(imgs))
    tb = teng._frames_to_device(tframes, torch.device("cpu"))[3]
    assert all(np.array_equal(np.array(a), b.numpy()) for a, b in zip(batch, tb))
    ts1, tm = t_train(tstate, tb, 1)
    return js1, jm, ts1, tm


def test_engine_step_matches(engine_step):
    js1, jm, ts1, tm = engine_step
    for k in ("loss", "psnr", "num_intersections"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    inner = js1.opt_state.inner_states
    nonzero = set()
    for name in js1.scene.params:
        adam = inner[name].inner_state[0]
        for kind in ("mu", "nu"):
            j = np.array(getattr(adam, kind)[name])
            np.testing.assert_allclose(getattr(ts1.opt_state, kind)[name].numpy(), j, rtol=G_RTOL,
                                       atol=G_ATOL * max(np.abs(j).max(), 1e-30), err_msg=f"{kind}[{name}]")
        g = np.array(adam.mu[name]) / 0.1
        if np.abs(g).max() > 0:
            nonzero.add(name)
        sel = np.abs(g) >= 1e-4 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
        np.testing.assert_allclose(ts1.scene.params[name].numpy()[sel], np.array(js1.scene.params[name])[sel],
                                   atol=1e-6, rtol=0, err_msg=name)
    # the initial Gaussians are isotropic (kNN scale), so rotation gets no gradient
    assert nonzero == set(js1.scene.params) - {"rotation"}
    # degree 1 of 3: the coefficients above it get no gradient
    assert float(ts1.opt_state.mu["features_rest"][:, 3:].abs().max()) == 0.0
    for name in ("max_radii2d", "pos_grad_accum", "denom"):
        t = getattr(ts1.densify_state, name).numpy()
        np.testing.assert_allclose(t, np.array(getattr(js1.densify_state, name)), rtol=1e-4, atol=1e-9)
        assert t.max() > 0


def test_engine_end_to_end(tmp_path):
    torch.set_num_threads(1)
    cams, imgs = _views(10)
    frames = lambda sl: trd.SceneFrames(cameras=tuple(cams[sl]), image_paths=(), backgrounds=(0.0,) * len(cams[sl]),
                                        images=tuple(imgs[sl]))
    out = tmp_path / "out"
    eng = teng.Engine(_engine_cfg(teng, tden, topt, val_interval=4), frames(slice(0, 8)), frames(slice(8, 10)),
                      out_dir=str(out), seed=0, device="cpu")
    assert eng.cfg.optim.spatial_lr_scale > 1.0 and int(eng.state.scene.num_alive) == 160
    m = eng.train(num_steps=8)
    assert np.isfinite(m["loss"]) and "num_alive" in m and int(eng.state.step) == 8
    assert eng.active_sh_degree(7) == 3 and 0.0 < eng.val_metrics["ssim"] <= 1.0
    tm = eng.test(novel_views=2)
    assert set(tm) == {"psnr", "ssim", "l1"}
    assert sorted(os.listdir(out)) == ["novel_000.png", "novel_001.png", "test_000.png", "test_001.png"]

    root = str(tmp_path / "nerf")
    test_readers.TestNerfSynthetic()._make(root, {"train": 2, "test": 1})
    e2 = teng.engine_from_dataset(root, "NerfReFormat", cfg=_engine_cfg(teng, tden, topt, width=40, height=32),
                                  out_dir=str(tmp_path / "o2"), device="cpu")
    assert (e2.cfg.width, e2.cfg.height, e2.bg) == (40, 32, 1.0) and len(e2.val_batches) == 1
