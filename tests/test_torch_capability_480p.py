"""The port's capability harness, `scripts/torch_capability_480p.py`,
against the JAX package's, `scripts/capability_480p.py`, on the CPU:

  * QUICK (214x120, 8 frames, a 600-point scene lifted from the clip): the
    JAX script in a subprocess from a copy under `tmp_path`, the port's
    `run` in this process; the reports have the same keys; `scale`,
    `tracking.num_queries`, `edit.num_selected`, `interp.frames_rendered`
    and `layers` equal; `recon_psnr_f0`, `tracking.mean_occluded_frac`, both
    edit PSNRs and `interp.tc_mid_vs_blend` within 0.011;
  * the scene file: a small JAX scene (64x48, 120 Gaussians, a cubic spline
    over 48 frames) saved with `scripts/e2e_480p.py`'s npz keys loads
    through the port's `load_scene`, renders frame 0 as JAX does at atol
    2e-5, and saved again by the port's `save_scene` gives the same arrays;
    a frame count that does not fit its knots is refused;
  * without imageio the report and `tracks_pred.npy` are written, and no
    image.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splatter_a_video_tpu import inference as jinf
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.models import trajectory as jtr
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu_torch import inference as tinf
from splatter_a_video_tpu_torch.ops import rasterize as tras

from test_torch_e2e_480p import assert_close, last_record, load_script, start_jax_script
from test_torch_fit import one_thread  # noqa: F401  (autouse module fixture: one CPU thread)

W, H, T = 64, 48, 48
CAP, ALIVE = 128, 120
ATOL = 2e-5   # tests/test_rasterize.py's image bar


@pytest.fixture(scope="module")
def cap():
    return load_script("torch_capability_480p")


def test_quick_report_matches_jax(cap, tmp_path):
    proc = start_jax_script("capability_480p", dict(CAP_QUICK="1", CAP_CPU="1"), tmp_path / "jax")
    got = cap.run(quick=True, device="cpu", outdir=str(tmp_path / "port"), report_path=None)
    want = last_record(proc)

    assert got.keys() == want.keys()
    assert got["timings_s"].keys() == want["timings_s"].keys()
    assert got["scale"] == want["scale"]
    assert got["tracking"]["num_queries"] == want["tracking"]["num_queries"]
    assert got["edit"]["num_selected"] == want["edit"]["num_selected"]
    assert got["interp"]["frames_rendered"] == want["interp"]["frames_rendered"]
    assert got["layers"] == want["layers"]
    assert_close(got["recon_psnr_f0"], want["recon_psnr_f0"], "recon_psnr_f0")
    assert_close(got["tracking"]["mean_occluded_frac"], want["tracking"]["mean_occluded_frac"], "occluded")
    for k in ("edit_region_psnr_t0", "outside_region_psnr_t0"):
        assert_close(got["edit"][k], want["edit"][k], k)
    assert_close(got["interp"]["tc_mid_vs_blend"], want["interp"]["tc_mid_vs_blend"], "tc_mid_vs_blend")
    tracks = np.load(tmp_path / "port" / "tracks_pred.npy")
    np.testing.assert_allclose(tracks, np.load(tmp_path / "jax" / "out" / "e480" / "capability" / "tracks_pred.npy"),
                               atol=1e-3)
    assert (tmp_path / "port" / "capability_480p.json").exists()


@pytest.fixture(scope="module")
def jax_scene_file(tmp_path_factory):
    """A JAX spline scene with the flagship's render attributes, saved as
    `scripts/e2e_480p.py` saves it; (path, the JAX scene)."""
    rng = np.random.RandomState(7)
    cfg = jgs.SceneConfig(capacity=CAP, num_frames=T, traj="cubic_spline",
                          render_attributes=(("mask_attribute", 1), ("dino_attribute", 3)))
    pos = np.concatenate([rng.uniform(-0.8, 0.8, (ALIVE, 2)), rng.uniform(0.5, 2.0, (ALIVE, 1))], 1)
    t = np.linspace(0, 1, T)[:, None, None]
    track = (pos[None] + 0.05 * np.sin(2 * np.pi * t + rng.uniform(0, 6, (1, ALIVE, 3)))).astype(np.float32)
    track -= (track[0] - pos)[None].astype(np.float32)
    s = jgs.create_scene(cfg, pos.astype(np.float32), rng.uniform(0, 1, (ALIVE, 3)).astype(np.float32),
                         track_seq=track, key=jax.random.PRNGKey(7))
    params = {k: np.array(v) for k, v in s.params.items()}
    params["scaling"][:ALIVE] = rng.uniform(-3.5, -2.0, (ALIVE, 3))
    params["rotation"][:ALIVE] = rng.randn(ALIVE, 4)
    params["opacity"][:ALIVE] = rng.uniform(-1.5, 2.5, (ALIVE, 1))
    params["features_rest"][:ALIVE] = rng.randn(ALIVE, 15, 3) * 0.2
    params = {k: v.astype(np.float32) for k, v in params.items()}
    scene = jgs.GaussianScene(params={k: jnp.asarray(v) for k, v in params.items()}, aux=s.aux, cfg=cfg)
    path = tmp_path_factory.mktemp("scene") / "final_scene.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in scene.params.items()}, alive=np.asarray(scene.alive),
             spline_knots=np.asarray(scene.aux["spline_knots"]))
    return path, scene


def test_jax_scene_file_loads_and_renders(cap, jax_scene_file, tmp_path):
    path, jscene = jax_scene_file
    scene = cap.load_scene(str(path), T, device="cpu")
    assert int(scene.num_alive) == ALIVE and scene.cfg.capacity == CAP
    assert np.array_equal(scene.aux["spline_knots"].numpy(), np.asarray(jtr.spline_knots(T)))
    cam = jcam.canonical_camera(W, H)
    want = jinf.render_frame(jscene, 0.0, np.asarray(cam.extrinsic),
                             jras.RasterizeConfig(width=W, height=H, max_intersections=1 << 14))
    got = tinf.render_frame(scene, 0.0, cam.extrinsic, tras.RasterizeConfig(width=W, height=H,
                                                                            max_intersections=1 << 14), device="cpu")
    np.testing.assert_allclose(got.features["rgb"].numpy(), np.asarray(want.features["rgb"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.final_T.numpy(), np.asarray(want.final_T), rtol=0, atol=ATOL)

    e2e = load_script("torch_e2e_480p")
    again = tmp_path / "again.npz"
    e2e.save_scene(str(again), scene)
    a, b = np.load(path), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_scene_file_frame_count_checked(cap, jax_scene_file):
    with pytest.raises(ValueError, match="spline intervals"):
        cap.load_scene(str(jax_scene_file[0]), 250, device="cpu")


def test_without_imageio_writes_report_and_tracks_only(cap, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    out = tmp_path / "cap"
    report = cap.run(quick=True, device="cpu", outdir=str(out), report_path=None,
                     sizes=dict(cap.QUICK, edit_steps=2))
    assert "not written (imageio does not import)" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["capability_480p.json", "tracks_pred.npy"]
    assert np.load(out / "tracks_pred.npy").shape == (report["tracking"]["num_queries"], 8, 2)
