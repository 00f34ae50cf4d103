"""The port's offline preprocessing against the JAX package's on the CPU:
the disparity alignment and its uint16 quantisation equal; the directory
drivers (metric depth through a stand-in backend, the alignment, the
monocular-depth and tracking stages through each package's networks on
the same converted checkpoint) write the same files; and the CLI prints
`SKIPPED` in the same cases. Network outputs at the networks' bars (DA
1e-3 on the disparity before quantisation, TAPIR atol 5e-3 / rtol 1e-3).
"""

import json
import os

import numpy as np
import pytest

from splatter_a_video_tpu.apps import preprocess as jcli
from splatter_a_video_tpu.data import preprocess as jpp
from splatter_a_video_tpu.nets import depth_anything as jda
from splatter_a_video_tpu.nets import tapir as jtapir
from splatter_a_video_tpu_torch.apps import preprocess as tcli
from splatter_a_video_tpu_torch.data import preprocess as tpp
from splatter_a_video_tpu_torch.nets import depth_anything as tda
from splatter_a_video_tpu_torch.nets import tapir as ttapir

from test_torch_fit import one_thread  # noqa: F401  (module fixture: one CPU thread)
from test_torch_nets import tiny_da_cfg

iio = pytest.importorskip("imageio.v2")


def _write_images(d, n=3, h=8, w=10, seed=4):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for t in range(n):
        iio.imwrite(os.path.join(d, f"{t:05d}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_disparity_matches_jax(seed):
    rng = np.random.RandomState(seed)
    metric = rng.rand(32, 40) * 2.0 + 0.5
    mono = (metric - 0.7) / 3.0 + (rng.rand(32, 40) < 0.1) * rng.rand(32, 40) * 10
    mono[0, 0] = -50.0
    ref, got = jpp.align_disparity(mono, metric), tpp.align_disparity(mono, metric)
    assert got[1:] == ref[1:] and np.array_equal(got[0], ref[0])
    assert np.array_equal(tpp.disp_to_uint16(metric), jpp.disp_to_uint16(metric))


def _fake_backend(rgb, intrinsics):
    h, w = rgb.shape[:2]
    return {"depth": 1.0 + rgb[..., 0].astype(np.float64) / 255.0,
            "intrinsics": np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1.0]])}


def test_metric_depth_driver_matches_jax(tmp_path):
    _write_images(str(tmp_path / "images"))
    outs = {}
    for name, pp in (("jax", jpp), ("port", tpp)):
        d, intr = tmp_path / name / "disp", tmp_path / name / "intrins"
        assert pp.compute_metric_depth(str(tmp_path / "images"), str(d), str(intr), model=_fake_backend) == 3
        assert pp.compute_metric_depth(str(tmp_path / "images"), str(d), str(intr), model=_fake_backend) == 0
        outs[name] = ([np.load(d / f"{t:05d}.npy") for t in range(3)], json.loads((tmp_path / name /
                                                                                  "intrins.json").read_text()))
    assert all(np.array_equal(a, b) for a, b in zip(outs["jax"][0], outs["port"][0]))
    assert outs["jax"][1] == outs["port"][1]
    with pytest.raises(NotImplementedError, match="UniDepth is an external dependency"):
        tpp.compute_metric_depth(str(tmp_path / "images"), str(tmp_path / "d"), str(tmp_path / "i"))


def test_align_directory_driver_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / "mono")
    os.makedirs(tmp_path / "metric")
    for t in range(3):
        metric = rng.rand(8, 10).astype(np.float32) + 0.5
        iio.imwrite(tmp_path / "mono" / f"{t:05d}.png", tpp.disp_to_uint16((metric - 0.1) / 2.0))
        np.save(tmp_path / "metric" / f"{t:05d}.npy", metric)
    for name, pp in (("jax", jpp), ("port", tpp)):
        args = (str(tmp_path / "metric"), str(tmp_path / "mono"), str(tmp_path / name))
        assert pp.align_monodepth_with_metric_depth(*args) == 3
        assert pp.align_monodepth_with_metric_depth(*args) == 0
    for t in range(3):
        assert np.array_equal(np.load(tmp_path / "port" / f"{t:05d}.npy"), np.load(tmp_path / "jax" / f"{t:05d}.npy"))


def test_monodepth_stage_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "w.npz")
    jda.save_params(path, jda.random_params(tiny_da_cfg(jda), 3), num_heads=2, out_indices=(1, 2, 3, 4))
    monkeypatch.setenv("SPLAT_DEPTH_ANYTHING_WEIGHTS", path)
    _write_images(str(tmp_path / "images"), n=2, h=32, w=44, seed=0)
    assert jpp.compute_monodepth(str(tmp_path / "images"), str(tmp_path / "jax")) == 2
    assert tpp.compute_monodepth(str(tmp_path / "images"), str(tmp_path / "port"), device="cpu") == 2
    model = tda.get_model(device="cpu")
    for t in range(2):
        a = iio.imread(tmp_path / "port" / f"{t:05d}.png").astype(np.int64)
        b = iio.imread(tmp_path / "jax" / f"{t:05d}.png").astype(np.int64)
        assert a.shape == (32, 44) and a.dtype == b.dtype
        disp = tda.infer_disparity(model, iio.imread(tmp_path / "images" / f"{t:05d}.png"))
        assert disp.max() - disp.min() > 0.1 and a.max() == b.max() == 65535
        # 1e-3 of disparity, min-max scaled to the uint16 range, plus the rounding
        assert np.abs(a - b).max() <= 1e-3 * 65535 / (disp.max() - disp.min()) + 1


def test_tracks_stage_matches_jax(tmp_path, monkeypatch):
    cfg_kw = dict(initial_resolution=(24, 24), frame_chunk=2)
    path = str(tmp_path / "t.npz")
    jtapir.save_params(path, jtapir.random_params(jtapir.TapirConfig(**cfg_kw), 1))
    monkeypatch.setenv("SPLAT_TAPIR_WEIGHTS", path)
    jcfg, tcfg = jtapir.TapirConfig(**cfg_kw), ttapir.TapirConfig(**cfg_kw)
    monkeypatch.setattr(jtapir, "TapirConfig", lambda: jcfg)   # the configuration get_model() builds
    monkeypatch.setattr(ttapir, "TapirConfig", lambda: tcfg)
    # frames at the inference size: the uint8 cast after the float32 resize
    # would round a few pixels apart in the two packages (one ulp of the
    # resize at an integer), a difference of input, not of the network
    T, H, W = 3, 24, 24
    _write_images(str(tmp_path / "images"), n=T, h=H, w=W, seed=0)
    os.makedirs(tmp_path / "masks")
    for t in range(T):
        mask = np.zeros((H, W), np.uint8)
        mask[4:16, 6:20] = 255
        iio.imwrite(tmp_path / "masks" / f"{t:05d}.png", mask)
    args = (str(tmp_path / "images"), str(tmp_path / "masks"))
    assert jpp.compute_tracks(*args, str(tmp_path / "jax"), grid_size=4, resize=(24, 24), query_chunk=8) == T * T
    assert tpp.compute_tracks(*args, str(tmp_path / "port"), grid_size=4, resize=(24, 24), query_chunk=8,
                              device="cpu") == T * T
    for q in range(T):
        for t in range(T):
            a = np.load(tmp_path / "port" / f"{q:05d}_{t:05d}.npy")
            b = np.load(tmp_path / "jax" / f"{q:05d}_{t:05d}.npy")
            assert a.shape == b.shape and a.shape[0] > 0 and a.shape[1] == 4
            np.testing.assert_allclose(a, b, atol=5e-3, rtol=1e-3, err_msg=f"{q}_{t}")


def _clip_dir(tmp_path):
    from splatter_a_video_tpu_torch.data.preprocess import disp_to_uint16

    base = tmp_path / "seq"
    rng = np.random.RandomState(7)
    for d in ("images", "masks", "unidepth_disp", "depth_anything"):
        os.makedirs(base / d)
    for t in range(2):
        iio.imwrite(base / "images" / f"{t:05d}.png", (rng.rand(8, 10, 3) * 255).astype(np.uint8))
        iio.imwrite(base / "masks" / f"{t:05d}.png", (rng.rand(8, 10) > 0.5).astype(np.uint8) * 255)
        metric = rng.rand(8, 10).astype(np.float32) + 0.5
        np.save(base / "unidepth_disp" / f"{t:05d}.npy", metric)
        iio.imwrite(base / "depth_anything" / f"{t:05d}.png", disp_to_uint16((metric - 0.1) / 2.0))
    return base


def test_cli_skips_as_jax(tmp_path, capsys, monkeypatch):
    """Without unidepth and converted weights both CLIs skip the network
    stages and run the alignment, line for line."""
    monkeypatch.delenv("SPLAT_DEPTH_ANYTHING_WEIGHTS", raising=False)
    monkeypatch.delenv("SPLAT_TAPIR_WEIGHTS", raising=False)
    lines = {}
    for name, cli, extra in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        base = _clip_dir(tmp_path / name)
        cli.main(["--datadir", str(base.parent), "--seq_name", "seq", "--stages", "all"] + extra)
        lines[name] = [ln.split(" (")[0] for ln in capsys.readouterr().out.splitlines()]
    assert lines["port"] == lines["jax"] == ["metric: SKIPPED", "monodepth: SKIPPED", "align: ok", "tracks: SKIPPED"]
    with pytest.raises(SystemExit, match="no images/"):
        tcli.main(["--datadir", str(tmp_path / "none"), "--device", "cpu"])
