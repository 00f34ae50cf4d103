"""Port parity for the fit path's data modules, scene init, evaluation
metrics and configuration, each on the same inputs in both packages (JAX
on the CPU):

  * synthetic clips (blob and textured), 3D track lifting, the border
    extension, pair draws and track batches: byte-identical (the port's
    numpy copies draw their `RandomState`s in the JAX order);
  * `build_scene_from_clip`, with and without the depth top-up: positions,
    colours, spline coefficients and knots within atol 1e-6; alive mask
    and capacity exactly. Scaling is log sqrt(d2) of the mean 3-NN squared
    distance d2, formed as |q|^2 + |p|^2 - 2 q.p in float32, so the two
    packages' matmuls leave d2 differences of float32 rounding at |q|^2
    ~ 4 (measured < 1e-6), which the log magnifies for the densest points
    (measured 2.8e-4 in scaling at d2 ~ 8e-4). The tolerance is widened
    from atol 1e-6 on scaling to atol 2e-6 on d2 = exp(2 scaling);
  * TAP-Vid metrics (numpy) exactly; PSNR / SSIM rtol 1e-5;
  * flag files and the model YAML give the same config values.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from splatter_a_video_tpu.data import factory as jfac
from splatter_a_video_tpu.data import pairs as jpairs
from splatter_a_video_tpu.data import synthetic as jsyn
from splatter_a_video_tpu.eval import metrics as jmet
from splatter_a_video_tpu.eval import tapvid as jtap
from splatter_a_video_tpu.train import fit as jfit
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu.utils import config as jconf
from splatter_a_video_tpu_torch.data import factory as tfac
from splatter_a_video_tpu_torch.data import pairs as tpairs
from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.eval import metrics as tmet
from splatter_a_video_tpu_torch.eval import tapvid as ttap
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import trainer as ttr
from splatter_a_video_tpu_torch.utils import config as tconf
from splatter_a_video_tpu_torch.utils import ply as tply

ROOT = pathlib.Path(__file__).resolve().parent.parent
D2_ATOL = 2e-6   # the kNN squared distance behind the scale (see above)
VARIANTS = {"blob": {}, "textured": {"texture": True, "seed": 3}}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def clips(request):
    kw = VARIANTS[request.param]
    return (jsyn.make_clip(jsyn.SyntheticClipConfig(**kw)),
            tsyn.make_clip(tsyn.SyntheticClipConfig(**kw)))


def test_clip_is_byte_identical(clips):
    j, t = clips
    for name in ("frames", "depths_raw", "masks_raw"):
        for a, b in zip(getattr(j, name), getattr(t, name)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert sorted(j.tracks) == sorted(t.tracks)
    for k in j.tracks:
        assert np.array_equal(j.tracks[k], t.tracks[k]), k
    for i in range(j.num_frames):
        assert np.array_equal(j.get_depth(i), t.get_depth(i))
        assert np.array_equal(j.get_mask(i), t.get_mask(i))


@pytest.mark.parametrize("fg", [True, False], ids=["fg", "bg"])
def test_tracks_3d_and_extension_equal(clips, fg):
    j, t = clips
    jo = j.get_tracks_3d(100, extract_fg=fg, rng=np.random.RandomState(5))
    to = t.get_tracks_3d(100, extract_fg=fg, rng=np.random.RandomState(5))
    for a, b in zip(jo, to):
        assert np.array_equal(a, b)
    assert len(jo[0]) > 0
    for a, b in zip(j.extend_track3d(jo[0], grid_size=32), t.extend_track3d(to[0], grid_size=32)):
        assert np.array_equal(a, b)


def test_load_target_tracks_never_aliases_the_store(clips):
    _, t = clips
    out = t.load_target_tracks(2, [2, 3], rows=np.array([0, 1]))
    before = t.tracks[(2, 2)].copy()
    out[...] = -1.0
    assert np.array_equal(t.tracks[(2, 2)], before)


SAMPLERS = {   # kind -> sampler from a package's (factory, pairs) modules
    "simpleGS": lambda fac, pairs: fac._policy("simpleGS", 12, 3),
    "gaussian": lambda fac, pairs: fac._policy("gaussian", 12, 3, start_interval=2),
    "mix": lambda fac, pairs: fac.make_training_sampler("simpleGS+gaussian", 12, [0.3, 0.7], seed=4),
    "error_weighted": lambda fac, pairs: pairs.PairSampler(pairs.PairSamplerConfig(
        num_frames=12, seed=2, error_weights=np.linspace(0.1, 1.0, 12))),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_pair_draws_equal(kind):
    js, ts = SAMPLERS[kind](jfac, jpairs), SAMPLERS[kind](tfac, tpairs)
    jd = [js.sample(s) for s in range(300)]
    td = [ts.sample(s) for s in range(300)]
    assert jd == td
    assert len(set(jd)) > 20


def test_mixed_sampler_broadcasts_error_weights():
    s = tfac.make_training_sampler("simpleGS+gaussian", 8, [0.5, 0.5])
    w = np.full(8, 1e-6)
    w[3] = 1.0
    s.cfg.error_weights = w
    assert all(m.cfg.error_weights is w for m in s.samplers)
    assert np.mean([s.sample(i)[0] == 3 for i in range(200)]) > 0.95


@pytest.mark.parametrize("slim", [True, False], ids=["slim", "full"])
@pytest.mark.parametrize("P", [64, 400], ids=["subsampled", "padded"])
def test_batches_equal(clips, slim, P):
    j, t = clips
    jb = jpairs.BatchBuilder(j, P, seed=7, slim=slim)
    tb = tpairs.BatchBuilder(t, P, seed=7, slim=slim)
    for t1, t2 in [(0, 5), (3, 3), (11, 0), (0, 7)]:
        a, b = jb.build(t1, t2), tb.build(t1, t2)
        assert (int(a.t1), int(a.t2)) == (b.t1, b.t2)
        for f in jtr.Batch._fields[2:]:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_batch_to_device_and_stream():
    clip = tsyn.make_clip(tsyn.SyntheticClipConfig())
    s = tpairs.PairSampler(tpairs.PairSamplerConfig(num_frames=clip.num_frames))
    b = tpairs.BatchBuilder(clip, 32, slim=True)
    batches = list(tpairs.batch_stream(s, b, 5, start_step=2))
    assert [x.t1 for x in batches] == [2, 3, 4]
    moved = tpairs.batch_to_device(batches[0], "cpu")
    assert isinstance(moved.t1, int) and moved.rgb1 is None
    assert moved.query_px.dtype == torch.float32 and moved.track_valid.dtype == torch.bool
    assert np.array_equal(moved.target_tracks.numpy(), batches[0].target_tracks)


@pytest.mark.parametrize("init_num_points", [0, 600], ids=["tracks_only", "topped_up"])
def test_build_scene_from_clip_matches(clips, init_num_points):
    j, t = clips
    kw = dict(num_fg_samples=150, num_bg_samples=150, init_num_points=init_num_points,
              capacity_factor=1.31)
    js, jcfg = jfit.build_scene_from_clip(j, jfit.FitConfig(**kw))
    ts, tcfg = tfit.build_scene_from_clip(t, tfit.FitConfig(**kw), device="cpu")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    n = int(js.num_alive)
    if init_num_points:
        assert n == init_num_points
    assert np.array_equal(np.array(js.alive), ts.alive.numpy())
    assert sorted(js.params) == sorted(ts.params)
    for k in js.params:
        a, b = ts.params[k].numpy(), np.array(js.params[k])
        if k == "scaling":   # compared as the squared distance it encodes
            a, b = np.exp(2.0 * a.astype(np.float64)), np.exp(2.0 * b.astype(np.float64))
        np.testing.assert_allclose(a, b, atol=D2_ATOL if k == "scaling" else 1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(ts.aux["spline_knots"].numpy(), np.array(js.aux["spline_knots"]), atol=1e-6)


def test_tapvid_metrics_equal():
    rng = np.random.RandomState(0)
    N, T, W, H = 40, 9, 64, 48
    gt = rng.uniform(0, 60, (N, T, 2)).astype(np.float32)
    pred = gt + rng.randn(N, T, 2).astype(np.float32) * 3
    go, po = rng.rand(N, T) < 0.2, rng.rand(N, T) < 0.25
    qf = rng.randint(0, T, N)
    a = jtap.compute_tapvid_metrics(pred, po, gt, go, W, H, query_frame=qf)
    b = ttap.compute_tapvid_metrics(pred, po, gt, go, W, H, query_frame=qf)
    assert a == b
    assert 0 < b["average_jaccard"] < 100


def test_image_metrics_match():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.randn(48, 64, 3).astype(np.float32) * 0.05, 0, 1)
    for name in ("psnr", "ssim", "ms_ssim"):
        np.testing.assert_allclose(getattr(tmet, name)(a, b), getattr(jmet, name)(a, b), rtol=1e-5, err_msg=name)


def test_ply_round_trip(tmp_path):
    rng = np.random.RandomState(2)
    params = {"position": rng.randn(10, 3).astype(np.float32),
              "features_rest": rng.randn(10, 15, 3).astype(np.float32),
              "opacity": rng.randn(10, 1).astype(np.float32)}
    alive = rng.rand(10) < 0.6
    tply.save_ply(str(tmp_path / "a.ply"), params, alive)
    back = tply.load_ply(str(tmp_path / "a.ply"))
    for k, v in params.items():
        assert np.array_equal(back[k], v[alive].reshape(alive.sum(), -1)), k


def _fields(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_flag_file_parses_the_same():
    argv = ["--config", str(ROOT / "configs" / "config.txt"), "--num_iters", "77", "--dataset_weights", "0.4", "0.6"]
    a, b = vars(jconf.parse_args(argv)), vars(tconf.parse_args(argv))
    assert b.pop("device") == "cuda"
    assert a == b
    assert b["num_iters"] == 77 and b["gs_config_file"] == "configs/frag_gs_v10.yaml"
    assert tconf.parse_args(["--device", "cpu"]).device == "cpu"


def test_model_yaml_applies_the_same():
    pytest.importorskip("yaml")
    y = tconf.load_yaml(str(ROOT / "configs" / "frag_gs_v10.yaml"))
    assert y == jconf.load_yaml(str(ROOT / "configs" / "frag_gs_v10.yaml"))
    jt, jf = jconf.apply_gs_config(y, jtr.TrainerConfig(width=64, height=48, num_frames=12), jfit.FitConfig())
    tt, tf = tconf.apply_gs_config(y, ttr.TrainerConfig(width=64, height=48, num_frames=12), tfit.FitConfig())
    assert _fields(jt) == _fields(tt)
    assert _fields(jf) == _fields(tf)
    assert tt.train_render_attributes and not tt.white_bg


@pytest.mark.parametrize("value,step,expected", [
    (0.5, 10, 0.5), ([0, 1.0, 100, 3.0], 50, 2.0), ([0, 1.0, 100, 3.0], 500, 3.0)])
def test_scalar_schedule(value, step, expected):
    assert tconf.C(value, step) == jconf.C(value, step) == expected
