"""The reference's initial scene (`reference/scene.py`): its pieces against
SciPy and a brute-force search, and the `init_*` numbers of the check, which
hold the program's set-up at a tiny size and fail where its kNN scale or its
spline fit is altered."""

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline
from scipy.ndimage import binary_erosion

from port_bench import clip as _clip
from port_bench import compare, harness, manifest
from port_bench.reference import scene
from port_bench.tests import tiny_fit

SEED = 2 ** 31 + 4321


@pytest.mark.parametrize("r", [2, 3])
def test_erosion_is_scipys(r):
    m = np.random.RandomState(r).rand(3, 17, 23) < 0.7
    want = np.stack([binary_erosion(f, structure=np.ones((r, r), bool)) for f in m])
    assert np.array_equal(scene._erode(torch.from_numpy(m), r).numpy(), want)


@pytest.mark.parametrize("T", [6, 11, 48])
def test_not_a_knot_is_scipys(T):
    kn = scene.spline_knots(T)
    y = np.random.RandomState(T).randn(len(kn), 5, 3)
    want = CubicSpline(kn, y, axis=0).c
    got = scene.not_a_knot(torch.from_numpy(kn), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_knn_scale_is_exact_with_duplicates():
    g = torch.Generator().manual_seed(3)
    p = torch.rand((3000, 3), generator=g)
    p[:200] = p[200:400]
    p[2990:] = p[0]
    d = ((p.double()[:, None] - p.double()[None]) ** 2).sum(-1)
    want = d.topk(4, 1, largest=False).values[:, 1:4].mean(1)
    assert torch.equal(scene.mean_knn3_sq_dist(p, chunk=256), want)


def _numbers():
    cfg = tiny_fit.config("flagship_2160p")
    clip = _clip.make_clip(_clip.spec_from_config(cfg), SEED, "cpu")
    fcfg, _ = harness.program_configs(cfg, SEED)
    from splatter_a_video_tpu_torch.train import fit

    ts, cols = fit.lift_clip(_clip.to_video_flow(clip), fcfg)
    sc, _ = fit.scene_from_tracks(ts, cols, cfg["num_frames"], fcfg, device="cpu")
    prog = {"params": sc.params, "alive": sc.aux["alive"], "knots": sc.aux["spline_knots"]}
    nums = compare.init_numbers(prog, scene.initial_scene(clip, cfg, harness.fit_seed(SEED), "cpu"))
    return {c["name"]: c for c in compare.verdict(nums, manifest.limits("flagship_2160p"))}


def test_program_set_up_holds():
    assert all(c["ok"] for c in _numbers().values())


def test_scale_from_two_neighbours_fails(monkeypatch):
    from splatter_a_video_tpu_torch.ops import knn

    def two(points, chunk=2048):
        d, _ = knn.knn(points, points, k=4, chunk=chunk)
        return d[:, 1:3].sum(-1) / 2

    monkeypatch.setattr(knn, "mean_knn3_sq_dist", two)
    checks = _numbers()
    assert not checks["init_scaling_gap"]["ok"] and checks["init_param_gap"]["ok"]


def test_natural_spline_fails(monkeypatch):
    from splatter_a_video_tpu_torch.models import trajectory

    def natural(track_seq, frames_per_knot=5):
        T = track_seq.shape[0]
        kn = trajectory.spline_knots(T, frames_per_knot)
        idx = np.linspace(0, T - 1, len(kn)).astype(np.int64)
        cs = CubicSpline(kn, (track_seq - track_seq[0][None])[idx], axis=0, bc_type="natural")
        return np.transpose(cs.c, (2, 0, 1, 3)).astype(np.float32), kn

    monkeypatch.setattr(trajectory, "fit_cubic_spline", natural)
    checks = _numbers()
    assert not checks["init_param_gap"]["ok"] and checks["init_scaling_gap"]["ok"]
