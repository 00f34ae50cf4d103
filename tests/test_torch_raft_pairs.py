"""Port parity for the legacy RAFT-exhaustive pair sampler: on the
layouts of `tests/test_raft_pairs.py`, the port's and the JAX package's
samplers from the same seed give byte-identical batches, step after step,
in every variant (plain, curriculum, count map, error map, full grids);
`_bilinear` and `load_ba_depth` are exact."""

import os

import numpy as np
import pytest

from splatter_a_video_tpu.data import raft_pairs as jrp
from splatter_a_video_tpu_torch.data import raft_pairs as trp

from test_raft_pairs import raft_dir  # noqa: F401  (the module fixture)

T = 6
VARIANTS = {
    "plain": ({}, None),
    "curriculum": ({}, 2),
    "count_map": ({"use_count_map": True}, None),
    "full_grids": ({"full_grids": True}, None),
}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_batches_equal(raft_dir, variant):  # noqa: F811
    kw, interval = VARIANTS[variant]
    samplers = [m.RaftExhaustivePairs(m.RaftPairsConfig(data_dir=raft_dir, num_imgs=T, num_pts=48, seed=4, **kw))
                for m in (jrp, trp)]
    for s in samplers:
        if interval:
            s.set_max_interval(interval)
    for step in range(8):
        _equal(*(s.sample(step) for s in samplers))
        if step == 3:
            for s in samplers:
                s.increase_max_interval_by(1)
    assert samplers[1]._max_interval == samplers[0]._max_interval


def test_error_map_batches_equal(raft_dir, tmp_path):  # noqa: F811
    pred_dir = tmp_path / "flow_cache"
    pred_dir.mkdir()
    names = sorted(os.listdir(f"{raft_dir}/color"))
    rng = np.random.RandomState(7)
    for i, n1 in enumerate(names):
        np.save(pred_dir / f"{n1}_{names[(i + 1) % len(names)]}.npy", rng.randn(24, 32, 2))
    samplers = [m.RaftExhaustivePairs(m.RaftPairsConfig(
        data_dir=raft_dir, num_imgs=len(names), num_pts=32, seed=1, use_error_map=True,
        error_map_dir=str(pred_dir))) for m in (jrp, trp)]
    for s in samplers:
        s.set_max_interval(1)
    for step in range(4):
        _equal(*(s.sample(step) for s in samplers))


def test_bilinear_and_ba_depth_exact(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.rand(11, 13, 3)
    pts = np.stack([rng.uniform(-3, 15, 80), rng.uniform(-3, 13, 80)], axis=1)
    assert np.array_equal(trp._bilinear(img, pts), jrp._bilinear(img, pts))
    os.makedirs(tmp_path / "BA_full")
    for i in range(3):
        np.savez(tmp_path / "BA_full" / f"{i:04d}.npz", disp=rng.rand(8, 10).astype(np.float32) + 0.1,
                 R=np.eye(3, dtype=np.float32), t=np.array([0, 0, float(i)], np.float32),
                 K=np.diag([20.0, 20.0, 1.0]).astype(np.float32))
    a, b = jrp.load_ba_depth(str(tmp_path)), trp.load_ba_depth(str(tmp_path))
    assert np.array_equal(a["depth"], b["depth"])
    for k in ("c2w", "K"):
        assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
    flow_stats = {"a": {"b": 3, "c": 1}, "b": {"a": 2}}
    assert trp.get_sample_weights(flow_stats) == jrp.get_sample_weights(flow_stats)
