"""The port's data-parallel multi-atlas and camera-refine joint steps on 2
real gloo ranks against the JAX package's on a 2-device CPU mesh: the
companions of `test_torch_parallel.py` (same state, pairs and bars), in a
file of their own for the JAX compile times. Also `fit_clip(distributed=
True)` on 2 ranks: the DP step on `dp_batch_stream`, the ranks' states
equal, rank 0 alone writing the checkpoints."""

import os

import numpy as np
import pytest
import torch

from splatter_a_video_tpu.train import trainer as jtr

import _torch_dp_ranks
from test_torch_fit import one_thread  # noqa: F401  (module fixture: one CPU thread)
from test_torch_fit import port_cfgs
from test_torch_parallel import PAIRS, _check_state, _equal, build
from test_torch_train_step import G_ATOL, G_RTOL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return build(("atlas", "joint"), str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("job", ["atlas", "joint"])
def test_ranks_end_equal(runs, job):
    """Every rank ends the step with the same state, bit for bit."""
    r0, r1 = (r[job] for r in runs[1])
    assert _equal(r0, r1)


def test_dp_atlas_step_matches_jax(runs):
    (ja0, ja1, jm), t = runs[0]["atlas"], runs[1][0]["atlas"]
    for k in ("loss", "loss_rgb", "loss_flow", "loss_depth", "loss_arap", "psnr", "num_intersections"):
        np.testing.assert_allclose(float(t["metrics"][k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for n in ("gs_base", "gs_fg"):
        wrap = lambda st: jtr.TrainState(st.model.atlases[n], st.opt_states[n], st.densify_states[n], st.step,
                                         st.key)
        _check_state(t["atlases"][n], wrap(ja1), wrap(ja0), n)
    assert np.array_equal(t["key"].numpy(), np.array(ja1.key))


def test_dp_joint_step_matches_jax(runs):
    (jc0, jc1, jm), t = runs[0]["joint"], runs[1][0]["joint"]
    np.testing.assert_allclose(float(t["metrics"]["loss"]), float(jm["loss"]), rtol=1e-5)
    mu = np.array(jc1.cam_opt_state[0].mu)
    np.testing.assert_allclose(t["cam_mu"].numpy(), mu, rtol=G_RTOL, atol=G_ATOL * np.abs(mu).max())
    sel = np.abs(mu) >= 1e-4 * np.abs(mu).max()
    assert sel[[t1 for t1, _ in PAIRS] + [t2 for _, t2 in PAIRS]].sum() >= 12   # both slots' twists moved
    np.testing.assert_allclose(t["xi"].numpy()[sel], np.array(jc1.cam_xi)[sel], atol=1e-6, rtol=0)
    _check_state(t["state"], jc1.base, jc0.base)


def test_fit_clip_on_two_ranks(tmp_path):
    fcfg, tcfg = port_cfgs(4, log_every=1, distributed=True)
    out_dir = tmp_path / "fit"
    job = dict(kind="fit", fcfg=fcfg, tcfg=tcfg, every=2, out_dir=str(out_dir))
    r0, r1 = (r["fit"] for r in _torch_dp_ranks.run({"fit": job}, str(tmp_path)))
    assert _equal(r0, r1) and int(r0["state"]["step"]) == 4
    assert torch.isfinite(r0["loss"]).all() and len(r0["loss"]) == 4
    assert sorted(os.listdir(out_dir)) == ["ckpt_000002", "ckpt_000004"]
