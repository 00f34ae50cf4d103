"""The port's data-parallel training and depth-slab render on the CPU.

The port runs on 2 real gloo ranks, spawned by `torch.multiprocessing`
(`_torch_dp_ranks.py`, a `FileStore` under the test's tmp dir, a timeout
of its own); the JAX package runs its `shard_map` steps on a 2-device CPU
mesh (`mesh.make_mesh(2)`) in the test process. Same 64x48 state, same two
frame pairs (slot d to rank d), both drawing ARAP from the replicated key.

The atlas and joint DP steps are held in `test_torch_parallel_steps.py`
(its own file, for the JAX compile times). Bars: the DP steps at the
gradient bars of
`test_torch_train_step.py` (averaged Adam moments atol 3e-4 of the largest
and rtol 2e-3; params atol 1e-6 where the gradient is at least 1e-4 of its
largest; metrics rtol 1e-5; densification statistics rtol 1e-4); the two
ranks' states `torch.equal`; `dp_batch_stream` rows byte-identical to
JAX's; the 2-slab render against JAX's at atol 2e-3 (the typical-scene bar
of `tests/test_parallel.py`), and the collective render `torch.equal` to
the sequential fold of the same slabs. Also the repair of
`fit_clip(distributed=True)`: at world size 1 it takes the plain step and
ends in the state of `distributed=False`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_ranks
from splatter_a_video_tpu.data import pairs as jpairs
from splatter_a_video_tpu.data import synthetic as jsyn
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.ops import rasterize as jras
from splatter_a_video_tpu.parallel import dp as jdp
from splatter_a_video_tpu.parallel import mesh as jmesh
from splatter_a_video_tpu.parallel import render_shard as jshard
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch.data import pairs as tpairs
from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.ops import rasterize as tras
from splatter_a_video_tpu_torch.parallel import dp as tdp
from splatter_a_video_tpu_torch.parallel import mesh as tmesh
from splatter_a_video_tpu_torch.parallel import render_shard as tshard
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import trainer as ttr

from test_torch_fit import port_cfgs, states_equal
from test_torch_fit import one_thread  # noqa: F401  (module fixture: one CPU thread)
from test_torch_train_step import G_ATOL, G_RTOL, H, T, W, batch_arrays, jax_scene, jax_state_arrays, trainer_cfg

PAIRS = ((2, 5), (6, 1))
SHARD_ATOL = 2e-3


def pair_arrays(d):
    """Slot d's batch: `batch_arrays`, the image mirrored and the tracks
    moved for slot 1."""
    b = batch_arrays()
    if d:
        b["rgb1"] = np.ascontiguousarray(b["rgb1"][:, ::-1])
        b["query_px"] = np.ascontiguousarray(b["query_px"][::-1])
        b["target_tracks"] = (b["target_tracks"] + np.float32(1.5)).astype(np.float32)
    return b


def stacked(mod):
    return mod.stack_batches([mod._trainer.Batch(t1=np.int32(t1), t2=np.int32(t2), **pair_arrays(d))
                              for d, (t1, t2) in enumerate(PAIRS)])


def shard_inputs():
    s = jax_scene()
    return {"position": np.array(s.get_position(1.0)), "scaling": np.array(s.get_scaling()),
            "rotation": np.array(s.get_rotation(1.0)), "opacity": np.array(s.get_opacity()),
            "shs": np.array(s.get_shs())}


def build(names, tmp_dir):
    """The JAX DP steps (or slab render) of `names` on a 2-device mesh, and
    the port's on 2 gloo ranks, from the same states and batches."""
    from test_torch_atlas import _atlas_arrays, fg_scene
    from test_torch_camera import _cam_arrays

    from splatter_a_video_tpu.models.atlas import AtlasModel
    from splatter_a_video_tpu.train import atlas_trainer as jat
    from splatter_a_video_tpu.train import camera_refine as jcr

    jcfg, tcfg = trainer_cfg(jtr), trainer_cfg(ttr)
    extr = np.asarray(jcam.canonical_camera(W, H).extrinsic)
    m2 = jmesh.make_mesh(2)
    jb, tb = stacked(jdp), stacked(tdp)
    out, jobs = {}, {}
    if "train" in names:
        js0 = jtr.init_train_state(jcfg, jax_scene())
        out["train"] = (js0,) + tuple(jdp.make_dp_train_step(jcfg, extr, m2)(js0, jb))
        jobs["train"] = dict(kind="train", state=jax_state_arrays(js0), cfg=tcfg, extr=extr, batch=tb)
    if "atlas" in names:
        ja0 = jat.init_atlas_train_state(jcfg, AtlasModel(atlases={"gs_base": jax_scene(), "gs_fg": fg_scene()}))
        out["atlas"] = (ja0,) + tuple(jdp.make_dp_atlas_step(jcfg, extr, m2)(ja0, jb))
        jobs["atlas"] = dict(kind="atlas", state=_atlas_arrays(ja0), cfg=tcfg, extr=extr, batch=tb)
    if "joint" in names:
        kw = dict(cam_lr=1e-3, cam_prior_weight=1e-2, cam_warmup_iters=0, cam_decay_steps=5)
        jc0 = jcr.init_cam_train_state(jcfg, jax_scene(), cam_lr=1e-3, cam_decay_steps=5)
        xi0 = np.random.RandomState(5).uniform(-0.01, 0.01, (T, 6)).astype(np.float32)
        jc0 = jc0._replace(cam_xi=jnp.asarray(xi0))
        out["joint"] = (jc0,) + tuple(jdp.make_dp_joint_step(jcfg, extr, m2, **kw)(jc0, jb))
        jobs["joint"] = dict(kind="joint", state=jax_state_arrays(jc0.base), cam=_cam_arrays(jc0), cfg=tcfg,
                             extr=extr, batch=tb, kw=kw)
    if "shard" in names:
        inp = shard_inputs()
        jrc = jras.RasterizeConfig(width=W, height=H, max_intersections=1 << 13)
        trc = tras.RasterizeConfig(width=W, height=H, max_intersections=1 << 13)
        out["shard"] = jshard.render_gaussians_sharded(*(jnp.asarray(inp[k]) for k in inp), jnp.asarray(extr),
                                                       jrc, jshard.make_render_mesh(2))
        jobs["shard"] = dict(kind="shard", cfg=trc, extr=extr, **inp)
    return out, _torch_dp_ranks.run(jobs, tmp_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return build(("train", "shard"), str(tmp_path_factory.mktemp("ranks")))


def _check_state(t, jst, jst0, name=""):
    """Adam moments, params and densification statistics of the port's state
    dict `t` against the JAX TrainState `jst` (one step from `jst0`)."""
    inner = jst.opt_state.inner_states
    for k in jst.scene.params:
        adam, adam0 = inner[k].inner_state[0], jst0.opt_state.inner_states[k].inner_state[0]
        for kind in ("mu", "nu"):
            j = np.array(getattr(adam, kind)[k])
            np.testing.assert_allclose(t[kind][k].numpy(), j, rtol=G_RTOL, atol=G_ATOL * max(np.abs(j).max(), 1e-30),
                                       err_msg=f"{name} {kind}[{k}]")
        g = (np.array(adam.mu[k]) - 0.9 * np.array(adam0.mu[k])) / 0.1
        sel = np.abs(g) >= 1e-4 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
        np.testing.assert_allclose(t["params"][k].numpy()[sel], np.array(jst.scene.params[k])[sel], atol=1e-6,
                                   rtol=0, err_msg=f"{name} {k}")
    for k in ("max_radii2d", "pos_grad_accum", "denom"):
        np.testing.assert_allclose(t["densify"][k].numpy(), np.array(getattr(jst.densify_state, k)), rtol=1e-4,
                                   atol=1e-9, err_msg=f"{name} {k}")


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("job", ["train", "shard"])
def test_ranks_end_equal(runs, job):
    """Every rank ends a step (or a render) with the same state, bit for bit."""
    r0, r1 = (r[job] for r in runs[1])
    assert _equal(r0, r1)


def test_dp_train_step_matches_jax(runs):
    (js0, js1, jm), t = runs[0]["train"], runs[1][0]["train"]
    assert sorted(t["metrics"]) == sorted(jm) == ["loss", "loss_rgb", "psnr"]
    for k in jm:
        np.testing.assert_allclose(float(t["metrics"][k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _check_state(t["state"], js1, js0)
    assert np.array_equal(t["state"]["key"].numpy(), np.array(js1.key)) and int(t["state"]["step"]) == 1


def test_sharded_render_matches_jax(runs):
    j, t = runs[0]["shard"], runs[1][0]["shard"]
    for k in ("rgb", "depth", "final_T"):
        assert t[k].shape == j[k].shape
        np.testing.assert_allclose(t[k].numpy(), np.array(j[k]), atol=SHARD_ATOL, rtol=0, err_msg=k)


def test_sharded_render_equals_sequential_fold(runs):
    """The collective render equals the slabs rendered one after another on
    one process and folded; without a process group it renders one slab."""
    inp = {k: torch.from_numpy(v) for k, v in shard_inputs().items()}
    rc = tras.RasterizeConfig(width=W, height=H, max_intersections=1 << 13)
    extr = jcam.canonical_camera(W, H).extrinsic
    parts = [tshard.render_slab(*inp.values(), extr, rc, r, 2) for r in range(2)]
    seq = tshard.composite(*tshard.fold_partials(*zip(*parts)))
    assert _equal(seq, runs[1][0]["shard"])
    one = tshard.render_gaussians_sharded(*inp.values(), extr, rc)
    assert _equal(one, tshard.composite(*tshard.render_slab(*inp.values(), extr, rc, 0, 1)))


def test_render_slab_needs_a_divisible_count():
    inp = [torch.zeros(5, 3), torch.ones(5, 3), torch.ones(5, 4), torch.ones(5), torch.zeros(5, 16, 3)]
    with pytest.raises(ValueError, match="not divisible"):
        tshard.render_slab(*inp, np.eye(3, 4), tras.RasterizeConfig(width=16, height=16), 0, 2)


def test_dp_batch_stream_rows_equal_jax():
    """Step s builds the sampler's draws s*n + d in slot order in both
    packages, so the builder's rng (subsampling 32 of each frame's tracks)
    advances alike and every slot holds JAX's rows."""
    jclip, tclip = jsyn.make_clip(jsyn.SyntheticClipConfig()), tsyn.make_clip(tsyn.SyntheticClipConfig())
    cfg = dict(num_frames=jclip.num_frames, seed=3)
    js = jpairs.dp_batch_stream(jpairs.PairSampler(jpairs.PairSamplerConfig(**cfg)),
                                jpairs.BatchBuilder(jclip, 32, seed=3), 4, 2, start_step=1)
    ts = tpairs.dp_batch_stream(tpairs.PairSampler(tpairs.PairSamplerConfig(**cfg)),
                                tpairs.BatchBuilder(tclip, 32, seed=3), 4, 2, start_step=1)
    n = 0
    for j, t in zip(js, ts):
        for k in ("t1", "t2", "rgb1", "depth1", "query_px", "target_tracks", "track_valid", "mask1"):
            a, b = np.asarray(getattr(j, k)), getattr(t, k)
            assert a.shape[0] == 2 and np.array_equal(a, b), k
            assert k in ("t1", "t2") or a.dtype == b.dtype, k   # the frame indices: int32 in JAX
        n += 1
    assert n == 3


def test_local_batch_takes_the_ranks_slot():
    b = tdp.local_batch(stacked(tdp), device="cpu")   # no process group: rank 0
    assert (b.t1, b.t2) == PAIRS[0] and torch.equal(b.rgb1, torch.from_numpy(pair_arrays(0)["rgb1"]))
    assert tmesh.world_size() == 1 and tmesh.rank() == 0 and tmesh.make_mesh() is None


@pytest.fixture(scope="module")
def clip():
    return tsyn.make_clip(tsyn.SyntheticClipConfig())


def test_fit_distributed_at_world_size_one_equals_plain(clip):
    """Without a process group `distributed=True` trains on one device with
    the plain step, as the JAX package does with one device: 4 steps at
    64x48 (ARAP drawing from the key) end in the state of
    `distributed=False`, bit for bit."""
    plain, hp = tfit.fit_clip(clip, *port_cfgs(4, log_every=1), device="cpu")
    dist_state, hd = tfit.fit_clip(clip, *port_cfgs(4, log_every=1, distributed=True), device="cpu")
    states_equal(plain, dist_state)
    assert [m["loss"] for m in hp] == [m["loss"] for m in hd]


def test_refine_camera_with_distributed_raises(clip):
    with pytest.raises(ValueError, match="refine_camera is not supported with distributed=True"):
        tfit.fit_clip(clip, *port_cfgs(1, distributed=True, refine_camera=True), device="cpu")


def test_train_cli_distributed_without_torchrun_trains(tmp_path):
    """`apps.train --distributed 1` outside torchrun trains on one device,
    as the JAX CLI does on one chip."""
    from splatter_a_video_tpu_torch.apps import train as tapp

    out = tmp_path / "run"
    state = tapp.main(["--synthetic", "--device", "cpu", "--distributed", "1", "--num_iters", "2", "--i_print", "1",
                       "--tensorboard", "0", "--out_dir", str(out), "--max_intersections", str(1 << 14),
                       "--num_track_samples", "64"])
    assert state.step == 2 and (out / "ckpt_000002").exists() and (out / "history.json").exists()
