"""Port parity for multi-atlas training on the CPU (JAX with Pallas in
interpret mode; the port with the plain versions of K1-K4): two atlases
with different trajectories (a cubic-spline `gs_base` of 256 slots and a
poly-Fourier `gs_fg` of 128) in one fused 64x48 blend.

One `make_atlas_train_step` step, from the same state and with both
packages drawing ARAP from the same key, at the bars of
`test_torch_train_step.py`: the loss terms rtol 1e-5; every atlas's Adam
moments atol 3e-4 of the largest and rtol 2e-3; updated params atol 1e-6
where the gradient is at least 1e-4 of its largest; the per-atlas
densification statistics rtol 1e-4. Then one density step per atlas from
the same JAX state: equal counts and alive masks, params atol 1e-6 (the
split noise is JAX's normal draw within a few ulps); and the opacity
reset atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.models.atlas import AtlasModel as JAtlas
from splatter_a_video_tpu.train import atlas_trainer as jat
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.models.atlas import AtlasModel
from splatter_a_video_tpu_torch.train import atlas_trainer as tat
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import trainer as ttr

from test_torch_train_step import G_ATOL, G_RTOL, H, T, W, batch_arrays, jax_scene, trainer_cfg

FG_CAP, FG_ALIVE = 128, 70


def fg_scene():
    rng = np.random.RandomState(7)
    cfg = jgs.SceneConfig(capacity=FG_CAP, num_frames=T,
                          render_attributes=(("mask_attribute", 1), ("pos_poly_feat", 3), ("dino_attribute", 3)))
    pos = np.concatenate([rng.uniform(-0.6, 0.6, (FG_ALIVE, 2)), rng.uniform(0.6, 1.2, (FG_ALIVE, 1))], 1)
    s = jgs.create_scene(cfg, pos.astype(np.float32), rng.uniform(0, 1, (FG_ALIVE, 3)).astype(np.float32),
                         init_opacity=0.4)
    params = {k: np.array(v) for k, v in s.params.items()}
    live = slice(0, FG_ALIVE)
    params["scaling"][live] = np.log(rng.uniform(0.02, 0.05, (FG_ALIVE, 3)))
    params["rotation"][live] = rng.randn(FG_ALIVE, 4)
    params["pos_poly_feat"][live] = rng.randn(*params["pos_poly_feat"][live].shape) * 0.02
    return s.replace(params={k: jnp.asarray(v.astype(np.float32)) for k, v in params.items()})


def _atlas_arrays(state):
    """The port's carry of a JAX AtlasTrainState."""
    out = {}
    for n, s in state.model.atlases.items():
        inner = state.opt_states[n].inner_states
        adam = {k: v.inner_state[0] for k, v in inner.items()}
        out[n] = dict(
            params={k: np.array(v) for k, v in s.params.items()},
            aux={k: np.array(v) for k, v in s.aux.items()},
            cfg=dataclasses.asdict(s.cfg),
            opt={"count": int(next(iter(adam.values())).count),
                 "mu": {k: np.array(a.mu[k]) for k, a in adam.items()},
                 "nu": {k: np.array(a.nu[k]) for k, a in adam.items()}},
            densify={k: np.array(v) for k, v in state.densify_states[n]._asdict().items()},
        )
    return dict(atlases=out, step=int(state.step), key=np.array(state.key))


@pytest.fixture(scope="module")
def run():
    jmodel = JAtlas(atlases={"gs_base": jax_scene(), "gs_fg": fg_scene()})
    jcfg, tcfg = trainer_cfg(jtr), trainer_cfg(ttr)
    cam = jcam.canonical_camera(W, H)
    b = batch_arrays()
    jbatch = jtr.Batch(t1=jnp.asarray(2, jnp.int32), t2=jnp.asarray(5, jnp.int32),
                       **{k: jnp.asarray(v) for k, v in b.items()})
    tbatch = ttr.Batch(t1=2, t2=5, **{k: torch.from_numpy(v) for k, v in b.items()})
    j_train, j_density, j_reset = jat.make_atlas_train_step(jcfg, cam.extrinsic)
    t_train, t_density, t_reset = tat.make_atlas_train_step(tcfg, cam.extrinsic, device="cpu")
    js0 = jat.init_atlas_train_state(jcfg, jmodel)
    js1, jm = j_train(js0, jbatch)
    ts0 = convert.atlas_train_state_from_numpy(**_atlas_arrays(js0), device="cpu")
    ts1, tm = t_train(ts0, tbatch)
    js2, jinfo = j_density(js1)
    ts2, tinfo = t_density(convert.atlas_train_state_from_numpy(**_atlas_arrays(js1), device="cpu"))
    js3 = j_reset(js2)
    ts3 = t_reset(convert.atlas_train_state_from_numpy(**_atlas_arrays(js2), device="cpu"))
    return dict(js0=js0, js1=js1, jm=jm, ts0=ts0, ts1=ts1, tm=tm, js2=js2, jinfo=jinfo, ts2=ts2, tinfo=tinfo,
                js3=js3, ts3=ts3)


def test_model_concatenates_at_static_offsets(run):
    model = run["ts0"].model
    assert isinstance(model, AtlasModel) and model.names == ["gs_base", "gs_fg"]
    assert model.point_num_sep() == [0, 256, 256 + FG_CAP] and model.slice_for("gs_fg") == (256, 256 + FG_CAP)
    jf = run["js0"].model.forward(jnp.asarray(2.5, jnp.float32))
    tf = model.forward(2.5)
    assert sorted(jf) == sorted(tf)
    for k in tf:
        np.testing.assert_allclose(tf[k].numpy(), np.array(jf[k]), atol=1e-6, err_msg=k)
    assert np.array_equal(model.alive.numpy(), np.array(run["js0"].model.alive))
    single = AtlasModel.single(model.get_atlas("gs_fg"))
    assert single.names == ["gs_base"] and single.point_num_sep() == [0, FG_CAP]
    assert model.replace_atlas("gs_fg", model.get_atlas("gs_base")).point_num_sep()[-1] == 512


@pytest.mark.parametrize("name", ["loss", "loss_rgb", "loss_flow", "loss_depth", "loss_arap", "psnr",
                                  "num_intersections"])
def test_atlas_step_metrics_match(run, name):
    np.testing.assert_allclose(float(run["tm"][name]), float(run["jm"][name]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("atlas", ["gs_base", "gs_fg"])
def test_atlas_step_matches(run, atlas):
    inner = run["js1"].opt_states[atlas].inner_states
    tst = run["ts1"]
    nonzero = 0
    for name, v in inner.items():
        adam = v.inner_state[0]
        for kind in ("mu", "nu"):
            j = np.array(getattr(adam, kind)[name])
            np.testing.assert_allclose(getattr(tst.opt_states[atlas], kind)[name].numpy(), j, rtol=G_RTOL,
                                       atol=G_ATOL * max(np.abs(j).max(), 1e-30), err_msg=f"{kind}[{name}]")
        g = np.array(adam.mu[name]) / 0.1
        nonzero += np.abs(g).max() > 0
        sel = np.abs(g) >= 1e-4 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
        np.testing.assert_allclose(tst.model.atlases[atlas].params[name].numpy()[sel],
                                   np.array(run["js1"].model.atlases[atlas].params[name])[sel], atol=1e-6, rtol=0,
                                   err_msg=name)
    assert nonzero >= 6 and tst.opt_states[atlas].count == 1
    for name in ("max_radii2d", "pos_grad_accum", "denom"):
        t = getattr(tst.densify_states[atlas], name).numpy()
        np.testing.assert_allclose(t, np.array(getattr(run["js1"].densify_states[atlas], name)), rtol=1e-4,
                                   atol=1e-9, err_msg=name)
        assert t.max() > 0
    assert tst.step == 1 and np.array_equal(tst.key.numpy(), np.array(run["js1"].key))


@pytest.mark.parametrize("atlas", ["gs_base", "gs_fg"])
def test_atlas_density_and_reset_match(run, atlas):
    for f in tden.DensifyInfo._fields:
        assert int(getattr(run["tinfo"][atlas], f)) == int(getattr(run["jinfo"][atlas], f)), f
    t2, j2 = run["ts2"].model.atlases[atlas], run["js2"].model.atlases[atlas]
    assert np.array_equal(t2.alive.numpy(), np.array(j2.alive))
    assert int(run["tinfo"][atlas].num_alive) == int(t2.num_alive)
    for name in t2.params:
        np.testing.assert_allclose(t2.params[name].numpy(), np.array(j2.params[name]), atol=1e-6, err_msg=name)
    np.testing.assert_allclose(run["ts3"].model.atlases[atlas].params["opacity"].numpy(),
                               np.array(run["js3"].model.atlases[atlas].params["opacity"]), atol=1e-6)
    assert np.array_equal(run["ts2"].key.numpy(), np.array(run["js2"].key))
