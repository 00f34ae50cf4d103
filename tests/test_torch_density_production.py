"""Density control at the production harness's size, the port against the
JAX package, exactly: one `densify_and_prune` event, `reset_opacity` and
the saturation latch of `fit_clip` on the same numpy state.

The state is the one a 480p flagship fit holds at its 10th event (step
1500): 131,072 slots with 123,800 or 126,237 alive, scattered as earlier
events leave them; the parameter set that `fit.build_scene_from_clip`
builds (cubic-spline trajectories, the mask and DINO attributes), or the
lbs set whose bone trajectories are shared (first axis not the capacity);
Adam moments and statistics mid-fit; `cameras_extent` 5, `split_num` 2,
`size_prune_always`, a 5% growth budget. The viewspace gradients put
about three times the budget's children on the candidate list, the
largest scales straddle the clone / split boundary (0.005) and some pass
the size prune (0.5). With 123,800 alive the budget binds (6,190 of
7,272 free slots), with 126,237 the free slots bind (4,835 of 6,312);
the [ties] cases draw the statistics from a few hundred (sum, count)
pairs, so `grads` ties exactly across the budget's cut, as integer visit
counts and repeated accumulations make it tie in a fit.

The JAX event runs under `jax.jit`, as `trainer.make_train_step`'s
density step does, and draws its split noise from the key; the port gets
the same draws (`noise=`), and in [own draws] its own (`train/prng.py`,
JAX's threefry, within a few ulps of JAX's normal). Tolerances: every
mask, count, parameter, moment and statistic exactly, but for the
positions of split children under the port's own draws, which move with
the noise (atol 1e-6, as `tests/test_torch_train_step.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.train import density as jden
from splatter_a_video_tpu.train import fit as jfit
from splatter_a_video_tpu.train import optim as jopt
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import trainer as ttr

CAP, T, STEP = 131_072, 48, 1500
POS_ATOL = 1e-6
ATTRS = (("mask_attribute", 1), ("dino_attribute", 3))
DENSIFY = dict(max_growth_frac=0.05, size_prune_always=True, cameras_extent=5.0, split_num=2)
# (alive, statistics drawn with exact ties, scene trajectories)
CASES = {
    "budget": (123_800, False, "cubic_spline"),
    "free_slots": (126_237, False, "cubic_spline"),
    "budget_ties": (123_800, True, "cubic_spline"),
    "free_slots_ties": (126_237, True, "cubic_spline"),
    "lbs_shared": (123_800, True, "lbs"),
}


def scene_config(traj):
    return dict(capacity=CAP, num_frames=T, traj=traj, render_attributes=ATTRS)


def param_layout(traj):
    """{name: shape} of the scene `create_scene` builds for `traj` at CAP
    slots (a small scene, scaled up along the per-Gaussian axis)."""
    small = 256
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    s = jgs.create_scene(jgs.SceneConfig(**{**scene_config(traj), "capacity": small}), pos,
                         rng.uniform(0, 1, (100, 3)).astype(np.float32), init_opacity=0.5,
                         track_seq=np.repeat(pos[None], T, 0) if traj == "cubic_spline" else None)
    layout = {k: ((CAP,) + v.shape[1:] if v.shape[0] == small else v.shape) for k, v in s.params.items()}
    return layout, {k: np.array(v) for k, v in s.aux.items() if k != "alive"}


def production_state(n_alive, ties, traj, seed=0):
    """numpy arrays of a mid-fit train state at the production size."""
    rng = np.random.RandomState(seed)
    layout, aux = param_layout(traj)
    params = {k: (rng.standard_normal(shape) * 0.3).astype(np.float32) for k, shape in layout.items()}
    params["position"][:, 2] += 1.0
    # log scales: the largest of three straddles percent_dense * extent = 0.005;
    # 1% reach past the size prune's 0.1 * extent = 0.5
    params["scaling"] = np.log(rng.uniform(0.0008, 0.012, (CAP, 3))).astype(np.float32)
    big = rng.uniform(0, 1, CAP) < 0.01
    params["scaling"][big, 0] = np.log(rng.uniform(0.3, 0.9, big.sum())).astype(np.float32)
    params["rotation"] = rng.standard_normal((CAP, 4)).astype(np.float32)
    # opacity logits: sigmoid < 0.05 (logit -2.944) for about 8%
    params["opacity"] = rng.uniform(-3.4, 2.5, (CAP, 1)).astype(np.float32)

    alive = np.zeros(CAP, bool)
    alive[rng.permutation(CAP)[:n_alive]] = True   # free slots scattered by earlier events

    # visits over the last 100 steps (integer counts) and summed viewspace
    # gradient norms: ~9% of the alive are hot (grads >= 2e-4), about three
    # times the 5% budget in children (a split has two)
    denom = rng.randint(0, 60, CAP).astype(np.float32)
    if ties:
        pool_d = rng.randint(1, 60, 300).astype(np.float32)
        pool_g = np.exp(rng.normal(np.log(8e-5), 1.0, 300)).astype(np.float32)
        pick = rng.randint(0, 300, CAP)
        denom = pool_d[pick]
        accum = (pool_g[pick] * denom).astype(np.float32)
    else:
        accum = (np.exp(rng.normal(np.log(8e-5), 1.0, CAP)) * denom).astype(np.float32)
    accum[denom == 0] = 0.0
    radii = rng.randint(0, 40, CAP).astype(np.float32)

    mu = {k: (rng.standard_normal(layout[k]) * 1e-4).astype(np.float32) for k in layout}
    nu = {k: (rng.uniform(0, 1e-8, layout[k])).astype(np.float32) for k in layout}
    return dict(params=params, aux={"alive": alive, **aux}, cfg=scene_config(traj),
                opt={"count": STEP, "mu": mu, "nu": nu},
                densify={"max_radii2d": radii, "pos_grad_accum": accum, "denom": denom},
                step=STEP, key=np.array([0, 1500], np.uint32))


def jax_state(a):
    """The JAX `TrainState` of `production_state`'s arrays."""
    params = {k: jnp.asarray(v) for k, v in a["params"].items()}
    scene = jgs.GaussianScene(params=params, aux={k: jnp.asarray(v) for k, v in a["aux"].items()},
                              cfg=jgs.SceneConfig(**a["cfg"]))
    st = jopt.make_optimizer(jopt.OptimConfig()).init(params)
    count = jnp.asarray(a["opt"]["count"], jnp.int32)
    inner = {}
    for k, masked in st.inner_states.items():
        adam, *rest = masked.inner_state
        adam = adam._replace(count=count, mu={**adam.mu, k: jnp.asarray(a["opt"]["mu"][k])},
                             nu={**adam.nu, k: jnp.asarray(a["opt"]["nu"][k])})
        rest = [r._replace(count=count) if "count" in r._fields else r for r in rest]
        inner[k] = masked._replace(inner_state=(adam, *rest))
    st = st._replace(inner_states=inner)
    dstate = jden.DensifyState(**{k: jnp.asarray(v) for k, v in a["densify"].items()})
    return jtr.TrainState(scene, st, dstate, jnp.asarray(a["step"], jnp.int32), jnp.asarray(a["key"]))


def jax_moments(opt_state):
    adam = {k: v.inner_state[0] for k, v in opt_state.inner_states.items()}
    return ({k: np.array(a.mu[k]) for k, a in adam.items()}, {k: np.array(a.nu[k]) for k, a in adam.items()})


_jit_densify = jax.jit(jden.densify_and_prune, static_argnums=(4,))


def run_event(case, own_draws=False):
    n_alive, ties, traj = CASES[case]
    a = production_state(n_alive, ties, traj)
    js = jax_state(a)
    key = jax.random.PRNGKey(7)
    jscene, jo, jd, jinfo = _jit_densify(js.scene, js.opt_state, js.densify_state, js.step,
                                         jden.DensifyConfig(**DENSIFY), key)
    ts = convert.train_state_from_numpy(**a, device="cpu")
    noise = None if own_draws else torch.from_numpy(np.array(jax.random.normal(key, (CAP, 3))))
    tkey = torch.as_tensor(np.array(key, np.int64))
    tscene, to, td, tinfo = tden.densify_and_prune(ts.scene, ts.opt_state, ts.densify_state, ts.step,
                                                   tden.DensifyConfig(**DENSIFY), noise=noise, key=tkey)
    return a, (jscene, jo, jd, jinfo), (tscene, to, td, tinfo)


def children(a, jscene):
    """The slots the event placed children in (dead before, alive after)."""
    return ~a["aux"]["alive"] & np.array(jscene.alive)


def assert_positions(tpos, jpos, kids):
    """Exact but at the children placed; there within POS_ATOL, a few ulps
    of positions below 4 in size: the split children's offsets, `R @ (noise
    * exp(scaling))`, round otherwise in XLA's fused CPU code (its own exp,
    the product as an FMA chain)."""
    np.testing.assert_array_equal(tpos[~kids], jpos[~kids])
    np.testing.assert_allclose(tpos[kids], jpos[kids], rtol=0, atol=POS_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_event_at_production_size_matches_exactly(case):
    a, (jscene, jo, jd, jinfo), (tscene, to, td, tinfo) = run_event(case)
    info = {f: int(getattr(jinfo, f)) for f in jden.DensifyInfo._fields}
    assert info == {f: int(getattr(tinfo, f)) for f in tden.DensifyInfo._fields}
    n_alive = CASES[case][0]
    budget = int(np.ceil(np.float32(0.05) * np.float32(n_alive)))
    kids = children(a, jscene)
    # the production regime: the budget or the free slots cut the list
    assert kids.sum() == min(budget, CAP - n_alive), (kids.sum(), budget, CAP - n_alive)
    assert info["dropped"] > 2 * kids.sum() and info["num_split"] > 0 and info["num_cloned"] > 0
    assert info["num_pruned"] > 0
    np.testing.assert_array_equal(tscene.alive.numpy(), np.array(jscene.alive))
    assert sorted(tscene.params) == sorted(jscene.params)
    for k, v in jscene.params.items():
        if k == "position":
            assert_positions(tscene.params[k].numpy(), np.array(v), kids)
        else:
            np.testing.assert_array_equal(tscene.params[k].numpy(), np.array(v), err_msg=k)
    jmu, jnu = jax_moments(jo)
    for k in jmu:
        np.testing.assert_array_equal(to.mu[k].numpy(), jmu[k], err_msg=f"mu[{k}]")
        np.testing.assert_array_equal(to.nu[k].numpy(), jnu[k], err_msg=f"nu[{k}]")
    assert to.count == int(jo.inner_states["position"].inner_state[0].count)
    for f in tden.DensifyState._fields:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.array(getattr(jd, f)), err_msg=f)
        assert not np.array(getattr(jd, f)).any()
    for k, v in a["aux"].items():
        if k != "alive":
            np.testing.assert_array_equal(tscene.aux[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("case", ["budget_ties", "free_slots_ties"])
def test_event_with_the_ports_own_draws(case):
    """The port's key draws JAX's split noise but for a few ulps: all but
    the split children's positions stay exact."""
    a, (jscene, jo, _, jinfo), (tscene, to, _, tinfo) = run_event(case, own_draws=True)
    for f in jden.DensifyInfo._fields:
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    np.testing.assert_array_equal(tscene.alive.numpy(), np.array(jscene.alive))
    kids = children(a, jscene)
    for k, v in jscene.params.items():
        if k == "position":
            assert_positions(tscene.params[k].numpy(), np.array(v), kids)
        else:
            np.testing.assert_array_equal(tscene.params[k].numpy(), np.array(v), err_msg=k)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_candidate_order_is_jax_order(ties):
    """The candidate order (clones, then splits, each hottest first) of the
    port's `_lexsort` against `jnp.lexsort` on the same keys: equal where
    it decides anything, over the hot slots. `jnp.lexsort` is a 3-key
    `lax.sort` that XLA need not keep stable; the order of tied `grads`
    decides which children the budget keeps."""
    a = production_state(123_800, ties, "cubic_spline")
    d = a["densify"]
    grads = np.where(d["denom"] > 0, d["pos_grad_accum"] / np.maximum(d["denom"], 1), 0).astype(np.float32)
    max_scale = np.exp(a["params"]["scaling"]).max(-1)
    hot = a["aux"]["alive"] & (grads >= np.float32(2e-4))
    split = hot & (max_scale > np.float32(0.005))
    prio = np.where(hot, grads, -np.inf).astype(np.float32)
    jorder = np.array(jnp.lexsort((jnp.asarray(-prio), jnp.asarray(split), jnp.asarray(~hot))))
    torder = tden._lexsort((torch.from_numpy(-prio), torch.from_numpy(split).to(torch.int8),
                            torch.from_numpy(~hot).to(torch.int8))).numpy()
    n_hot = int(hot.sum())
    if ties:
        assert len(np.unique(grads[hot])) < n_hot // 10
    np.testing.assert_array_equal(torder[:n_hot], jorder[:n_hot])
    # and within each tie class, JAX's CPU sort keeps slot order (stable)
    g = grads[jorder[:n_hot]]
    s = split[jorder[:n_hot]]
    same = (g[1:] == g[:-1]) & (s[1:] == s[:-1])
    assert np.all(jorder[1:n_hot][same] > jorder[:n_hot - 1][same])


@pytest.mark.parametrize("n_alive", [123_800, 126_237, 127_139, 127_140])
def test_growth_budget_rounding_matches(n_alive):
    """`ceil(0.05 * alive)` in float32 on both sides."""
    alive = np.zeros(CAP, bool)
    alive[:n_alive] = True
    j = int(jnp.ceil(0.05 * jnp.sum(jnp.asarray(alive))).astype(jnp.int32))
    t = int(torch.ceil(0.05 * torch.sum(torch.from_numpy(alive)).to(torch.float32)).to(torch.int64))
    assert j == t == int(np.ceil(np.float32(0.05) * np.float32(n_alive)))


@pytest.mark.parametrize("traj", ["cubic_spline", "lbs"])
def test_reset_opacity_at_production_size_matches(traj):
    a = production_state(126_237, False, traj)
    js = jax_state(a)
    jscene, jo = jax.jit(jden.reset_opacity)(js.scene, js.opt_state)
    ts = convert.train_state_from_numpy(**a, device="cpu")
    tscene, to = tden.reset_opacity(ts.scene, ts.opt_state)
    for k, v in jscene.params.items():
        np.testing.assert_array_equal(tscene.params[k].numpy(), np.array(v), err_msg=k)
    assert float(np.array(jscene.params["opacity"]).max()) <= float(np.log(0.01 / 0.99)) + 1e-6
    jmu, jnu = jax_moments(jo)
    for k in jmu:
        np.testing.assert_array_equal(to.mu[k].numpy(), jmu[k], err_msg=f"mu[{k}]")
        np.testing.assert_array_equal(to.nu[k].numpy(), jnu[k], err_msg=f"nu[{k}]")
    assert not jmu["opacity"].any() and jmu["position"].any()


# ---- the saturation latch in fit_clip ---------------------------------------


class _Scene:
    """A stand-in for the fitted scene: the latch reads its capacity."""

    def __init__(self, scene):
        self.cfg = dataclasses.replace(scene.cfg, capacity=CAP)
        self.params = scene.params
        self.num_alive = 0


class _Info(tuple):
    """A stand-in `DensifyInfo` of one event (plain ints)."""

    _fields = tden.DensifyInfo._fields

    def __new__(cls, alive):
        return super().__new__(cls, (11, 7, 3, 20_000, alive))

    def __getattr__(self, name):
        return self[self._fields.index(name)]

    def _asdict(self):
        return dict(zip(self._fields, self))


def _stub_steps(mod, alive_seq, calls):
    """`make_train_step` and `init_train_state` for a fit loop whose train
    step only counts steps and whose density step returns the events'
    alive counts in turn."""

    def make_train_step(cfg, extr, frames=None, device=None):
        def train_step(state, batch):
            return state._replace(step=state.step + 1), {"loss": torch.zeros(()), "psnr": torch.zeros(())}

        def density_step(state):
            calls.append(int(state.step))
            return state, _Info(alive_seq[len(calls) - 1])

        return train_step, density_step, (lambda state: state)

    def init_train_state(cfg, scene, seed=0, device=None):
        return mod.TrainState(_Scene(scene), None, None, 0, None)

    return make_train_step, init_train_state


@pytest.mark.parametrize("alive_seq,stop", [
    ((120_000, 124_000, 127_139, 127_140, 128_000), 900),    # 0.97 x 131,072 = 127,139.84
    ((127_140, 128_000, 128_000, 128_000, 128_000), 600),
    ((127_139, 127_139, 127_139, 127_139, 127_139), None),
], ids=["fourth", "first", "never"])
def test_saturation_latch_matches(monkeypatch, alive_seq, stop):
    """The latch of both fit loops (`fit.fit_clip`, after each event) at
    131,072 slots: events at 600-1000 (start 500, interval 100) return the
    given alive counts; both loops stop calling the density step at the
    same event and record the same totals and stop step."""
    clip = tsyn.make_clip(tsyn.SyntheticClipConfig(width=32, height=24, num_frames=4, blob_radius=4.0,
                                                   num_blobs=2, track_grid=4, texture=True))
    kw = dict(num_iters=1000, num_fg_samples=20, num_bg_samples=10, num_track_samples=4,
              log_every=1000, init_num_points=64)
    out = {}
    for package, fitmod, mod, denmod in (("jax", jfit, jtr, jden), ("port", tfit, ttr, tden)):
        calls = []
        make, init = _stub_steps(mod, alive_seq, calls)
        monkeypatch.setattr(mod, "make_train_step", make)
        monkeypatch.setattr(mod, "init_train_state", init)
        tcfg = mod.TrainerConfig(width=32, height=24, num_frames=4, num_track_samples=4,
                                 densify=denmod.DensifyConfig(**DENSIFY))
        extra = {} if package == "jax" else {"device": "cpu"}
        _, hist = fitmod.fit_clip(clip, fitmod.FitConfig(**kw), tcfg, **extra)
        out[package] = (calls, hist[-1]["densify_totals"])
    assert out["port"] == out["jax"]
    calls, totals = out["jax"]
    assert totals.get("stopped_at_step") == stop
    assert calls == list(range(600, (stop or 1000) + 1, 100))
