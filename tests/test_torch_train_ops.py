"""Port parity for the training slice's modules, each on the same numpy
inputs in both packages (JAX on the CPU): SSIM, kNN, the main-path losses
(values and gradients), the per-attribute Adam with its schedules,
density control and `create_scene`.

Tolerances: values and gradients rtol 1e-5 / atol 1e-6 unless stated
(float32 sums in another order); kNN distances atol 1e-5 (the squared
distance cancels |q|^2 + |p|^2 - 2 q.p); kNN indices and every integer or mask
exactly; Adam moments rtol 1e-5, params atol 1e-6 (gradients are kept
away from 0, where Adam's first steps would follow the sign of noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.models import gaussians as jgs
from splatter_a_video_tpu.ops import knn as jknn
from splatter_a_video_tpu.ops import ssim as jssim
from splatter_a_video_tpu.train import density as jden
from splatter_a_video_tpu.train import losses as jl
from splatter_a_video_tpu.train import optim as jopt
from splatter_a_video_tpu_torch.models import gaussians as tgs
from splatter_a_video_tpu_torch.models import init_points as tinit
from splatter_a_video_tpu_torch.ops import knn as tknn
from splatter_a_video_tpu_torch.ops import ssim as tssim
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import losses as tl
from splatter_a_video_tpu_torch.train import optim as topt
from splatter_a_video_tpu_torch.train import prng as tprng

RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def value_and_grads(jfn, tfn, arrays, argnums):
    """Value and gradients of jfn (JAX) and tfn (torch) w.r.t. `argnums`."""
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in argnums:
        ts[i].requires_grad_(True)
    tv = tfn(*ts)
    tv.backward()
    return (jv, jg), (tv, [ts[i].grad for i in argnums])


# ---- SSIM -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64, 3), (2, 30, 41, 3)])
def test_ssim_and_its_gradient_match(shape):
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.randn(*shape).astype(np.float32) * 0.1, 0, 1)
    (jv, jg), (tv, tg) = value_and_grads(jssim.ssim, tssim.ssim, [a, b], (0, 1))
    close(tv, jv)
    for x, y in zip(tg, jg):
        close(x, y, atol=1e-7, rtol=1e-4)
    close(tssim.d_ssim(torch.from_numpy(a), torch.from_numpy(b)), jssim.d_ssim(a, b))


def test_ssim_per_batch_values():
    rng = np.random.RandomState(1)
    a, b = (rng.uniform(0, 1, (3, 20, 24, 2)).astype(np.float32) for _ in range(2))
    close(tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=False),
          jssim.ssim(a, b, size_average=False))


# ---- kNN --------------------------------------------------------------------


@pytest.mark.parametrize("n,q,k,chunk", [(300, 300, 4, 128), (300, 50, 6, 2048), (3, 3, 5, 2048)])
def test_knn_matches(n, q, k, chunk):
    rng = np.random.RandomState(n + k)
    pts = rng.randn(n, 3).astype(np.float32)
    query = pts[:q]
    jd, ji = jknn.knn(jnp.asarray(query), jnp.asarray(pts), k=k, chunk=chunk)
    td, ti = tknn.knn(torch.from_numpy(query), torch.from_numpy(pts), k=k, chunk=chunk)
    close(td, jd, atol=1e-5)   # |q|^2 + |p|^2 - 2 q.p cancels to ~1e-6 at distance 0
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n", [1, 2, 500])
def test_mean_knn3_sq_dist_matches(n):
    pts = np.random.RandomState(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    close(tknn.mean_knn3_sq_dist(torch.from_numpy(pts), chunk=128),
          jknn.mean_knn3_sq_dist(jnp.asarray(pts), chunk=128))


def test_pairwise_sq_dists_gradient_matches():
    rng = np.random.RandomState(2)
    q, p = rng.randn(7, 3).astype(np.float32), rng.randn(40, 3).astype(np.float32)
    w = rng.randn(7, 40).astype(np.float32)
    (jv, jg), (tv, tg) = value_and_grads(
        lambda a, b: jnp.sum(jknn._pairwise_sq_dists(a, b) * w),
        lambda a, b: torch.sum(tknn._pairwise_sq_dists(a, b) * torch.from_numpy(w)), [q, p], (0, 1))
    close(tv, jv, rtol=1e-5, atol=1e-4)
    for x, y in zip(tg, jg):
        close(x, y, rtol=1e-5, atol=1e-4)


# ---- photometric, tracking and depth losses -----------------------------------


def test_l1_psnr_rgb_loss_match():
    rng = np.random.RandomState(3)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    close(tl.l1_loss(torch.from_numpy(a), torch.from_numpy(b)), jl.l1_loss(a, b))
    close(tl.psnr(torch.from_numpy(a), torch.from_numpy(b)), jl.psnr(a, b))
    close(tl.psnr(torch.from_numpy(a), torch.from_numpy(a)), jl.psnr(a, a))
    (jv, jg), (tv, tg) = value_and_grads(lambda x: jl.rgb_loss(x, b, 0.2),
                                         lambda x: tl.rgb_loss(x, torch.from_numpy(b), 0.2), [a], (0,))
    close(tv, jv)
    close(tg[0], jg[0], atol=1e-8, rtol=1e-4)


@pytest.mark.parametrize("quantile,with_valid,normalize", [(1.0, False, True), (0.98, True, True),
                                                           (0.5, False, False), (0.9, True, False)])
def test_masked_l1_loss_matches(quantile, with_valid, normalize):
    rng = np.random.RandomState(4)
    pred, gt = rng.randn(64, 2).astype(np.float32), rng.randn(64, 2).astype(np.float32)
    mask = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    valid = rng.uniform(0, 1, 64) > 0.2
    v = valid if with_valid else None
    (jv, jg), (tv, tg) = value_and_grads(
        lambda p: jl.masked_l1_loss(p, gt, mask, normalize, quantile, None if v is None else jnp.asarray(v)),
        lambda p: tl.masked_l1_loss(p, torch.from_numpy(gt), torch.from_numpy(mask), normalize, quantile,
                                    None if v is None else torch.from_numpy(v)), [pred], (0,))
    close(tv, jv)
    close(tg[0], jg[0])


@pytest.mark.parametrize("shape", [(48, 64), (7, 9)])   # even and odd pixel counts
def test_depth_loss_dpt_matches(shape):
    rng = np.random.RandomState(5)
    pred = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    gt = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    (jv, jg), (tv, tg) = value_and_grads(lambda p: jl.depth_loss_dpt(p, gt),
                                         lambda p: tl.depth_loss_dpt(p, torch.from_numpy(gt)), [pred], (0,))
    close(tv, jv)
    close(tg[0], jg[0], atol=1e-8, rtol=1e-4)
    w = rng.uniform(0, 1, shape).astype(np.float32)
    close(tl.depth_loss_dpt(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(w)),
          jl.depth_loss_dpt(pred, gt, w))


def test_tracking_loss_matches():
    rng = np.random.RandomState(6)
    H, W, P = 48, 64, 40
    track_map = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    qp = np.stack([rng.randint(0, W, P), rng.randint(0, H, P)], 1).astype(np.float32)
    gt = (qp + rng.randn(P, 2) * 3).astype(np.float32)
    occ, dist = (rng.uniform(-6, 2, P).astype(np.float32) for _ in range(2))
    jvis, jinv, jconf = jl.parse_tapir_track_info(occ, dist)
    tvis, tinv, tconf = tl.parse_tapir_track_info(torch.from_numpy(occ), torch.from_numpy(dist))
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    close(tconf, jconf)
    (jv, jg), (tv, tg) = value_and_grads(
        lambda m: jl.tracking_loss(m, qp, gt, jvis, jconf, 3.0, 8, H, W),
        lambda m: tl.tracking_loss(m, torch.from_numpy(qp), torch.from_numpy(gt), tvis, tconf, 3.0, 8, H, W),
        [track_map], (0,))
    close(tv, jv)
    close(tg[0], jg[0])


# ---- ARAP ---------------------------------------------------------------------


def arap_points(n=200, seed=7):
    rng = np.random.RandomState(seed)
    p1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    p2 = (p1 + 0.02 * rng.randn(n, 3)).astype(np.float32)
    alive = np.arange(n) < n - 30
    idx = rng.randint(0, n - 30, 48).astype(np.int32)
    return p1, p2, alive, idx


def test_arap_connectivity_matches():
    p1, _, alive, idx = arap_points()
    jn, jw, jv = jl.arap_connectivity(jnp.asarray(p1), query_idx=jnp.asarray(idx), alive=jnp.asarray(alive))
    tn, tw, tv = tl.arap_connectivity(torch.from_numpy(p1), query_idx=torch.from_numpy(idx).long(),
                                      alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    close(tw, jw)


def test_arap_loss_and_gradient_match():
    p1, p2, alive, idx = arap_points()
    key = jax.random.PRNGKey(0)
    jidx = jax.random.choice(key, len(p1), (48,), replace=True,
                             p=jnp.asarray(alive, jnp.float32) / alive.sum())
    (jv, jg), (tv, tg) = value_and_grads(
        lambda a, b: jl.arap_loss(a, b, key, sample_num=48, alive=jnp.asarray(alive)),
        lambda a, b: tl.arap_loss(a, b, torch.from_numpy(np.array(jidx)).long(), sample_num=48,
                                  alive=torch.from_numpy(alive)),
        [p1, p2], (0, 1))
    assert float(jv) > 0
    close(tv, jv, rtol=1e-4)
    for x, y in zip(tg, jg):
        close(x, y, rtol=1e-3, atol=1e-6)


def test_arap_sample_draws_alive_slots_only():
    alive = torch.arange(1000) < 37
    idx = tl.arap_sample(1000, 512, alive, tprng.key(0))
    assert idx.shape == (512,) and bool((idx < 37).all())
    assert tl.arap_sample(100, 10, None, tprng.key(0)).shape == (10,)
    # as in JAX, never more samples than points
    assert tl.arap_sample(20, 512, None, tprng.key(0)).shape == (20,)
    # and the JAX package's draws from the same key
    key = jax.random.PRNGKey(3)
    p = jnp.asarray(alive.numpy(), jnp.float32) / 37.0
    assert np.array_equal(tl.arap_sample(1000, 512, alive, tprng.key(3)).numpy(),
                          np.array(jax.random.choice(key, 1000, (512,), replace=True, p=p)))
    assert np.array_equal(tl.arap_sample(100, 10, None, tprng.key(3)).numpy(),
                          np.array(jax.random.randint(key, (10,), 0, 100)))


@pytest.mark.parametrize("kind", ["random", "unchanged", "degenerate", "reflection"])
def test_estimate_rotation_matches(kind):
    rng = np.random.RandomState(8)
    n, k = 16, 5
    src = rng.randn(n, k, 3).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)
    if kind == "random":
        tgt = src + 0.1 * rng.randn(n, k, 3).astype(np.float32)
    elif kind == "unchanged":          # S = 0 + 1e-8 I
        tgt = src.copy()
    elif kind == "degenerate":         # all-zero edges
        src = np.zeros_like(src)
        tgt = 0.1 * rng.randn(n, k, 3).astype(np.float32)
    else:                              # a mirror image: the reflection fix engages
        tgt = src * np.array([1.0, 1.0, -1.0], np.float32) + 0.01 * rng.randn(n, k, 3).astype(np.float32)
    jr = np.asarray(jl.estimate_rotation(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w)))
    tr = tl.estimate_rotation(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(w)).numpy()
    close(tr, jr, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.det(tr), 1.0, atol=1e-4)
    if kind == "reflection":
        S = np.einsum("nka,nk,nkb->nab", src, w, tgt)
        assert (np.linalg.det(np.linalg.svd(S)[2].transpose(0, 2, 1) @ np.linalg.svd(S)[0].transpose(0, 2, 1)) < 0).all()


# ---- optimizer ----------------------------------------------------------------


def test_expon_lr_matches():
    j = jopt.expon_lr(6e-5, 1.6e-6, 200, 5.0)
    t = topt.expon_lr(6e-5, 1.6e-6, 200, 5.0)
    for step in (0, 1, 37, 199, 200, 500):
        close(t(step), j(step), rtol=1e-6, atol=0)


def test_adam_three_steps_with_schedules_match():
    rng = np.random.RandomState(9)
    shapes = {"position": (30, 3), "opacity": (30, 1), "pos_poly_feat": (30, 4, 3), "unknown": (30, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (np.sign(rng.randn(*s)) * rng.uniform(0.1, 1.0, s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg_j, cfg_t = jopt.OptimConfig(max_steps=10), topt.OptimConfig(max_steps=10)
    opt = jopt.make_optimizer(cfg_j)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.adam_init(tp)
    mask = np.zeros(30, bool)
    mask[[1, 5, 7]] = True
    for i, g in enumerate(grads):
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        tp, ts = topt.adam_update(cfg_t, tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        if i == 1:
            js = jopt.zero_moments_at(js, jnp.asarray(mask))
            ts = topt.zero_moments_at(ts, torch.from_numpy(mask))
    assert ts.count == 3
    for k in shapes:
        inner = js.inner_states[k].inner_state[0]
        assert int(inner.count) == 3
        close(ts.mu[k], inner.mu[k], msg=k)
        close(ts.nu[k], inner.nu[k], msg=k)
        close(tp[k], jp[k], rtol=0, atol=1e-6, msg=k)


def test_zero_moments_at_named_attributes_only():
    st = topt.adam_init({"opacity": torch.ones(4, 1), "scaling": torch.ones(4, 3)})
    st = topt.AdamState(1, {k: v + 1 for k, v in st.mu.items()}, {k: v + 2 for k, v in st.nu.items()})
    out = topt.zero_moments_at(st, torch.tensor([True, False, False, True]), names=("opacity",))
    assert out.mu["opacity"][:, 0].tolist() == [0.0, 1.0, 1.0, 0.0]
    assert torch.equal(out.mu["scaling"], st.mu["scaling"]) and out.count == 1


# ---- density --------------------------------------------------------------------


def density_inputs(cap=64, n=40, seed=10):
    rng = np.random.RandomState(seed)
    params = {
        "position": rng.randn(cap, 3).astype(np.float32),
        "scaling": np.log(rng.uniform(0.001, 0.02, (cap, 3))).astype(np.float32),
        "rotation": rng.randn(cap, 4).astype(np.float32),
        "opacity": rng.uniform(-4, 2, (cap, 1)).astype(np.float32),
        "features_dc": rng.randn(cap, 1, 3).astype(np.float32),
        "lbs_bone_poly": rng.randn(3, 4, 3).astype(np.float32),   # shared: never touched
    }
    alive = np.arange(cap) < n
    dstate = [rng.uniform(0, 1, cap).astype(np.float32) * 3 for _ in range(3)]
    dstate[1] = (rng.uniform(0, 1e-3, cap) * (rng.uniform(0, 1, cap) > 0.4)).astype(np.float32)
    dstate[2] = np.floor(dstate[2]).astype(np.float32)
    noise = rng.randn(cap, 3).astype(np.float32)
    return params, alive, dstate, noise


@pytest.mark.parametrize("kw,step", [({}, 10), ({"max_growth_frac": 0.1}, 10),
                                     ({"size_prune_always": True}, 10), ({}, 4000)])
def test_densify_and_prune_matches(kw, step):
    params, alive, dstate, noise = density_inputs()
    cfg_kw = dict(percent_dense=0.002, min_opacity=0.05, **kw)
    jcfg_s = jgs.SceneConfig(capacity=64, num_frames=2, traj="static")
    jscene = jgs.GaussianScene(params={k: jnp.asarray(v) for k, v in params.items()},
                               aux={"alive": jnp.asarray(alive)}, cfg=jcfg_s)
    jopt_state = jopt.make_optimizer(jopt.OptimConfig()).init(jscene.params)
    jopt_state = jax.tree_util.tree_map(lambda x: x + 1.0 if x.dtype == jnp.float32 else x, jopt_state)
    js, jo, jd, jinfo = jden.densify_and_prune(
        jscene, jopt_state, jden.DensifyState(*map(jnp.asarray, dstate)), jnp.asarray(step),
        jden.DensifyConfig(**cfg_kw), jax.random.PRNGKey(0))
    tscene = tgs.GaussianScene(params={k: torch.from_numpy(v) for k, v in params.items()},
                               aux={"alive": torch.from_numpy(alive)},
                               cfg=tgs.SceneConfig(capacity=64, num_frames=2, traj="static"))
    tst = topt.adam_init(tscene.params)
    tst = topt.AdamState(0, {k: v + 1.0 for k, v in tst.mu.items()}, {k: v + 1.0 for k, v in tst.nu.items()})
    jnoise = jax.random.normal(jax.random.PRNGKey(0), (64, 3))
    ts, to, td, tinfo = tden.densify_and_prune(
        tscene, tst, tden.DensifyState(*map(torch.from_numpy, dstate)), step,
        tden.DensifyConfig(**cfg_kw), noise=torch.from_numpy(np.array(jnoise)))
    for f in tden.DensifyInfo._fields:
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    assert int(tinfo.num_cloned) + int(tinfo.num_split) > 0
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for k in params:
        close(ts.params[k], js.params[k], msg=k)
        close(to.mu[k], jo.inner_states[k].inner_state[0].mu[k], msg=k)
    for f in tden.DensifyState._fields:
        assert float(getattr(td, f).abs().sum()) == 0.0


def test_accumulate_stats_matches():
    rng = np.random.RandomState(11)
    st = [rng.uniform(0, 2, 50).astype(np.float32) for _ in range(3)]
    vis = rng.uniform(0, 1, 50) > 0.3
    radii = rng.randint(0, 9, 50).astype(np.int32)
    g = rng.uniform(0, 1e-3, 50).astype(np.float32)
    j = jden.accumulate_stats(jden.DensifyState(*map(jnp.asarray, st)), jnp.asarray(vis), jnp.asarray(radii), jnp.asarray(g))
    t = tden.accumulate_stats(tden.DensifyState(*map(torch.from_numpy, st)), torch.from_numpy(vis),
                              torch.from_numpy(radii), torch.from_numpy(g))
    for a, b in zip(t, j):
        close(a, b, rtol=0, atol=0)


def test_reset_opacity_matches():
    params, alive, _, _ = density_inputs()
    jscene = jgs.GaussianScene(params={k: jnp.asarray(v) for k, v in params.items()},
                               aux={"alive": jnp.asarray(alive)},
                               cfg=jgs.SceneConfig(capacity=64, num_frames=2, traj="static"))
    js, _ = jden.reset_opacity(jscene, jopt.make_optimizer(jopt.OptimConfig()).init(jscene.params))
    tscene = tgs.GaussianScene(params={k: torch.from_numpy(v) for k, v in params.items()},
                               aux={"alive": torch.from_numpy(alive)},
                               cfg=tgs.SceneConfig(capacity=64, num_frames=2, traj="static"))
    ts, _ = tden.reset_opacity(tscene, topt.adam_init(tscene.params))
    close(ts.params["opacity"], js.params["opacity"])


# ---- scene creation ---------------------------------------------------------------


@pytest.mark.parametrize("traj", ["poly_fourier", "cubic_spline", "static"])
def test_create_scene_matches(traj):
    rng = np.random.RandomState(12)
    n, cap, T = 90, 128, 10
    pos = tinit.positive_z_random(n, rng=np.random.RandomState(3))
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    track = (pos[None] + 0.02 * rng.randn(T, n, 3)).astype(np.float32)
    track[0] = pos
    kw = dict(capacity=cap, num_frames=T, traj=traj, render_attributes=(("mask_attribute", 1),))
    js = jgs.create_scene(jgs.SceneConfig(**kw), pos, colors, init_opacity=0.1,
                          track_seq=track if traj == "cubic_spline" else None)
    ts = tgs.create_scene(tgs.SceneConfig(**kw), pos, colors, init_opacity=0.1,
                          track_seq=track if traj == "cubic_spline" else None, device="cpu")
    assert sorted(ts.params) == sorted(js.params) and sorted(ts.aux) == sorted(js.aux)
    for k in js.params:
        close(ts.params[k], js.params[k], msg=k)
    for k in js.aux:
        close(ts.aux[k], js.aux[k], rtol=0, atol=0, msg=k)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)


def test_create_scene_draws_colours_and_lbs_logits_from_the_generator():
    pos = tinit.positive_z_random(20)
    cfg = tgs.SceneConfig(capacity=32, num_frames=4, traj="lbs", num_bones=4)
    a = tgs.create_scene(cfg, pos, generator=torch.Generator().manual_seed(1), device="cpu")
    b = tgs.create_scene(cfg, pos, generator=torch.Generator().manual_seed(1), device="cpu")
    rgb = a.params["features_dc"][:20, 0] * 0.28209479177387814 + 0.5
    assert bool(((rgb >= 0.25 - 1e-6) & (rgb <= 0.75 + 1e-6)).all())
    assert torch.equal(a.params["pos_lbs_logits"], b.params["pos_lbs_logits"])
    assert a.params["pos_lbs_logits"].abs().max() > 0 and int(a.num_alive) == 20


def test_depth_to_points_matches():
    from splatter_a_video_tpu.models import init_points as jinit
    rng = np.random.RandomState(13)
    depth = rng.uniform(0.5, 2, (12, 16)).astype(np.float32)
    img = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (12, 16)) > 0.3
    for a, b in zip(tinit.depth_to_points(depth, img, mask, stride=3, noise=0.01),
                    jinit.depth_to_points(depth, img, mask, stride=3, noise=0.01)):
        np.testing.assert_array_equal(a, b)
