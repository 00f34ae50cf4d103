"""Port parity for the loss library and the helper functions that nothing
on the main path calls (ROADMAP A.19): each gets the same seeded numpy
inputs through its JAX function (on the CPU) and its port counterpart.

Tolerances: values rtol 1e-5 / atol 1e-6; gradients rtol 2e-3 / atol
3e-4 (the repo's gradient bars); integers, sampled indices and
`num_sh_bases` exactly; the numpy cameras and normals atol 1e-6. The
first-K ids come from K1 at 64x48 (JAX's Pallas kernel in interpret mode,
the port's plain version), equal in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.data import video_flow as jvf
from splatter_a_video_tpu.models import camera as jcam
from splatter_a_video_tpu.ops import quaternion as jquat
from splatter_a_video_tpu.ops import rasterize_tpu as jtpu
from splatter_a_video_tpu.ops import sh as jsh
from splatter_a_video_tpu.train import losses as jl
from splatter_a_video_tpu_torch.data import video_flow as tvf
from splatter_a_video_tpu_torch.models import camera as tcam
from splatter_a_video_tpu_torch.ops import quaternion as tquat
from splatter_a_video_tpu_torch.ops import sh as tsh
from splatter_a_video_tpu_torch.train import losses as tl
from splatter_a_video_tpu_torch.train import prng as tprng
from test_torch_rasterize import H as K1_H
from test_torch_rasterize import W as K1_W
from test_torch_rasterize import port_splat, scene

RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 2e-3, 3e-4
NP_ATOL = 1e-6


def close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def check(jfn, tfn, arrays, argnums=()):
    """Hold tfn(*arrays) to jfn(*arrays) in value and, for `argnums`, in
    gradient; returns the port's gradients."""
    jargs = [jnp.asarray(a) for a in arrays]
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in argnums:
        ts[i].requires_grad_(True)
    tv = tfn(*ts)
    if not argnums:
        close(tv, jfn(*jargs))
        return ()
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(*jargs)
    tg = torch.autograd.grad(tv, [ts[i] for i in argnums], allow_unused=True)
    tg = [torch.zeros_like(ts[i]) if g is None else g for i, g in zip(argnums, tg)]   # unused: JAX's zeros
    close(tv, jv)
    for i, a, b in zip(argnums, tg, jg):
        close(a, b, rtol=G_RTOL, atol=G_ATOL, msg=f"gradient of argument {i}")
    return tg


def rows(seed, B=64, D=3, zeros=0):
    """pred, gt [B, D] uniform in [0, 1); the first `zeros` rows of pred
    equal gt's (|err| = 0 exactly: JAX's |x| subgradient +1 there)."""
    rng = np.random.RandomState(seed)
    p, g = (rng.rand(B, D).astype(np.float32) for _ in range(2))
    p[:zeros] = g[:zeros]
    return p, g


# ---- photometric and trimmed criteria -----------------------------------------


def test_l2_loss():
    check(jl.l2_loss, tl.l2_loss, rows(0), (0, 1))


@pytest.mark.parametrize("quantile", [0.9, 0.5, 1.0])
@pytest.mark.parametrize("zeros", [0, 5])
def test_trimmed_l1_loss(quantile, zeros):
    check(lambda p, g: jl.trimmed_l1_loss(p, g, quantile), lambda p, g: tl.trimmed_l1_loss(p, g, quantile),
          rows(1, zeros=zeros), (0, 1))


@pytest.mark.parametrize("quantile", [0.9, 0.3])
def test_trim_mask(quantile):
    err = np.random.RandomState(2).rand(50).astype(np.float32)
    check(lambda e: jl._trim_mask(e, quantile), lambda e: tl._trim_mask(e, quantile), [err])


def test_trim_boundary_row():
    """With the quantile exactly on a row (q = 7 / (B - 1)), `trimmed_l1_loss`
    keeps that row (err <= q) and `_trim_mask` drops it (err < q)."""
    B, k = 15, 7
    err = np.random.RandomState(3).permutation(np.arange(1, B + 1)).astype(np.float32) / 16.0
    q = k / (B - 1)
    kept = tl._trim_mask(torch.from_numpy(err), q)
    assert int(kept.sum()) == k == int(np.asarray(jl._trim_mask(jnp.asarray(err), q)).sum())
    pred = err[:, None] * np.ones((1, 2), np.float32)
    gt = np.zeros_like(pred)
    check(lambda p, g: jl.trimmed_l1_loss(p, g, q), lambda p, g: tl.trimmed_l1_loss(p, g, q), [pred, gt], (0,))
    expected = np.sort(err)[:k + 1].mean()   # the boundary row is in
    close(tl.trimmed_l1_loss(torch.from_numpy(pred), torch.from_numpy(gt), q), expected)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("quantile", [0.9, 0.6])
def test_trimmed_mse_loss(with_mask, quantile):
    p, g = rows(4)
    arrays = [p, g] + ([np.random.RandomState(5).rand(len(p)).astype(np.float32)] if with_mask else [])
    check(lambda p, g, *m: jl.trimmed_mse_loss(p, g, m[0] if m else None, quantile),
          lambda p, g, *m: tl.trimmed_mse_loss(p, g, m[0] if m else None, quantile), arrays, (0, 1))


@pytest.mark.parametrize("name", ["trimmed_std_normed_l1_loss", "trimmed_var_normed_mse_loss"])
@pytest.mark.parametrize("B,zeros", [(64, 0), (64, 4), (2, 0)])
def test_trimmed_normed_losses(name, B, zeros):
    """B = 2 keeps one row: the std / var divide by max(n - 1, 1) = 1."""
    p, g = rows(6, B=B, zeros=zeros)
    p = p * 2.0 + 0.1   # the columns of pred and gt spread differently
    check(getattr(jl, name), getattr(tl, name), [p, g], (0, 1) if B > 2 else ())


# ---- depth range, distortion, flow smoothness, normalisation --------------------


def test_depth_range_loss():
    d = np.random.RandomState(7).rand(100).astype(np.float32) * 4.0 - 1.0
    for lo, hi in ((0.0, 2.0), (-0.5, 1.0)):
        check(lambda x: jl.depth_range_loss(x, lo, hi), lambda x: tl.depth_range_loss(x, lo, hi), [d], (0,))
    assert float(tl.depth_range_loss(torch.ones(10), 0.0, 2.0)) == 0.0


def test_distortion_loss():
    """ut's |diagonal| is exactly 0 (JAX's |x| subgradient)."""
    rng = np.random.RandomState(8)
    t = np.sort(rng.rand(4, 9).astype(np.float32), axis=-1)
    w = rng.rand(4, 8).astype(np.float32)
    check(jl.distortion_loss, tl.distortion_loss, [t, w], (0, 1))


def test_flow_smoothness_loss():
    rng = np.random.RandomState(9)
    flow = rng.rand(8, 9, 2).astype(np.float32)
    alpha = rng.rand(8, 9, 1).astype(np.float32)
    check(jl.flow_smoothness_loss, tl.flow_smoothness_loss, [flow, alpha], (0, 1))


def test_flow_smoothness_zero_edges_keep_torch_gradient():
    """A constant flow: both values are 0. JAX's `jnp.linalg.norm` has a NaN
    gradient at a zero difference; the port keeps `torch.linalg.norm`'s 0
    (the reference `criterion.py`'s torch semantics)."""
    flow = np.ones((8, 9, 2), np.float32)
    flow[3:, 4:] = 2.0   # some edges move, most do not
    alpha = np.ones((8, 9, 1), np.float32)
    check(jl.flow_smoothness_loss, tl.flow_smoothness_loss, [flow, alpha])
    const = np.ones((8, 9, 2), np.float32)
    assert float(tl.flow_smoothness_loss(torch.from_numpy(const), torch.from_numpy(alpha))) == 0.0
    jg = jax.grad(jl.flow_smoothness_loss)(jnp.asarray(flow), jnp.asarray(alpha))
    assert np.isnan(np.asarray(jg)).any()
    f = torch.from_numpy(flow).requires_grad_(True)
    tl.flow_smoothness_loss(f, torch.from_numpy(alpha)).backward()
    assert torch.isfinite(f.grad).all()


@pytest.mark.parametrize("ties", [False, True])
def test_normalize_minus_one_to_one(ties):
    """Ties at the min and the max share their gradient in both packages."""
    x = np.random.RandomState(10).rand(20).astype(np.float32)
    if ties:
        x[[3, 7]] = x.min()
        x[[5, 11]] = x.max()
    weights = np.random.RandomState(11).rand(20).astype(np.float32)
    check(lambda v: jnp.sum(jl.normalize_minus_one_to_one(v) * weights),
          lambda v: torch.sum(tl.normalize_minus_one_to_one(v) * torch.from_numpy(weights)), [x], (0,))


# ---- masked and robust criteria -------------------------------------------------


def mask_arrays(seed, with_mask, last=1):
    p, g = rows(seed, B=40, D=3, zeros=3)
    return [p, g] + ([np.random.RandomState(seed + 1).rand(40, last).astype(np.float32)] if with_mask else [])


@pytest.mark.parametrize("with_mask,normalize", [(False, True), (True, True), (True, False)])
def test_masked_mse_loss(with_mask, normalize):
    check(lambda p, g, *m: jl.masked_mse_loss(p, g, m[0] if m else None, normalize),
          lambda p, g, *m: tl.masked_mse_loss(p, g, m[0] if m else None, normalize),
          mask_arrays(12, with_mask), (0, 1))


@pytest.mark.parametrize("with_mask,normalize", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("delta", [0.3, 1.0])
def test_masked_huber_loss(with_mask, normalize, delta):
    check(lambda p, g, *m: jl.masked_huber_loss(p, g, delta, m[0] if m else None, normalize),
          lambda p, g, *m: tl.masked_huber_loss(p, g, delta, m[0] if m else None, normalize),
          mask_arrays(13, with_mask, last=3), (0, 1))


@pytest.mark.parametrize("with_mask,normalize", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("c", [1.0, 0.25])
def test_cauchy_loss(with_mask, normalize, c):
    check(lambda p, g, *m: jl.cauchy_loss(p, g, c, m[0] if m else None, normalize),
          lambda p, g, *m: tl.cauchy_loss(p, g, c, m[0] if m else None, normalize),
          mask_arrays(14, with_mask), (0, 1))


# ---- depth losses ---------------------------------------------------------------


@pytest.mark.parametrize("seed,patch,num", [(0, 8, 16), (1, 5, 40)])
def test_depth_correlation_loss(seed, patch, num):
    """Patch corners from JAX's key (split, then randint) in both; the
    std is the population one (`jnp.std`, ddof 0)."""
    rng = np.random.RandomState(20 + seed)
    gt = rng.rand(24, 32).astype(np.float32)
    rd = (gt * 0.7 + rng.rand(24, 32) * 0.3).astype(np.float32)
    jkey, tkey = jax.random.PRNGKey(seed), tprng.key(seed)
    check(lambda a, b: jl.depth_correlation_loss(a, b, patch, num, jkey),
          lambda a, b: tl.depth_correlation_loss(a, b, patch, num, tkey), [gt, rd], (0, 1))
    ki, kj = jax.random.split(jkey)
    tki, tkj = tprng.split(tkey)
    assert np.array_equal(tprng.randint(tki, (num,), 0, 24 - patch).numpy(),
                          np.asarray(jax.random.randint(ki, (num,), 0, 24 - patch)))
    assert np.array_equal(tprng.randint(tkj, (num,), 0, 32 - patch).numpy(),
                          np.asarray(jax.random.randint(kj, (num,), 0, 32 - patch)))


@pytest.mark.parametrize("with_mask", [False, True])
def test_scale_shift_invariant_depth_loss(with_mask):
    rng = np.random.RandomState(21)
    d = rng.rand(24, 32).astype(np.float32)
    g = (2.5 * d - 1.0 + rng.randn(24, 32) * 0.05).astype(np.float32)
    arrays = [d, g] + ([(rng.rand(24, 32) > 0.3).astype(np.float32)] if with_mask else [])
    check(lambda p, q, *m: jl.scale_shift_invariant_depth_loss(p, q, m[0] if m else None),
          lambda p, q, *m: tl.scale_shift_invariant_depth_loss(p, q, m[0] if m else None), arrays, (0, 1))


def test_scale_shift_invariant_singular_system():
    """A constant prediction: det = 0, scale 1 and shift 0 in both."""
    d = np.full((6, 7), 0.5, np.float32)
    g = np.random.RandomState(22).rand(6, 7).astype(np.float32)
    check(jl.scale_shift_invariant_depth_loss, tl.scale_shift_invariant_depth_loss, [d, g])


# ---- feature smoothness -----------------------------------------------------------


@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("with_positions", [False, True])
def test_smoothness_loss(with_alive, with_positions):
    """Samples from the same key (`randint`, or `choice` over the alive
    slots), the same kNN, value and gradient."""
    rng = np.random.RandomState(23)
    N = 300
    feats = rng.rand(N, 3).astype(np.float32) * 10
    pos = rng.rand(N, 3).astype(np.float32)
    alive = rng.rand(N) > 0.3
    arrays = [feats] + ([pos] if with_positions else []) + ([alive] if with_alive else [])
    jkey, tkey = jax.random.PRNGKey(4), tprng.key(4)

    def call(mod, key):
        def fn(f, *rest):
            rest = list(rest)
            p = rest.pop(0) if with_positions else None
            a = rest.pop(0) if with_alive else None
            return mod.smoothness_loss(f, key, positions=p, k=10, sample_num=64, alive=a)
        return fn

    grads = check(call(jl, jkey), call(tl, tkey), arrays, (0,))
    assert torch.isfinite(grads[0]).all()
    if with_alive:
        p = alive.astype(np.float32) / alive.sum()
        jidx = jax.random.choice(jkey, N, (64,), replace=True, p=jnp.asarray(p))
    else:
        jidx = jax.random.randint(jkey, (64,), 0, N)
    tidx = tl.arap_sample(N, 64, torch.from_numpy(alive) if with_alive else None, tkey)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    if with_alive:
        assert alive[tidx.numpy()].all()


def test_smoothness_loss_zero_for_constant_features():
    pos = np.random.RandomState(24).rand(300, 3).astype(np.float32)
    const = np.ones((300, 3), np.float32)
    check(lambda f, p: jl.smoothness_loss(f, jax.random.PRNGKey(0), positions=p),
          lambda f, p: tl.smoothness_loss(f, tprng.key(0), positions=p), [const, pos], (0,))
    assert float(tl.smoothness_loss(torch.from_numpy(const), tprng.key(0), torch.from_numpy(pos))) == 0.0


# ---- first-K entropy and blending ---------------------------------------------------


def random_gs_idx(seed, N=30, shape=(5, 6, 4)):
    """First-K ids with -1 (no contributor) in the trailing slots."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, N, shape).astype(np.int32)
    count = rng.randint(0, shape[-1] + 1, shape[:-1])
    idx[np.arange(shape[-1]) >= count[..., None]] = -1
    return idx


@pytest.fixture(scope="module")
def k1_gs_idx():
    """First-10 ids of a 64x48 blend: JAX's Pallas kernel (interpret mode)
    and the port's plain K1, equal."""
    s = scene(5)
    j = jtpu.splat_scene(
        jnp.asarray(s["uv"]), jnp.asarray(s["conic"]), jnp.asarray(s["opacity"]),
        jnp.asarray(s["feats"]), jnp.zeros((len(s["uv"]), 2)), jnp.asarray(s["depth"]),
        jnp.asarray(s["tiles"]), jnp.asarray(s["rmin"]), jnp.asarray(s["rmax"]),
        C=3, W=K1_W, H=K1_H, bg=(1.0, 1.0, 1.0), K_idx=10, max_intersections=1 << 14, sort_mode="exact",
    )
    out = port_splat(s, (1.0, 1.0, 1.0), K_idx=10)
    ids = np.asarray(j[3])
    assert np.array_equal(out[3].numpy(), ids)
    assert (ids == -1).any() and (ids >= 0).any()
    return ids, s["opacity"], s["feats"]


@pytest.mark.parametrize("source", ["random", "K1"])
def test_entropy_loss(source, k1_gs_idx):
    if source == "K1":
        idx, op, _ = k1_gs_idx
        idx = idx.copy()
    else:
        idx = random_gs_idx(30)
        op = np.random.RandomState(31).uniform(0.05, 0.95, 30).astype(np.float32)
    check(lambda o: jl.entropy_loss(o, jnp.asarray(idx)), lambda o: tl.entropy_loss(o, torch.from_numpy(idx)),
          [op], (0,))


@pytest.mark.parametrize("source,bg", [("random", 1.0), ("random", 0.25), ("K1", 1.0)])
def test_alpha_blending_firstK(source, bg, k1_gs_idx):
    if source == "K1":
        idx, _, attr = k1_gs_idx
        idx = idx.copy()
    else:
        idx = random_gs_idx(32)
        attr = np.random.RandomState(33).rand(30, 5).astype(np.float32)
    wts = np.random.RandomState(34).rand(*idx.shape).astype(np.float32)
    weights = np.random.RandomState(35).rand(*idx.shape[:-1], attr.shape[1]).astype(np.float32)
    check(lambda a, w: jnp.sum(jl.alpha_blending_firstK(a, jnp.asarray(idx), w, bg) * weights),
          lambda a, w: torch.sum(tl.alpha_blending_firstK(a, torch.from_numpy(idx), w, bg)
                                 * torch.from_numpy(weights)),
          [attr, wts], (0, 1))
    out = tl.alpha_blending_firstK(torch.from_numpy(attr), torch.from_numpy(idx), torch.from_numpy(wts), bg)
    close(out, jl.alpha_blending_firstK(jnp.asarray(attr), jnp.asarray(idx), jnp.asarray(wts), bg))


# ---- weight ramp and GAN losses -------------------------------------------------------


@pytest.mark.parametrize("step", [0, 40, 50, 500, 99999])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_weight_scheduler(step, as_tensor):
    j = jl.weight_scheduler(jnp.asarray(step) if as_tensor else step, 40, 1 / 100, 0.0, 10.0)
    t = tl.weight_scheduler(torch.tensor(step) if as_tensor else step, 40, 1 / 100, 0.0, 10.0)
    assert t.dtype == torch.float32
    close(t, j)


@pytest.mark.parametrize("mode", ["original", "ls", "hinge", "w"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("disc", [True, False])
def test_gan_loss(mode, real, disc):
    x = np.random.RandomState(40).randn(4, 7).astype(np.float32)
    x[0, :3] = 0.0   # |x| and the max / min ties at 0
    x[1, :2] = 1.0 if real else -1.0   # the hinge's kink
    if mode == "hinge" and not disc and not real:
        with pytest.raises(AssertionError):
            tl.gan_loss(torch.from_numpy(x), real, mode, disc)
        with pytest.raises(AssertionError):
            jl.gan_loss(jnp.asarray(x), real, mode, disc)
        return
    check(lambda v: jl.gan_loss(v, real, mode, disc), lambda v: tl.gan_loss(v, real, mode, disc), [x], (0,))


@pytest.mark.parametrize("mode", ["original", "ls", "hinge", "w"])
def test_gan_loss_multiscale(mode):
    """A list of scales, each a logits array or a list ending in one."""
    rng = np.random.RandomState(41)
    a, b, c = (rng.randn(3, 5).astype(np.float32) for _ in range(3))
    check(lambda x, y, z: jl.gan_loss([x, [y * 9.0, y], [z]], True, mode),
          lambda x, y, z: tl.gan_loss([x, [y * 9.0, y], [z]], True, mode), [a, b, c], (0, 1, 2))


# ---- SH, quaternions ----------------------------------------------------------------------


def test_num_sh_bases():
    assert [tsh.num_sh_bases(d) for d in range(5)] == [jsh.num_sh_bases(d) for d in range(5)] == [1, 4, 9, 16, 25]


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("with_visible", [False, True])
def test_eval_sh_free(deg, with_visible):
    """The raw basis: negative values stay, no +0.5 offset."""
    rng = np.random.RandomState(50 + deg)
    sh = rng.randn(40, 16, 3).astype(np.float32)
    dirs = rng.randn(40, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    vis = rng.rand(40) > 0.3
    weights = rng.rand(40, 3).astype(np.float32)
    arrays = [sh, dirs] + ([vis] if with_visible else [])
    check(lambda s, d, *v: jnp.sum(jsh.eval_sh_free(deg, s, d, v[0] if v else None) * weights),
          lambda s, d, *v: torch.sum(tsh.eval_sh_free(deg, s, d, v[0] if v else None) * torch.from_numpy(weights)),
          arrays, (0, 1))
    out = tsh.eval_sh_free(deg, torch.from_numpy(sh), torch.from_numpy(dirs))
    close(out, jsh.eval_sh_free(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    assert (out < 0).any()


def test_quat_multiply():
    rng = np.random.RandomState(60)
    a, b = (rng.randn(2, 7, 4).astype(np.float32) for _ in range(2))
    weights = rng.rand(2, 7, 4).astype(np.float32)
    check(lambda x, y: jnp.sum(jquat.quat_multiply(x, y) * weights),
          lambda x, y: torch.sum(tquat.quat_multiply(x, y) * torch.from_numpy(weights)), [a, b], (0, 1))
    close(tquat.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)), jquat.quat_multiply(a, b))


def test_cov6_to_mat():
    rng = np.random.RandomState(61)
    cov6 = rng.randn(3, 5, 6).astype(np.float32)
    weights = rng.rand(3, 5, 3, 3).astype(np.float32)
    check(lambda c: jnp.sum(jquat.cov6_to_mat(c) * weights),
          lambda c: torch.sum(tquat.cov6_to_mat(c) * torch.from_numpy(weights)), [cov6], (0,))
    m = tquat.cov6_to_mat(torch.from_numpy(cov6))
    assert torch.equal(m, m.transpose(-1, -2))
    close(m, jquat.cov6_to_mat(cov6))


# ---- numpy cameras ---------------------------------------------------------------------------


def cam_close(t, j):
    assert (t.width, t.height) == (j.width, j.height)
    assert (t.fovy is None) == (j.fovy is None)
    for name in ("R", "t", "fovx", "extrinsic", "intrinsic"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), atol=NP_ATOL, err_msg=name)
    if t.fovy is not None:
        np.testing.assert_allclose(t.fovy, j.fovy, atol=NP_ATOL)


@pytest.mark.parametrize("w,h,focal", [(64, 48, 50.0), (854, 480, 1000.0)])
def test_canonical_camera_from_focal(w, h, focal):
    cam_close(tcam.canonical_camera_from_focal(w, h, focal), jcam.canonical_camera_from_focal(w, h, focal))


@pytest.mark.parametrize("num,z_range", [(5, (-0.3, 0.0)), (1, (-0.3, 0.0)), (4, (0.1, -0.2))])
def test_dolly_path(num, z_range):
    base = jcam.canonical_camera_from_focal(64, 48, 50.0)
    tbase = tcam.canonical_camera_from_focal(64, 48, 50.0)
    tc, jc = tcam.dolly_path(tbase, num, z_range), jcam.dolly_path(base, num, z_range)
    assert len(tc) == len(jc) == num
    for t, j in zip(tc, jc):
        cam_close(t, j)


@pytest.mark.parametrize("with_fovy", [False, True])
@pytest.mark.parametrize("num,scale", [(5, (1.0, 0.7)), (1, (1.0, 0.7)), (3, (0.5, 1.5))])
def test_zoom_path(with_fovy, num, scale):
    """fovy None passes through as None."""
    tbase = tcam.canonical_camera_from_focal(64, 48, 50.0) if with_fovy else tcam.canonical_camera(64, 48)
    jbase = jcam.canonical_camera_from_focal(64, 48, 50.0) if with_fovy else jcam.canonical_camera(64, 48)
    tc, jc = tcam.zoom_path(tbase, num, scale), jcam.zoom_path(jbase, num, scale)
    assert len(tc) == len(jc) == num
    for t, j in zip(tc, jc):
        cam_close(t, j)
        assert (t.fovy is None) == (not with_fovy)


# ---- depth -> points -> normals --------------------------------------------------------------


def depth_camera(seed, h=12, w=16):
    rng = np.random.RandomState(seed)
    depth = (1.0 + rng.rand(h, w)).astype(np.float32)
    K = np.array([[20.0, 0.0, w / 2], [0.0, 22.0, h / 2], [0.0, 0.0, 1.0]], np.float32)
    ang = 0.3
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = [[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0], [-np.sin(ang), 0.0, np.cos(ang)]]
    E[:3, 3] = rng.randn(3)
    return depth, K, E


def test_depth_to_points_world():
    depth, K, E = depth_camera(70)
    pts = tvf.depth_to_points_world(depth, K, E)
    assert pts.shape == (depth.size, 3)
    np.testing.assert_allclose(pts, jvf.depth_to_points_world(depth, K, E), atol=NP_ATOL)


def test_points_to_normals():
    xyz = np.random.RandomState(71).rand(10, 13, 3).astype(np.float32)
    n = tvf.points_to_normals(xyz)
    np.testing.assert_allclose(n, jvf.points_to_normals(xyz), atol=NP_ATOL)
    assert (n[0] == 0).all() and (n[:, -1] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(n[1:-1, 1:-1], axis=-1), 1.0, atol=1e-5)


def test_normal_from_depth_image():
    depth, K, E = depth_camera(72)
    np.testing.assert_allclose(tvf.normal_from_depth_image(depth, K, E),
                               jvf.normal_from_depth_image(depth, K, E), atol=NP_ATOL)
