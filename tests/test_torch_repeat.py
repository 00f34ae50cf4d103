"""The port's fit repeats bit for bit (ROADMAP C.2), and its kNN picks
the same neighbours on the card as on the CPU.

On the card it did not: ARAP's samples inverted a `torch.cumsum` of float
probabilities, and on CUDA that scan adds in an order that changes from
run to run, so a draw near a bin edge could pick another index. The
draws now invert `prng.prefix_sums`, formed exactly in int64 fixed point:
the same bits in every run and on every device, and on the CPU the same
bits as the float cumsum they replace. The card's own repeat is held by
`chip_smoke.py` (`[repeat]`); here two CPU fits are held to each other.

ARAP's and the smoothness loss's kNN rank distances whose 3-term dot a
GEMM rounds one way on the CPU and another on the card (`chip_smoke.py`
phase 22 found 3 of 512 samples with other neighbours), and whose equal
values `torch.topk` orders one way on the CPU and another on the card.
The ranking now uses `knn.sq_dists_fma`, the CPU GEMM's bits formed on
any device, and `knn.smallest_k`, one order of equal values on every
device; the chosen distances are formed again with their gradient.
"""

import math

import numpy as np
import pytest
import torch

from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.ops import knn as tknn
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import hooks as thooks
from splatter_a_video_tpu_torch.train import losses as tl
from splatter_a_video_tpu_torch.train import prng as tprng
from test_torch_fit import one_thread, port_cfgs, states_equal  # noqa: F401  (module fixture: one CPU thread)

REPEAT_STEPS, EVENT, RESET = 7, 4, 5


def clone_state(st):
    """A copy of a TrainState that no later step can write into."""
    cl = lambda d: {k: v.clone() for k, v in d.items()}
    scene = type(st.scene)(params=cl(st.scene.params), aux=cl(st.scene.aux), cfg=st.scene.cfg)
    opt = st.opt_state._replace(mu=cl(st.opt_state.mu), nu=cl(st.opt_state.nu))
    dens = type(st.densify_state)(*(x.clone() for x in st.densify_state))
    return st._replace(scene=scene, opt_state=opt, densify_state=dens, key=st.key.clone())


class Snapshots(thooks.Hook):
    """Clones of the state at each density event (the hook's cadence puts
    an after_train_iter site there) and at the end."""

    every = EVENT

    def before_train(self, ctx):
        self.at = {}

    def after_train_iter(self, ctx):
        self.at[ctx.step] = clone_state(ctx.state)

    def after_train(self, ctx):
        self.at["end"] = clone_state(ctx.state)


def test_fit_repeats_bit_for_bit():
    """Two fits of one clip with one seed, across a density event (step 4)
    and an opacity reset (step 5), with ARAP's draws every step: every
    parameter, Adam moment, statistic and key `torch.equal` at the event
    and at the end."""
    clip = tsyn.make_clip(tsyn.SyntheticClipConfig())
    densify = tden.DensifyConfig(densify_start_iter=2, duplicate_interval=EVENT, opacity_reset_interval=EVENT,
                                 densify_grad_threshold=2e-5)
    runs = []
    for _ in range(2):
        snaps = Snapshots()
        state, hist = tfit.fit_clip(clip, *port_cfgs(REPEAT_STEPS, log_every=REPEAT_STEPS, densify=densify),
                                    hooks=[snaps], device="cpu")
        assert [e["step"] for e in hist[-1]["densify_events"]] == [EVENT]
        runs.append((state, snaps.at))
    (end_a, at_a), (end_b, at_b) = runs
    assert at_a.keys() == at_b.keys() and EVENT in at_a and "end" in at_a
    for k in at_a:
        states_equal(at_a[k], at_b[k])
    states_equal(end_a, end_b)
    assert end_a.step == REPEAT_STEPS > RESET


@pytest.mark.parametrize("n,alive", [(300, 217), (1000, 1000), (131072, 100000)])
def test_prefix_sums_are_exact(n, alive):
    """`prng.prefix_sums` of p = alive / count: the float32 rounding of the
    exact prefix sums (here `math.fsum`, then float32), which no order of
    float additions changes; on the CPU, the bits of `torch.cumsum` (which
    accumulates a float32 scan in float64 there)."""
    mask = np.zeros(n, bool)
    mask[np.random.RandomState(n).permutation(n)[:alive]] = True
    p = (mask / mask.sum()).astype(np.float32)
    got = tprng.prefix_sums(torch.from_numpy(p)).numpy()
    pos = np.flatnonzero(mask)[:: max(alive // 300, 1)]   # a few hundred prefixes, checked exactly
    want = np.array([math.fsum(p[: i + 1].astype(np.float64)) for i in pos], np.float64).astype(np.float32)
    assert np.array_equal(got[pos], want)
    assert np.array_equal(got, torch.cumsum(torch.from_numpy(p), 0).numpy())


def grid_and_random_points(seed):
    gx, gy = np.meshgrid(np.linspace(-0.9, 0.9, 40), np.linspace(-0.8, 0.8, 30), indexing="ij")
    grid = np.concatenate([np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], 1) for z in (1.0, 1.3)])
    rng = np.random.RandomState(seed)
    rand = np.concatenate([rng.uniform(-1, 1, (3000, 2)), rng.uniform(0.5, 2.0, (3000, 1))], 1)
    return torch.from_numpy(np.concatenate([grid, rand]).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_sq_dists_fma_has_the_cpu_gemm_bits(seed):
    pts = grid_and_random_points(seed)
    q = pts[torch.from_numpy(np.random.RandomState(seed + 10).randint(0, len(pts), 300))]
    assert torch.equal(tknn.sq_dists_fma(q[:, None], pts[None]), tknn._pairwise_sq_dists(q, pts))


def test_arap_connectivity_matches_the_gemm_ranking():
    """The neighbours, weights and cut edges of the GEMM's distances with
    topk's values carrying the gradient (the formulation before the
    no-grad ranking), and the gradient of a weighting of w: equal
    neighbours and masks on random points (where no two candidate
    distances are equal; ties are `smallest_k`'s), weights and gradient
    within rounding."""
    pts = grid_and_random_points(2)[2400:]   # the random points alone
    alive = torch.from_numpy(np.random.RandomState(3).rand(len(pts)) > 0.2)
    qidx = torch.from_numpy(np.random.RandomState(4).randint(0, len(pts), 200))
    wts = torch.from_numpy(np.random.RandomState(5).rand(200, 5).astype(np.float32))

    def gemm_connectivity(p):
        d2 = torch.where(alive[None, :], tknn._pairwise_sq_dists(p[qidx], p), float("inf"))
        neg, idx = torch.topk(-d2, 6, dim=1)
        nn_d = -neg[:, 1:]
        valid = torch.where(torch.arange(5)[None, :] >= 3, nn_d < 0.1**2, True)
        nn_d = torch.where(torch.isfinite(nn_d), nn_d, 0.0)
        w = torch.where(valid, torch.exp(-nn_d / torch.clamp_min(torch.mean(nn_d), 1e-12)), 0.0)
        return idx[:, 1:], w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12), valid

    a, b = pts.clone().requires_grad_(True), pts.clone().requires_grad_(True)
    ia, wa, va = tl.arap_connectivity(a, k=5, query_idx=qidx, alive=alive)
    ib, wb, vb = gemm_connectivity(b)
    assert torch.equal(ia, ib) and torch.equal(va, vb)
    np.testing.assert_allclose(wa.detach().numpy(), wb.detach().numpy(), rtol=1e-6, atol=1e-7)
    (wa * wts).sum().backward()
    (wb * wts).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-3, atol=3e-4)


@pytest.mark.parametrize("seed,N,k", [(0, 37, 6), (1, 200, 11), (2, 5, 3), (3, 64, 64), (4, 1000, 6)])
def test_smallest_k_orders_ties_by_descending_index(seed, N, k):
    """Small-integer distances with many ties and dead slots (+inf): the k
    smallest by value, equal values by descending index, as a sort of
    (value, -index) orders them; the values are those `torch.topk` keeps."""
    rng = np.random.RandomState(seed)
    d2 = torch.from_numpy(rng.randint(0, 5, (7, N)).astype(np.float32))
    d2[torch.from_numpy(rng.rand(7, N) < 0.3)] = float("inf")
    got = tknn.smallest_k(d2, k)
    want = torch.tensor([sorted(range(N), key=lambda c: (d2[r, c].item(), -c))[:k] for r in range(7)])
    assert torch.equal(got, want)
    assert torch.equal(torch.gather(d2, 1, got), -torch.topk(-d2, k, dim=1).values)
