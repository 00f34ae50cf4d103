"""The operation and byte counts against hand counts at small shapes, and
the reference blend's slot-pixel tests against a hand-counted tile."""

import torch

from port_bench.counts import blend, peaks, step
from port_bench.reference import plain


def test_k1_counts_by_hand():
    # tests 10 x 15 + applied 4 x 2C; bytes: slots 4 x 3, edges 4 x 3, two records of
    # 24 + 4C, the bg 4C, five pixels of C + 2 floats
    assert blend.k1(10, 4, 3, 2, 2, 5, 3) == (10 * 15 + 4 * 6, 12 + 12 + 2 * 36 + 12 + 5 * 5 * 4)


def test_k3_counts_by_hand():
    C, R = 3, 11
    ops, nbytes = blend.k3(10, 4, 3, 2, 2, 5, C)
    assert ops == 10 * 15 + 4 * (40 + 5 * C + R)
    assert nbytes == 12 + 12 + 2 * 36 + 8 * C + 5 * (2 * C + 1) * 4 + 3 * R * 4


def test_k4_and_least_time():
    assert blend.k4(100, 7) == 1500
    assert blend.least_s(peaks.FP32_FLOPS_PER_S, 0) == 1.0
    assert blend.least_s(0, peaks.HBM_BYTES_PER_S * 2) == 2.0


def test_step_ops_adds_its_parts():
    base = step.step_ops(0, 0, 0, 7, 0, 0, 0, 0)
    assert base == 0
    # one pixel: SSIM's 8 blurs of 2 passes of 11 multiply-adds and 60 map
    # operations, a channel each of 3; 30 loss operations a channel of 7
    assert step.step_ops(0, 0, 0, 7, 1, 0, 0, 0) == 3 * (8 * 2 * 11 * 2 + 60) + 7 * 30
    assert step.step_ops(0, 0, 0, 7, 0, 10, 0, 0) == 12000
    assert step.step_ops(0, 0, 0, 7, 0, 10, 0, 4) == 12000 + 400
    assert step.step_ops(0, 0, 0, 7, 0, 0, 5, 0) == 60


def test_walked_tests_of_a_tile_that_stops_early():
    """Six equal Gaussians over one 16 x 16 tile, alpha ~0.95 at every pixel:
    the transmittance goes 0.05, 0.0025, 1.25e-4, then would fall under
    1e-4, so every pixel applies three and stops at the fourth: the tile
    walks 4 slots, 4 x 256 tests and 3 x 256 applied pairs."""
    n = 6
    uv = torch.full((n, 2), 7.5)
    conic = torch.tensor([[1e-6, 0.0, 1e-6]]).repeat(n, 1)
    op = torch.full((n,), 0.95)
    feats = torch.rand(n, 3)
    bins = plain.Bins(torch.arange(n), torch.tensor([0]), torch.tensor([n]), n, 1, 1)
    stats = {"tests": 0, "applied": 0}
    img = plain.blend(bins, uv, conic, op, feats, torch.ones(3), torch.ones(3, dtype=torch.bool), 16, 16, 16,
                      stats=stats)
    assert stats == {"tests": 4 * 256, "applied": 3 * 256}
    a = 0.95 * torch.exp(torch.tensor(-0.5 * 1e-6 * (0.5 ** 2 * 2)))
    T = 1.0
    want = torch.zeros(3)
    for k in range(3):
        want += feats[k] * a * T
        T = T * (1 - a)
    torch.testing.assert_close(img[8, 8], want + T, rtol=1e-5, atol=1e-6)
