"""The operation and byte counts against hand counts at small shapes, and
the reference blend's slot-pixel tests against a hand-counted tile."""

import torch

from port_bench.counts import blend, peaks, step, tapir
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


TINY_TAPIR = dict(channels_per_group=[2, 4, 4, 4], blocks_per_group=[1, 1, 1, 1], strides=[1, 2, 2, 1],
                  initial_resolution=[16, 16], highres_dim=4, lowres_dim=4, extra_convs=1, mixer_hidden_dim=2,
                  num_mixer_blocks=1, num_pips_iter=1, pyramid_level=1)


def test_tapir_layers_by_hand():
    # a 3x3 convolution from 2 to 4 channels onto 5x6: 30 outputs x 4 x 2 x 9 multiply-adds
    assert tapir.conv(3, 2, 4, 5, 6) == 2 * 30 * 4 * 2 * 9
    assert tapir.linear(3, 5) == 30
    # a depthwise kernel of 3 taps onto 8 channels: 24 multiply-adds a position
    assert tapir.depthwise(3, 8) == 48
    assert tapir.grid_sizes(TINY_TAPIR) == ((4, 4), (2, 2))


def test_tapir_grid_ops_by_hand():
    """16x16 in: the 7x7 stem to 8x8 x 2; one block a group (a 1x1 projection,
    then two 3x3s) at 8x8, 4x4, 2x2, 2x2; one ExtraConv 4 -> 16 -> 4 at 2x2."""
    stem = 2 * 64 * 2 * 3 * 49
    g0 = 2 * 64 * (2 * 2 + 9 * 2 * 2 + 9 * 2 * 2)
    g1 = 2 * 16 * (2 * 4 + 9 * 2 * 4 + 9 * 4 * 4)
    g2 = 2 * 4 * (4 * 4 + 9 * 4 * 4 + 9 * 4 * 4)
    g3 = 2 * 4 * (4 * 4 + 9 * 4 * 4 + 9 * 4 * 4)
    extra = 2 * 4 * (9 * 4 * 16 + 9 * 16 * 4)
    assert tapir.grid_ops(TINY_TAPIR, 3) == 3 * (stem + g0 + g1 + g2 + g3 + extra)


def test_tapir_query_ops_by_hand():
    """A query's frame: the cost volume over the 2x2 low-res grid, the head's
    three convolutions and two linears; one iteration: 49 samples and
    correlations at three levels of 4 channels, a mixer of width 2 over
    12 + 147 inputs, one block."""
    init = 2 * 4 * 4 + 2 * 4 * 9 * 16 + 2 * 4 * 9 * 16 + 2 * 1 * 9 * 16 * 32 + 2 * 32 * 16 + 2 * 16 * 2
    sample = 3 * 49 * 10 * 4
    block = 2 * 3 * 8 * 2 + 8 + 2 * 2 * 8 * 2
    mix = 2 * (12 + 147) * 2 + block + 2 * 2 * 12
    assert tapir.query_ops(TINY_TAPIR, 5) == 5 * (init + sample + mix)
