"""The tracks entry at a tiny size on the CPU: the plain reference against
the program's TAPIR, a whole run held to the committed limits, and the same
run with the timed path broken underneath, once for each fault a tracking
cell can have, which has to come out not correct. On the card: the TF32
control, put in the program's place at the cell's own size, is not correct
while the program's own run is."""

import time

import numpy as np
import pytest
import torch

from port_bench import manifest
from port_bench.entries import tracks
from port_bench.reference import tapir as ref
from port_bench.tests import tiny_tracks

SEED = 2 ** 31 + 4321           # past 32 signed bits, as a run's seed may be
NAME = "bootstapir_480p"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cfg=None):
    out = tracks.run(cfg or tiny_tracks.config(), tiny_tracks.TRAFFIC, manifest.limits(NAME), SEED, 0.2, False, "cpu",
                     time.perf_counter(), {})
    return {c["name"]: c for c in out["check"]}, out


def test_the_configuration_is_the_programs_default_model():
    from splatter_a_video_tpu_torch.nets import tapir

    m = manifest.config(NAME)["model"]
    want = tapir.TapirConfig()
    for k, v in m.items():
        assert (tuple(v) if isinstance(v, list) else v) == getattr(want, k), k


def test_the_reference_matches_the_program():
    """4 frames at 64x64, 8 queries on several frames, 2 mixer blocks, 1 ExtraConv."""
    from splatter_a_video_tpu_torch.nets import tapir

    cfg = tiny_tracks.config()
    m = cfg["model"]
    params = ref.draw_params(m, 7, "cpu")
    names = {n for n, _, _ in ref.param_shapes(m)}
    model = tracks.program_model(cfg, params, "cpu")
    assert names == set(model.params)
    g = torch.Generator().manual_seed(3)
    video = (torch.rand((4, 64, 64, 3), generator=g) * 255).to(torch.uint8)
    q = torch.cat([torch.randint(0, 4, (8, 1), generator=g).float(), torch.rand((8, 2), generator=g) * 63], 1)
    got = tapir.track_points(model, video.numpy(), q.numpy(), chunk=8)
    want = ref.run(m, params, video, q, block=4)
    for k in ("tracks", "occlusion", "expected_dist"):
        torch.testing.assert_close(torch.from_numpy(got[k]), want[k], rtol=1e-4, atol=1e-4)
    # the query frame's initial point is snapped, then refined: the answer moves
    assert float((want["tracks"] - q[:, None, [2, 1]]).abs().max()) > 0.1


def test_queries_follow_compute_tracks():
    cfg = manifest.config(NAME)
    q = tracks.make_queries(cfg)
    assert tracks.queries_per_frame(cfg) == 25680 and q.shape == (48 * 25680, 3) and q.dtype == np.float32
    np.testing.assert_array_equal(q[:3], np.float32([[0, 0, 0], [0, 0, 4 / 853 * 255], [0, 0, 8 / 853 * 255]]))
    np.testing.assert_allclose(q[25679], [0, 476 / 479 * 255, 852 / 853 * 255], rtol=1e-6)
    assert q[25680, 0] == 1 and q[-1, 0] == 47


def test_tiny_cell_is_correct():
    checks, out = _run()
    assert all(c["ok"] for c in checks.values()), checks
    assert set(checks) == set(tracks.LIMIT_KEYS)
    assert out["attempted"] % tiny_tracks.TRAFFIC["queries_per_call"] == 0
    assert out["metrics"]["preprocess_ms_per_frame"] > 0 and out["metrics"]["setup_s"] > 0


def test_a_pips_iteration_that_returns_its_state_unchanged_fails(monkeypatch):
    from splatter_a_video_tpu_torch.nets import tapir

    refine = tapir.refine_pips
    seen = {"n": 0}

    def stuck(cfg, p, queries, pyramid, points, occ, expd, last_iter):
        seen["n"] += 1
        out = refine(cfg, p, queries, pyramid, points, occ, expd, last_iter)
        if seen["n"] % cfg.num_pips_iter == 0:        # the last iteration
            return points, occ, expd, out[3]
        return out

    monkeypatch.setattr(tapir, "refine_pips", stuck)
    checks, _ = _run()
    assert not checks["tracks_gap_px"]["ok"]


def test_the_extra_convs_left_out_fails(monkeypatch):
    from splatter_a_video_tpu_torch.nets import tapir

    monkeypatch.setattr(tapir, "extra_convs_forward", lambda cfg, p, x: x)
    checks, _ = _run()
    assert not all(c["ok"] for c in checks.values())


def test_bfloat16_grids_fail(monkeypatch):
    from splatter_a_video_tpu_torch.nets import tapir

    grids = tapir.get_feature_grids
    monkeypatch.setattr(tapir, "get_feature_grids",
                        lambda cfg, p, video: tuple(g.to(torch.bfloat16).float() for g in grids(cfg, p, video)))
    checks, _ = _run()
    assert not all(c["ok"] for c in checks.values())


def test_half_of_each_chunk_left_out_fails(monkeypatch):
    """The second half of each chunk's queries given the first half's answers."""
    from splatter_a_video_tpu_torch.nets import tapir

    fwd = tapir.forward

    def half(cfg, p, video, query_points):
        n = query_points.shape[0] // 2
        out = fwd(cfg, p, video, query_points[:n])
        return {k: torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(tapir, "forward", half)
    checks, _ = _run()
    assert not checks["tracks_gap_px"]["ok"]


def test_an_answer_altered_where_made_fails(monkeypatch):
    """The occlusion logit loses the last iteration's update."""
    from splatter_a_video_tpu_torch.nets import tapir

    refine = tapir.refine_pips
    seen = {"n": 0}

    def altered(cfg, p, queries, pyramid, points, occ, expd, last_iter):
        seen["n"] += 1
        out = refine(cfg, p, queries, pyramid, points, occ, expd, last_iter)
        if seen["n"] % cfg.num_pips_iter == 0:
            return out[0], occ, out[2], out[3]
        return out

    monkeypatch.setattr(tapir, "refine_pips", altered)
    checks, _ = _run()
    assert not checks["occlusion_gap"]["ok"]


@pytest.mark.card
def test_tf32_control_is_not_correct(card):
    cfg, tr = manifest.config(NAME), manifest.traffic("dense_tracks")
    lim = manifest.limits(NAME)
    out = tracks.run(cfg, tr, lim, SEED, 1.0, False, card, time.perf_counter(), {}, keep=True)
    assert all(c["ok"] for c in out["check"]), out["check"]
    kept = out["kept"]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = ref.run(cfg["model"], kept["params"], kept["video"], kept["queries"], block=cfg["query_chunk"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    got = tracks.verdict(tracks.numbers(cfg, ctl, kept["ref"]), lim)
    assert not all(c["ok"] for c in got), got
