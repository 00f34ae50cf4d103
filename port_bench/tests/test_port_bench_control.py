"""The controls on the card, each put in the program's place and not correct
under the committed limits, while the program's own run is: the reference's
steps computed with TF32 on (at a size a test run holds), and the program's
scene set-up with TF32 on (at the cell's size, where its kNN uses TF32)."""

import copy
import math
import time

import pytest
import torch

from port_bench import clip, compare, harness, manifest
from port_bench.reference import follow, scene

SEED = 2 ** 31 + 777


def _mid_config(name):
    cfg = copy.deepcopy(manifest.config(name))
    alive = 60000
    cfg.update(frame_size=[960, 540], blob_radius=47.25, track_grid=2, alive_at_start=alive, capacity_factor=1.031,
               num_fg_samples=30000, num_bg_samples=20000, max_intersections=1 << 22)
    cfg["capacity"] = math.ceil(alive * 1.031 / 128) * 128
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("name", ["flagship_2160p", "frag_gs_v10_2160p"])
def test_tf32_control_is_not_correct(card, name):
    cfg, lim, tr = _mid_config(name), manifest.limits(name), manifest.traffic("steady_fit")
    out = harness.run_cell(cfg, tr, lim, SEED, 1.0, False, card, time.perf_counter(), {}, [], keep=True)
    assert all(c["ok"] for c in out["check"]), out["check"]
    kept = out["kept"]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = follow.follow(kept["init"], kept["clip"], cfg, harness.fit_seed(SEED), tr["check_steps"], card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    steps = compare.verdict(compare.step_numbers(ctl, kept["ref"]), lim)
    assert {c["name"]: c["value"] for c in steps}["pairs_gap"] == 0
    assert not all(c["ok"] for c in steps), steps


@pytest.mark.card
def test_tf32_scene_control_is_not_correct(card):
    """The program's scene set-up with TF32 on, at the cell's own size: at
    60,000 points the kNN's matmul reads as without TF32 (1.0e-3)."""
    from splatter_a_video_tpu_torch.train import fit

    name = "flagship_2160p"
    cfg, lim = manifest.config(name), manifest.limits(name)
    kept = clip.make_clip(clip.spec_from_config(cfg), SEED, card)
    fcfg, _ = harness.program_configs(cfg, SEED)
    track_seq, colors = fit.lift_clip(clip.to_video_flow(kept), fcfg)
    ref = scene.initial_scene(kept, cfg, harness.fit_seed(SEED), card)
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            sc, _ = fit.scene_from_tracks(track_seq, colors, cfg["num_frames"], fcfg, device=card)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        prog = {"params": sc.params, "alive": sc.aux["alive"], "knots": sc.aux.get("spline_knots")}
        init = compare.verdict(compare.init_numbers(prog, ref), lim)
        del sc, prog
        assert all(c["ok"] for c in init) != tf32, init
