"""The port's spans and counters (`utils/spans.py`) on a tiny CPU fit:
they record exactly while a `torch.profiler` session records, the train
step's stages nest inside `fit.step` one after another, the counters count
the sites a step passes, nothing is recorded and no node added with no
profiler, and tracing changes no number. Port only: no JAX here."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from splatter_a_video_tpu_torch.data import synthetic as tsyn
from splatter_a_video_tpu_torch.train import density as tden
from splatter_a_video_tpu_torch.train import fit as tfit
from splatter_a_video_tpu_torch.train import hooks as thooks
from splatter_a_video_tpu_torch.train import optim as topt
from splatter_a_video_tpu_torch.train import trainer as ttr
from splatter_a_video_tpu_torch.utils import spans

W, H, T = 64, 48, 12
STEPS = 3
MAXI = 1 << 14

# the blocking host/device crossings one step of the default (cubic-spline)
# scene passes (`sync`: device.blocking_to and the SVD's reads), and its
# pinned uploads (`h2d_async`: device.to_device)
SYNC_SITES = {
    "get_position(t1): t_norm and the spline's time": 2,
    "get_rotation(t1): t_norm": 1,
    "get_position(t2): t_norm and the spline's time": 2,
    "project_ortho: [W, H] twice (one in _culled)": 2,
    "ewa_ortho: the tile grid and block": 2,
    "splat_scene: bg and the alpha-gradient mask": 2,
    "tracking_loss: [w, h], the interval weight, the quantile's two weights": 4,
    "estimate_rotation: torch.linalg.svd's two reads of its checks": 2,
    "viewspace_grad_norm: the NDC scale": 1,
    "adam_update: two bias corrections": 2,
}
# and once in this fit: the wait after step 1, the log read at the last
# step (the metrics and the alive count) and the wait after the loop
FIT_SYNC_SITES = 1 + 2 + 1
H2D_SITES = {"batch_to_device: query_px, target_tracks, track_valid": 3, "arap_sample: the uniform draws": 1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    return tsyn.make_clip(tsyn.SyntheticClipConfig())


def port_cfgs(steps, tracks=64):
    """`tests/test_torch_fit.py`'s `port_cfgs` (ARAP on, no density event)."""
    fcfg = tfit.FitConfig(num_iters=steps, num_fg_samples=100, num_bg_samples=100, num_track_samples=tracks,
                          log_every=10)
    tcfg = ttr.TrainerConfig(width=W, height=H, num_frames=T, num_track_samples=tracks, max_intersections=MAXI,
                             arap_sample_num=64, arap_weight=1e-3, optim=topt.OptimConfig(max_steps=20),
                             densify=tden.DensifyConfig(densify_start_iter=10**9))
    return fcfg, tcfg


class Profiled(thooks.Hook):
    """A caller's own CPU profiler over steps [1, STEPS]."""

    prof = None

    def before_train_iter(self, ctx):
        if ctx.step == 1:
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            self.prof.start()

    def after_train(self, ctx):
        self.prof.stop()
        spans.poll()


@pytest.fixture(scope="module")
def traced(clip):
    hook = Profiled()
    state, _ = tfit.fit_clip(clip, *port_cfgs(STEPS), hooks=[hook], device="cpu")
    return state, hook.prof, spans.last_window()


@pytest.fixture(scope="module")
def untraced(clip, traced):
    """The same fit with no profiler, `record_function` and CUDA events
    made to raise."""
    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    before = spans.last_window()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        mp.setattr(torch.cuda, "Event", refuse)
        state, _ = tfit.fit_clip(clip, *port_cfgs(STEPS), device="cpu")
    return state, before, spans.last_window()


def test_window_holds_the_traced_steps(traced):
    _, prof, window = traced
    assert window["steps"] == STEPS
    names = {e.name for e in prof.events()}
    for name in ("fit.step", "fit.batch_wait", "fit.upload", "step.render_inputs", "step.project",
                 "step.binning", "step.blend", "step.loss.rgb", "step.loss.track", "step.loss.depth",
                 "step.loss.arap", "step.backward", "step.adam", "step.density_stats"):
        assert name in names and window["spans"][name]["host_s"] > 0, name
        assert window["spans"][name]["stream_s"] is None          # no CUDA events on the CPU
    assert sum(e.name == "fit.step" for e in prof.events()) == STEPS


def test_stages_nest_in_the_step_one_after_another(traced):
    _, prof, _ = traced
    ev = sorted((e for e in prof.events() if e.name.startswith(("fit.step", "step."))),
                key=lambda e: e.time_range.start)
    steps = [e.time_range for e in ev if e.name == "fit.step"]
    stages = [e for e in ev if e.name.startswith("step.")]
    assert len(stages) == STEPS * 11
    for e in stages:
        assert any(s.start <= e.time_range.start and e.time_range.end <= s.end for s in steps), e.name
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)


def test_counters_count_the_sites_a_step_passes(traced):
    state, _, window = traced
    adam_lrs = len(state.scene.params)          # one learning rate a attribute
    assert adam_lrs == 13
    assert window["counters"] == {"sync": STEPS * (sum(SYNC_SITES.values()) + adam_lrs) + FIT_SYNC_SITES,
                                  "h2d_async": STEPS * sum(H2D_SITES.values())}


def test_nothing_is_recorded_without_a_profiler(untraced):
    _, before, window = untraced
    assert window == before                      # the window before the fit, untouched
    x, y = torch.ones(3, requires_grad=True), torch.zeros(2, requires_grad=True)
    assert spans.stage_in("s", x) is x and spans.stage_out("s", x) is x
    out = spans.stage_in("s", x, y)
    assert out[0] is x and out[1] is y
    assert spans.span("a") is spans.span("b")    # the one shared null context
    spans.count("sync")
    assert spans.last_window() == window


def test_tracing_changes_no_number(traced, untraced):
    a, b = traced[0], untraced[0]
    assert a.step == b.step == STEPS
    for k in a.scene.params:
        assert torch.equal(a.scene.params[k], b.scene.params[k]), k
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k


def test_set_up_record_feeds_the_timing(clip):
    _, hist = tfit.fit_clip(clip, *port_cfgs(1), device="cpu")
    setup, timing = spans.last_setup(), hist[-1]["timing"]
    assert set(setup) == {"setup.lift", "setup.scene", "setup.knn", "setup.spline"}
    assert timing["lift_s"] == round(setup["setup.lift"], 2)
    assert timing["create_scene_s"] == round(setup["setup.scene"], 2)
    assert setup["setup.knn"] + setup["setup.spline"] <= setup["setup.scene"]


def test_profile_dir_writes_the_window_beside_the_trace(clip, tmp_path):
    fcfg, tcfg = port_cfgs(3)
    fcfg = dataclasses.replace(fcfg, profile_dir=str(tmp_path), profile_start=2, profile_count=1)
    tfit.fit_clip(clip, fcfg, tcfg, device="cpu")
    assert (tmp_path / "fit_steps_2_3.json").stat().st_size > 1000
    rec = json.loads((tmp_path / "fit_steps_2_3.spans.json").read_text())
    assert rec["steps"] == 1 and set(rec) == {"steps", "spans", "counters"}
    assert rec["spans"]["step.adam"]["count"] == 1.0 and rec["spans"]["step.adam"]["host_ms"] > 0
    assert rec["spans"]["step.adam"]["stream_ms"] is None
    # one step's sites, and the wait that ends the trace
    assert rec["counters"] == {"sync": sum(SYNC_SITES.values()) + 13 + 1, "h2d_async": sum(H2D_SITES.values())}


class FakeEvent:
    """A CUDA event stand-in: a tick of a counter, in ms."""

    clock = 0

    def __init__(self):
        FakeEvent.clock += 1
        self.t = float(FakeEvent.clock)

    def elapsed_time(self, end):
        return end.t - self.t

    def synchronize(self):
        pass


def test_stage_backward_pauses_the_enclosing_span(monkeypatch):
    """A stage's backward runs inside `step.backward`: its events open and
    close it there, and `step.backward` keeps only the time around it."""
    monkeypatch.setattr(spans._Window, "event", lambda self: FakeEvent())
    x = torch.linspace(0.5, 2.0, 5, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.poll()
        ticks = {}
        with spans.span("fit.step"):
            with spans.span("stage"):
                y = spans.stage_out("stage", torch.exp(spans.stage_in("stage", x)))
            loss = (y * y).sum()
            ticks["pre"] = FakeEvent.clock
            with spans.span("step.backward"):
                (g,) = torch.autograd.grad(loss, [x])
            ticks["post"] = FakeEvent.clock
    assert not spans.poll()
    torch.testing.assert_close(g, 2 * torch.exp(2 * x.detach()))
    w = spans._window
    # ticks: step.backward opens at pre + 1; the stage's backward opens at
    # pre + 2 (pausing it) and closes at pre + 3 (resuming it); it ends at pre + 4
    pre = ticks["pre"]
    assert ticks["post"] == pre + 4
    assert [(a.t, b.t) for a, b in w.pairs["step.backward"]] == [(pre + 1, pre + 2), (pre + 3, pre + 4)]
    assert [(a.t, b.t) for a, b in w.pairs["stage"]][1:] == [(pre + 2, pre + 3)]
    rec = spans.last_window()
    assert rec["steps"] == 1 and rec["spans"]["step.backward"]["stream_s"] == pytest.approx(2e-3)
    assert rec["spans"]["stage"]["count"] == 1 and rec["spans"]["fit.step"]["stream_s"] > rec["spans"]["stage"]["stream_s"]
    assert spans.per_step(rec)["spans"]["stage"]["stream_ms"] == pytest.approx(rec["spans"]["stage"]["stream_s"] * 1e3)
    assert np.isfinite(rec["spans"]["fit.step"]["host_s"])
