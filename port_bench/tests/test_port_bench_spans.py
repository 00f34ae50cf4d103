"""The readers of the program's spans and counters (`metrics/*.py` over
`splatter_a_video_tpu_torch.utils.spans`): each gives its per-step value on
a hand-built record and nothing on an empty one."""

import pytest

from port_bench import manifest
from splatter_a_video_tpu_torch.utils import spans

WINDOW = {
    "steps": 8,
    "spans": {
        "fit.step": {"count": 8, "host_s": 1.30, "stream_s": 1.28},
        "fit.batch_wait": {"count": 8, "host_s": 0.004, "stream_s": 0.0},
        "step.loss.rgb": {"count": 8, "host_s": 0.02, "stream_s": 0.40},
        "step.render_inputs": {"count": 8, "host_s": 0.01, "stream_s": 0.12},
        "step.adam": {"count": 8, "host_s": 0.03, "stream_s": 0.08},
    },
    "counters": {"sync": 248, "h2d_async": 32},
}
EMPTY = {"steps": 0, "spans": {}, "counters": {}}
SETUP = {"setup.lift": 30.0, "setup.scene": 33.0, "setup.knn": 28.5, "setup.spline": 4.0}
EXPECTED = {
    "prefetch_wait_ms.fit": 0.5,
    "syncs_per_step.fit": 31.0,
    "ssim_ms.fit": 50.0,
    "trajectory_ms.fit": 15.0,
    "adam_ms.fit": 10.0,
    "init_knn_s.setup": 28.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_record(monkeypatch, name):
    monkeypatch.setattr(spans, "last_window", lambda: WINDOW)
    monkeypatch.setattr(spans, "last_setup", lambda: dict(SETUP))
    assert manifest.reader(name).read({}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_nothing_on_an_empty_record(monkeypatch, name):
    monkeypatch.setattr(spans, "last_window", lambda: EMPTY)
    monkeypatch.setattr(spans, "last_setup", lambda: {})
    assert manifest.reader(name).read({}) is None


@pytest.mark.parametrize("name", ["ssim_ms.fit", "trajectory_ms.fit", "adam_ms.fit"])
def test_stream_readers_give_nothing_without_device_events(monkeypatch, name):
    host_only = {**WINDOW, "spans": {k: {**v, "stream_s": None} for k, v in WINDOW["spans"].items()}}
    monkeypatch.setattr(spans, "last_window", lambda: host_only)
    assert manifest.reader(name).read({}) is None


def test_readers_give_nothing_on_a_program_without_spans(monkeypatch):
    import sys

    from splatter_a_video_tpu_torch import utils

    monkeypatch.setattr(spans, "last_window", lambda: WINDOW)
    monkeypatch.setattr(spans, "last_setup", lambda: dict(SETUP))
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "splatter_a_video_tpu_torch.utils.spans", None)
    for name in EXPECTED:
        assert manifest.reader(name).read({}) is None, name
