"""Spans and counters inside the port, on the profiler's clock.

They record exactly while a `torch.profiler` session records, whoever
started it (`FitConfig.profile_dir`, or a hook of the caller's): `fit_clip`
calls `poll()` once a step, after its hooks, and the record starts afresh
when the profiler turns on and freezes when it turns off. With no profiler
recording, `span` and `count` are one boolean check each, and `stage_in` /
`stage_out` return their tensors: no `record_function`, no clock reading,
no CUDA event, no autograd node.

While recording, a span

  * opens a `torch.profiler.record_function` of its name, so it sits in
    the Chrome trace on the device's clock beside the kernels, copies and
    idle gaps;
  * adds its host seconds to the record, per name;
  * records a CUDA event at enter and at exit on the fit device's stream
    (the one current when the window started: the port runs on one). The
    events are resolved only by `last_window()`, never on the hot path: a
    span's stream time is the sum of its event pairs' elapsed times, idle
    time included.

`stage_in(name, *tensors)` and `stage_out(name, *tensors)` wrap a stage's
inputs and outputs in identity autograd functions while recording. The
backward of `stage_out` records the event that opens the stage's backward
on the stream and that of `stage_in` the one that closes it; meanwhile the
innermost open span (the step's `step.backward`) pauses. So a stage's
stream time is its forward and its backward, and the stages' intervals stay
disjoint.

Set-up spans (`setup_span`) are the exception: a handful a fit, seconds
each. They keep their host seconds whether or not a profiler records, in a
record that `fit_clip` resets at its start (`reset_setup`, `last_setup`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()
_lock = threading.Lock()


class _Window:
    """What one stretch of recording holds."""

    def __init__(self, device: Optional[torch.device]):
        # a CUDA device: events on its stream (looked up once: a lookup costs
        # more than recording an event)
        self.stream = None if device is None else torch.cuda.current_stream(device)
        self.count: Dict[str, int] = {}
        self.host_s: Dict[str, float] = {}
        self.pairs: Dict[str, List[tuple]] = {}
        self.counters: Dict[str, int] = {}
        self.open: List[list] = []             # [name, start event] of open spans, innermost last
        self.backward: Dict[str, tuple] = {}   # stage -> (open event, the span it paused)

    def event(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def pair(self, name: str, start, end) -> None:
        if start is not None and end is not None:
            self.pairs.setdefault(name, []).append((start, end))


_on = False
_window = _Window(None)
_setup: Dict[str, float] = {}


def poll(device=None) -> bool:
    """Follow the profiler: start a new window when it has turned on since
    the last call, freeze the window when it has turned off. `device` is
    the fit's device; events are recorded on a CUDA device's stream."""
    global _on, _window
    on = torch._C._autograd._profiler_enabled()
    if on and not _on:
        dev = None if device is None else torch.device(device)
        _window = _Window(dev if dev is not None and dev.type == "cuda" else None)
    _on = on
    return on


class _Span:
    __slots__ = ("name", "rf", "entry", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        w = _window
        self.entry = [self.name, w.event()]
        with _lock:
            w.open.append(self.entry)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        w = _window
        end = w.event()
        with _lock:
            w.open = [e for e in w.open if e is not self.entry]
            w.count[self.name] = w.count.get(self.name, 0) + 1
            w.host_s[self.name] = w.host_s.get(self.name, 0.0) + dt
            w.pair(self.name, self.entry[1], end)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: one span of `name` while recording, else a shared
    null context."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while recording."""
    if not _on:
        return
    with _lock:
        _window.counters[name] = _window.counters.get(name, 0) + n


def _open_backward(name: str) -> None:
    w = _window
    with _lock:
        ev = w.event()
        paused = w.open[-1] if w.open else None
        if paused is not None:
            w.pair(paused[0], paused[1], ev)
            paused[1] = None
        w.backward[name] = (ev, paused)


def _close_backward(name: str) -> None:
    w = _window
    with _lock:
        if name not in w.backward:
            return
        ev = w.event()
        start, paused = w.backward.pop(name)
        w.pair(name, start, ev)
        if paused is not None and any(e is paused for e in w.open):
            paused[1] = ev


class _Stage(torch.autograd.Function):
    """The identity; its backward calls `mark(name)`."""

    @staticmethod
    def forward(ctx, mark, name, *xs):
        ctx.mark, ctx.name = mark, name
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.mark(ctx.name)
        return (None, None) + gs


def _stage(mark, name: str, xs):
    if not _on:
        return xs[0] if len(xs) == 1 else xs
    out = _Stage.apply(mark, name, *xs)
    return out[0] if len(out) == 1 else out


def stage_in(name: str, *tensors):
    """The stage's inputs (the tensor itself for one, else a tuple); while
    recording, through an identity whose backward closes the stage's
    backward."""
    return _stage(_close_backward, name, tensors)


def stage_out(name: str, *tensors):
    """The stage's outputs (the tensor itself for one, else a tuple); while
    recording, through an identity whose backward opens the stage's
    backward."""
    return _stage(_open_backward, name, tensors)


def last_window() -> dict:
    """The last window: {"steps": the `fit.step` spans, "spans": {name:
    {"count", "host_s", "stream_s"}}, "counters": {name: n}}. `stream_s` is
    the sum of the span's event pairs (forward and backward), None without
    CUDA events. Waits for the window's last events."""
    w = _window
    with _lock:
        names = sorted(set(w.count) | set(w.pairs))
        spans = {}
        for name in names:
            pairs = w.pairs.get(name, [])
            if pairs:
                pairs[-1][1].synchronize()
                stream = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
            else:
                stream = None
            spans[name] = {"count": w.count.get(name, 0), "host_s": w.host_s.get(name, 0.0), "stream_s": stream}
        return {"steps": w.count.get("fit.step", 0), "spans": spans, "counters": dict(w.counters)}


def per_step(window: dict) -> dict:
    """A window's spans in ms per step and its counters per step."""
    n = window["steps"]
    if not n:
        return {"steps": 0, "spans": {}, "counters": {}}
    ms = lambda s: None if s is None else s * 1e3 / n
    return {"steps": n,
            "spans": {k: {"count": v["count"] / n, "host_ms": ms(v["host_s"]), "stream_ms": ms(v["stream_s"])}
                      for k, v in window["spans"].items()},
            "counters": {k: v / n for k, v in window["counters"].items()}}


@contextlib.contextmanager
def setup_span(name: str):
    """A set-up span: its host seconds go to the set-up record whether or
    not a profiler records (and it is a `record_function` while one does)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name) if torch._C._autograd._profiler_enabled() else _NULL:
        yield
    _setup[name] = _setup.get(name, 0.0) + time.perf_counter() - t0


def reset_setup() -> None:
    _setup.clear()


def last_setup() -> Dict[str, float]:
    """Host seconds of each set-up span since the last `reset_setup`."""
    return dict(_setup)
