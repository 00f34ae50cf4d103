"""Frame-pair sampling, batch assembly and background prefetch (counterpart
of `splatter_a_video_tpu/data/pairs.py`).

  * `PairSampler`: id1 = step % num_frames (or drawn by per-frame error
    weights), id2 uniform or within a max-interval curriculum;
  * `BatchBuilder`: the per-pair TAPIR track batch, padded or subsampled
    to `num_track_samples`, as numpy arrays in the port's `trainer.Batch`;
  * `batch_stream`: a background thread assembles the numpy batches;
    `batch_to_device` moves one to the card in the consuming thread;
  * `dp_batch_stream`: the data-parallel stream, n pairs a step.

The samplers' and the builder's `RandomState`s are drawn in the JAX
package's order, so both packages see the same pairs and track rows. For
an on-disk clip both packages draw the rows in the native loader
(`data/native_loader.py`, `native/sav_loader.cpp`) on the same per-step
seed; in-memory clips, or a failed build, take the numpy path in both.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import to_device
from ..train.trainer import Batch
from ..utils import spans as _spans
from .video_flow import VideoFlowData


@dataclass
class PairSamplerConfig:
    num_frames: int
    error_weights: Optional[np.ndarray] = None  # per-frame sampling weights
    start_interval: int = 5                     # curriculum start
    interval_growth_steps: int = 2000           # +1 max_interval per this many
    use_curriculum: bool = False
    seed: int = 0


class PairSampler:
    """Deterministic, seeded (t1, t2) pair stream."""

    def __init__(self, cfg: PairSamplerConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)

    def max_interval(self, step: int) -> int:
        """Curriculum: start_interval + step // growth."""
        return self.cfg.start_interval + step // self.cfg.interval_growth_steps

    def sample(self, step: int):
        T = self.cfg.num_frames
        if self.cfg.error_weights is not None:
            w = self.cfg.error_weights / self.cfg.error_weights.sum()
            t1 = int(self.rng.choice(T, p=w))
        else:
            t1 = step % T
        if self.cfg.use_curriculum:
            mi = max(1, self.max_interval(step))
            lo = max(0, t1 - mi)
            hi = min(T - 1, t1 + mi)
            t2 = int(self.rng.randint(lo, hi + 1))
        else:
            t2 = int(self.rng.randint(0, T))
        return t1, t2


class BatchBuilder:
    """Assemble fixed-shape numpy `Batch`es from a `VideoFlowData` clip.

    When the clip's tracks live on disk, the rows are drawn by the native
    C++ loader on a per-step seed from `rng` (the JAX package's condition
    and draw order); in-memory clips use the numpy path.
    """

    def __init__(self, data: VideoFlowData, num_track_samples: int = 4096, seed: int = 0,
                 use_native: bool = True, slim: bool = False):
        """slim=True leaves out the per-frame images (rgb1 / depth1 / mask1 /
        dino1): the train step reads them from its `trainer.FrameStore`."""
        self.data = data
        self.P = num_track_samples
        self.slim = slim
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self._query_cache = {}   # query pixels of each t1 (on the pixel grid)
        self._native = None
        if use_native and data.tracks_dir and data.tracks is None:
            from .native_loader import NativeTrackLoader

            try:
                self._native = NativeTrackLoader(data.tracks_dir, data.frame_names)
            except RuntimeError:   # no g++ or a failed build: the numpy path, as in JAX
                self._native = None

    def _query_pixels(self, t1: int) -> np.ndarray:
        if t1 not in self._query_cache:
            self._query_cache[t1] = self.data.load_target_tracks(t1, [t1])[:, 0, :2]
        return self._query_cache[t1]

    def build(self, t1: int, t2: int) -> Batch:
        P = self.P
        if self._native is not None:
            qp, tt, valid = self._native.build(t1, t2, P, int(self.rng.randint(0, 2**31)))
        else:
            qp_all = self._query_pixels(t1)                           # [N, 2]
            tt_all = self.data.load_target_tracks(t1, [t2])[:, 0, :]  # [N, 4]
            N = len(qp_all)
            if N >= P:
                sel = self.rng.choice(N, P, replace=False)
                qp, tt = qp_all[sel], tt_all[sel]
                valid = np.ones((P,), bool)
            else:
                pad = P - N
                qp = np.concatenate([qp_all, np.zeros((pad, 2), np.float32)])
                tt = np.concatenate([tt_all, np.zeros((pad, 4), np.float32)])
                valid = np.concatenate([np.ones((N,), bool), np.zeros((pad,), bool)])

        if self.slim:
            return Batch(t1=int(t1), t2=int(t2), query_px=qp.astype(np.float32),
                         target_tracks=tt.astype(np.float32), track_valid=valid)
        dino1 = self.data.get_dino(t1)
        return Batch(
            t1=int(t1),
            t2=int(t2),
            rgb1=self.data.frames[t1].astype(np.float32),
            depth1=self.data.get_loss_depth(t1).astype(np.float32),
            query_px=qp.astype(np.float32),
            target_tracks=tt.astype(np.float32),
            track_valid=valid,
            mask1=np.asarray(self.data.masks_raw[t1], np.float32),
            dino1=None if dino1 is None else dino1.astype(np.float32),
        )


def batch_to_device(batch: Batch, device) -> Batch:
    """The batch's numpy arrays as tensors on `device` (on a GPU one pinned
    host copy and one non-blocking upload each); t1 and t2 stay host ints."""
    move = lambda a: None if a is None else to_device(torch.from_numpy(np.ascontiguousarray(a)), device)
    with _spans.span("fit.upload"):
        return Batch(int(batch.t1), int(batch.t2), *(move(a) for a in batch[2:]))


def _prefetch(make, steps, prefetch: int) -> Iterator[Batch]:
    """make(step) for each step, assembled on a background thread
    `prefetch` ahead of the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        for step in steps:
            if stop.is_set():
                return
            q.put(make(step))
        q.put(None)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        while True:
            with _spans.span("fit.batch_wait"):
                b = q.get()
            if b is None:
                return
            yield b
    finally:
        stop.set()


def batch_stream(sampler: PairSampler, builder: BatchBuilder, num_steps: int, prefetch: int = 2,
                 start_step: int = 0) -> Iterator[Batch]:
    """Numpy batches of steps [start_step, num_steps), assembled on a
    background thread `prefetch` ahead of the consumer."""
    return _prefetch(lambda step: builder.build(*sampler.sample(step)), range(start_step, num_steps), prefetch)


def dp_batch_stream(sampler: PairSampler, builder: BatchBuilder, num_steps: int, n_devices: int,
                    prefetch: int = 2, start_step: int = 0) -> Iterator[Batch]:
    """Data-parallel batches: each has a leading [n_devices] axis, one
    frame pair per rank (the `parallel/dp.stack_batches` layout). Step s
    takes the sampler's draws s * n + d for d = 0..n-1 and builds them in
    that order, so every rank builds all n pairs, the builder's rng
    advancing as in the JAX package, and rank d trains on slot d."""
    from ..parallel.dp import stack_batches

    def make(step):
        return stack_batches([builder.build(*sampler.sample(step * n_devices + d)) for d in range(n_devices)])

    return _prefetch(make, range(start_step, num_steps), prefetch)
