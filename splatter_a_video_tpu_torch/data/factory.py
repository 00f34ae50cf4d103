"""Training-stream factory: weighted mixes of pair-sampling policies
(counterpart of `splatter_a_video_tpu/data/factory.py`).

`dataset_types = "a+b"` with weights picks policy d with probability
weight_d at each step and delegates the (t1, t2) draw to it
(`MixedPairSampler`); the policy draw and each member's draws use their
own `RandomState`s in the JAX package's order.

Type names:
  simpleGS  -> uniform id2, id1 = step % T (or error-weighted)
  gaussian  -> max-interval curriculum pairs
  flow/point-> curriculum pairs as well
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Tuple

import numpy as np

from .pairs import PairSampler, PairSamplerConfig


class MixedPairSampler:
    """Weighted mixture of pair samplers — each `sample(step)` draws a
    policy with its configured probability and delegates to it."""

    def __init__(self, samplers: Sequence[PairSampler],
                 weights: Sequence[float], seed: int = 0):
        assert len(samplers) == len(weights) and len(samplers) > 0
        w = np.asarray(weights, np.float64)
        if abs(w.sum() - 1.0) > 1e-6:
            raise ValueError(f"dataset weights must sum to 1, got {w.sum()}")
        self.samplers = list(samplers)
        self.weights = w / w.sum()
        self.rng = np.random.RandomState(seed)

    @property
    def cfg(self):
        # error-weight updates etc. apply to every member policy
        return _BroadcastCfg(self.samplers)

    def sample(self, step: int) -> Tuple[int, int]:
        k = int(self.rng.choice(len(self.samplers), p=self.weights))
        return self.samplers[k].sample(step)

    def set_max_interval(self, max_interval: int) -> None:
        for s in self.samplers:
            T = s.cfg.num_frames
            s.cfg.start_interval = min(max_interval, T - 1)

    def increase_max_interval_by(self, increment: int) -> None:
        for s in self.samplers:
            T = s.cfg.num_frames
            s.cfg.start_interval = min(
                s.cfg.start_interval + increment, T - 1
            )


class _BroadcastCfg:
    """Write-through proxy so `sampler.cfg.error_weights = w` (the fit
    loop's error-map resampling hook) reaches every member policy."""

    def __init__(self, samplers):
        object.__setattr__(self, "_samplers", samplers)

    def __getattr__(self, name):
        return getattr(self._samplers[0].cfg, name)

    def __setattr__(self, name, value):
        for s in self._samplers:
            setattr(s.cfg, name, value)


# the reference's dataset_dict names -> sampler-policy constructors
def _policy(
    name: str, num_frames: int, seed: int, start_interval: int = 5
) -> PairSampler:
    base = PairSamplerConfig(
        num_frames=num_frames, seed=seed, start_interval=start_interval
    )
    if name == "simpleGS":
        return PairSampler(base)
    if name in ("gaussian", "flow", "point"):
        return PairSampler(replace(base, use_curriculum=True))
    raise KeyError(
        f"unknown dataset type {name!r} "
        "(expected simpleGS / gaussian / flow / point)"
    )


def make_training_sampler(
    dataset_types: str,
    num_frames: int,
    dataset_weights: Optional[Sequence[float]] = None,
    seed: int = 0,
    start_interval: int = 5,
):
    """`get_training_dataset`-shaped entry: 'a+b' type strings build the
    weighted mixture; a single type returns its plain sampler."""
    names = dataset_types.split("+")
    if len(names) == 1:
        return _policy(names[0], num_frames, seed, start_interval)
    if dataset_weights is None or len(dataset_weights) != len(names):
        raise ValueError(
            "dataset_weights must match dataset_types "
            f"({len(names)} entries)"
        )
    samplers = [
        _policy(n, num_frames, seed + i, start_interval) for i, n in enumerate(names)
    ]
    return MixedPairSampler(samplers, dataset_weights, seed=seed)
