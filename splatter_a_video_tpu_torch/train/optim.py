"""Per-attribute Adam with the production learning rates and schedules
(counterpart of `splatter_a_video_tpu/train/optim.py`).

The JAX package builds one optax Adam chain per scene attribute. The port
writes that Adam by hand over the params dict, with optax's semantics:

    mu <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu,   count += 1
    p  <- p - lr(count - 1) * mu_hat / (sqrt(nu_hat) + eps)

with eps = 1e-15 outside the square root. All attributes share one step
count, and `zero_moments_at` zeroes moments without resetting it, which
`torch.optim.Adam` (a count per parameter) would not reproduce. Like the
JAX step, an update returns new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

# production learning rates (frag_gs_v10.yaml:40-67); position-like params
# additionally get the exponential schedule (yaml:68-90)
DEFAULT_LRS: Dict[str, float] = {
    "position": 0.00006,
    "pos_cubic_coeff": 0.00006,
    "features_dc": 0.0025,
    "features_rest": 0.000125,
    "scaling": 0.005,
    "rotation": 0.001,
    "opacity": 0.05,
    "pos_poly_feat": 0.001,
    "pos_fourier_feat": 0.00006,
    "rot_poly_feat": 0.001,
    "rot_fourier_feat": 0.001,
    "mask_attribute": 0.001,
    "dino_attribute": 0.001,
    "pos_lbs_logits": 0.001,
    "lbs_bone_poly": 0.001,
    "lbs_bone_fourier": 0.001,
}

DEFAULT_SCHEDULES: Dict[str, Tuple[float, float]] = {
    # name -> (init, final), log-lerped over max_steps
    "position": (0.00006, 0.0000016),
    "pos_cubic_coeff": (0.00006, 0.0000016),
    "pos_poly_feat": (0.001, 0.00001),
    "pos_fourier_feat": (0.00006, 0.0000016),
    "rot_poly_feat": (0.001, 0.00001),
    "rot_fourier_feat": (0.001, 0.00001),
}


def expon_lr(init: float, final: float, max_steps: int,
             lr_scale: float = 1.0) -> Callable[[int], torch.Tensor]:
    """lr(step) = exp(lerp(log(init * s), log(final * s), clip(step / max_steps))),
    in float32 as the JAX package computes it."""
    li = float(np.log(init * lr_scale))
    lf = float(np.log(final * lr_scale))

    def sched(step) -> torch.Tensor:
        t = torch.clamp(torch.tensor(step, dtype=torch.float32) / max_steps, 0.0, 1.0)
        return torch.exp(li * (1 - t) + lf * t)

    return sched


@dataclass(frozen=True)
class OptimConfig:
    max_steps: int = 20000
    eps: float = 1e-15                      # frag_gs_v10.yaml:25
    b1: float = 0.9
    b2: float = 0.999
    # every scheduled group's lr is scaled by cameras_extent = 5
    # (trainer_fragGS.py:127,229,241), so the production position lr is
    # 3e-4 -> 8e-6
    spatial_lr_scale: float = 5.0
    lrs: Tuple[Tuple[str, float], ...] = tuple(sorted(DEFAULT_LRS.items()))
    schedules: Tuple[Tuple[str, Tuple[float, float]], ...] = tuple(
        sorted(DEFAULT_SCHEDULES.items())
    )


class AdamState(NamedTuple):
    count: int                       # updates applied so far (shared)
    mu: Dict[str, torch.Tensor]      # first moments, one per attribute
    nu: Dict[str, torch.Tensor]      # second moments


def learning_rate(cfg: OptimConfig, name: str, count: int) -> torch.Tensor:
    """The lr of attribute `name` for the update after `count` updates;
    attributes without an entry get 0.001."""
    schedules = dict(cfg.schedules)
    if name in schedules:
        init, final = schedules[name]
        return expon_lr(init, final, cfg.max_steps, cfg.spatial_lr_scale)(count)
    return torch.tensor(dict(cfg.lrs).get(name, 0.001), dtype=torch.float32)


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


@torch.no_grad()
def adam_update(cfg: OptimConfig, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: AdamState):
    """One Adam step over every attribute: (new params, new state)."""
    count = state.count + 1
    dev = next(iter(params.values())).device
    bc1 = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** count).to(dev)
    bc2 = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** count).to(dev)
    new, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1 - cfg.b1) * g + cfg.b1 * state.mu[k]
        nu[k] = (1 - cfg.b2) * (g * g) + cfg.b2 * state.nu[k]
        mu_hat = mu[k] / bc1
        nu_hat = nu[k] / bc2
        step_size = -learning_rate(cfg, k, state.count).to(p.device)
        new[k] = p + step_size * (mu_hat / (torch.sqrt(nu_hat) + cfg.eps))
    return new, AdamState(count=count, mu=mu, nu=nu)


def zero_moments_at(state: AdamState, slot_mask: torch.Tensor,
                    names: Optional[Tuple[str, ...]] = None) -> AdamState:
    """Zero the Adam moments at the masked slots ([capacity] bool), of every
    per-Gaussian attribute or of `names` only. The step count stays."""

    def zero(name, x):
        if (names is not None and name not in names) or x.dim() == 0 or x.shape[0] != slot_mask.shape[0]:
            return x
        keep = (~slot_mask).reshape((slot_mask.shape[0],) + (1,) * (x.dim() - 1))
        return x * keep.to(x.dtype)

    return AdamState(
        count=state.count,
        mu={k: zero(k, v) for k, v in state.mu.items()},
        nu={k: zero(k, v) for k, v in state.nu.items()},
    )
