"""Strict-consumption checking for torch-checkpoint converters (counterpart
of `splatter_a_video_tpu/nets/convert_util.py`).

The converters (`tapir.params_from_torch`, `depth_anything.params_from_torch`)
address most keys by exact name, so a renamed upstream key raises KeyError,
but block-structured keys are discovered with `while name_pattern in sd`
loops, where an upstream rename would silently convert zero blocks. Strict
mode closes that hole: every key the converter did not read is an error
(minus an explicit ignore list of keys unused at inference, such as
DINOv2's `mask_token`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

import numpy as np
import torch


def to_numpy(v) -> np.ndarray:
    """A state-dict value (torch tensor or array) as a float32 numpy array."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v).astype(np.float32)


class RecordingStateDict(Mapping):
    """Wraps a torch state_dict, recording which keys are read."""

    def __init__(self, sd: Mapping):
        self._sd = sd
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self._sd[k]

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)

    def __contains__(self, k):
        return k in self._sd


def check_consumed(sd: Mapping, used: set, ignore: Iterable[str] = ()):
    """Raise if any state-dict key was not consumed (modulo ignore regexes)."""
    pats = [re.compile(p) for p in ignore]
    left = [k for k in sd if k not in used and not any(p.search(k) for p in pats)]
    if left:
        head = ", ".join(left[:8])
        more = f" (+{len(left) - 8} more)" if len(left) > 8 else ""
        raise ValueError(f"{len(left)} state-dict keys not consumed by the converter — "
                         f"upstream naming change? Unconsumed: {head}{more}")


class ParamModule(torch.nn.Module):
    """A network whose weights are a flat name -> tensor dict under the JAX
    package's names, registered as buffers (inference only) so that `.to()`
    moves them; `params` gives the dict back."""

    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        self._attrs = {}
        for k, v in params.items():
            attr = "p_" + k.replace(".", "__")
            self.register_buffer(attr, torch.as_tensor(np.ascontiguousarray(v)))
            self._attrs[k] = attr

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, a) for k, a in self._attrs.items()}

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device
