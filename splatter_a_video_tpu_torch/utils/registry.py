"""Name -> implementation registries, decoupling configurations from code
(counterpart of `splatter_a_video_tpu/utils/registry.py`). Entries are
registered by decorator, or lazily as `module:attr` paths imported on
first use; the lazy entries below point at the port's own modules."""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._classes: Dict[str, Any] = {}
        self._lazy: Dict[str, str] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(cls):
            self._classes[name or cls.__name__] = cls
            return cls

        return deco

    def register_lazy(self, name: str, module_path: str) -> None:
        """Register `module:attr` to import on first use."""
        self._lazy[name] = module_path

    def get(self, name: str):
        if name in self._classes:
            return self._classes[name]
        if name in self._lazy:
            mod, attr = self._lazy[name].split(":")
            cls = getattr(importlib.import_module(mod), attr)
            self._classes[name] = cls
            return cls
        raise KeyError(f"{self.name}: unknown '{name}' (known: {sorted(self._classes) + sorted(self._lazy)})")

    def __contains__(self, name: str) -> bool:
        return name in self._classes or name in self._lazy


TRAJECTORY_REGISTRY = Registry("trajectory")
RENDERER_REGISTRY = Registry("renderer")
LOSS_REGISTRY = Registry("loss")

_P = "splatter_a_video_tpu_torch"
TRAJECTORY_REGISTRY.register_lazy("poly_fourier", f"{_P}.models.trajectory:position_poly_fourier")
TRAJECTORY_REGISTRY.register_lazy("cubic_spline", f"{_P}.models.trajectory:position_cubic_spline")
RENDERER_REGISTRY.register_lazy("ortho", f"{_P}.ops.rasterize:render_gaussians")
LOSS_REGISTRY.register_lazy("rgb", f"{_P}.train.losses:rgb_loss")
LOSS_REGISTRY.register_lazy("tracking", f"{_P}.train.losses:tracking_loss")
LOSS_REGISTRY.register_lazy("depth_dpt", f"{_P}.train.losses:depth_loss_dpt")
LOSS_REGISTRY.register_lazy("arap", f"{_P}.train.losses:arap_loss")
