"""Multi-atlas scene container (counterpart of
`splatter_a_video_tpu/models/atlas.py`): named Gaussian atlases
(`gs_base`, `gs_fg`, ...) whose activated render inputs are concatenated
along the Gaussian axis for one fused blend, and whose per-Gaussian
gradients and statistics are split back per atlas at static offsets, the
atlases' capacities. The production configuration has one `gs_base`
atlas (`single()`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .gaussians import GaussianScene


@dataclass
class AtlasModel:
    """Ordered dict of named atlases."""

    atlases: Dict[str, GaussianScene]

    @classmethod
    def single(cls, scene: GaussianScene, name: str = "gs_base") -> "AtlasModel":
        return cls(atlases={name: scene})

    @property
    def names(self) -> List[str]:
        return list(self.atlases.keys())

    def get_atlas(self, name: str) -> GaussianScene:
        return self.atlases[name]

    def point_num_sep(self) -> List[int]:
        """Prefix offsets of each atlas in the concatenated arrays: the
        atlases' capacities, static for a model."""
        offs = [0]
        for s in self.atlases.values():
            offs.append(offs[-1] + s.alive.shape[0])
        return offs

    def slice_for(self, name: str) -> Tuple[int, int]:
        offs = self.point_num_sep()
        i = self.names.index(name)
        return offs[i], offs[i + 1]

    def forward(self, t) -> Dict[str, torch.Tensor]:
        """The concatenated activated render inputs at time t."""
        dicts = []
        for s in self.atlases.values():
            ppf = s.params["pos_poly_feat"]
            d = {
                "position": s.get_position(t),
                "opacity": s.get_opacity(),
                "scaling": s.get_scaling(),
                "rotation": s.get_rotation(t),
                "shs": s.get_shs(),
                "pos_poly_feat": ppf.reshape(ppf.shape[0], -1),
            }
            for name in ("mask_attribute", "dino_attribute"):
                if name in s.params:
                    d[name] = s.get_render_attribute(name)
            dicts.append(d)
        return {k: torch.cat([d[k] for d in dicts], dim=0) for k in dicts[0]}

    @property
    def alive(self) -> torch.Tensor:
        return torch.cat([s.alive for s in self.atlases.values()])

    def replace_atlas(self, name: str, scene: GaussianScene) -> "AtlasModel":
        return AtlasModel(atlases={**self.atlases, name: scene})

    def to(self, device) -> "AtlasModel":
        return AtlasModel(atlases={n: s.to(device) for n, s in self.atlases.items()})
