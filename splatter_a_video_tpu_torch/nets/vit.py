"""DINOv2 vision transformer trunk, inference path (counterpart of
`splatter_a_video_tpu/nets/vit.py`).

The backbone behind Depth-Anything-V2, layer for layer as
`transformers.models.dinov2.modeling_dinov2`: patch embeddings and a cls
token, bicubic-resampled position embeddings, pre-LN blocks with
LayerScale, an exact-erf GELU MLP and the final layernorm on the tapped
hidden states. The stride = kernel patch conv is a reshape and one matmul;
attention is plain float32 matmuls and a softmax. Params are the JAX
package's flat name -> array dict (linears [in, out], the patch kernel
HWIO), converted from a torch state_dict by `params_from_torch`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .convert_util import ParamModule, to_numpy
from .interp import interp2d


@dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384           # DINOv2-small (the DA-V2 small backbone)
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 518            # position-embedding training grid
    layer_norm_eps: float = 1e-6

    @property
    def pos_grid(self) -> int:
        return self.image_size // self.patch_size


def random_params(cfg: ViTConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's deterministic random init (numpy, same draws)."""
    rng = np.random.RandomState(seed)
    C, P = cfg.hidden_size, cfg.patch_size
    n_pos = cfg.pos_grid * cfg.pos_grid + 1

    def lin(cin, cout):
        return (rng.randn(cin, cout) / math.sqrt(cin)).astype(np.float32)

    p: Dict[str, np.ndarray] = {
        "cls_token": rng.randn(1, 1, C).astype(np.float32) * 0.02,
        "pos_embed": rng.randn(1, n_pos, C).astype(np.float32) * 0.02,
        "patch_w": (rng.randn(P, P, 3, C) / math.sqrt(P * P * 3)).astype(np.float32),
        "patch_b": np.zeros(C, np.float32),
        "ln_w": np.ones(C, np.float32),
        "ln_b": np.zeros(C, np.float32),
    }
    for i in range(cfg.num_layers):
        p.update({
            f"l{i}.ln1_w": np.ones(C, np.float32),
            f"l{i}.ln1_b": np.zeros(C, np.float32),
            f"l{i}.q_w": lin(C, C), f"l{i}.q_b": np.zeros(C, np.float32),
            f"l{i}.k_w": lin(C, C), f"l{i}.k_b": np.zeros(C, np.float32),
            f"l{i}.v_w": lin(C, C), f"l{i}.v_b": np.zeros(C, np.float32),
            f"l{i}.proj_w": lin(C, C), f"l{i}.proj_b": np.zeros(C, np.float32),
            f"l{i}.ls1": np.full(C, 1.0, np.float32),
            f"l{i}.ln2_w": np.ones(C, np.float32),
            f"l{i}.ln2_b": np.zeros(C, np.float32),
            f"l{i}.fc1_w": lin(C, C * cfg.mlp_ratio),
            f"l{i}.fc1_b": np.zeros(C * cfg.mlp_ratio, np.float32),
            f"l{i}.fc2_w": lin(C * cfg.mlp_ratio, C),
            f"l{i}.fc2_b": np.zeros(C, np.float32),
            f"l{i}.ls2": np.full(C, 1.0, np.float32),
        })
    return p


def params_from_torch(sd, prefix: str = "") -> Dict[str, np.ndarray]:
    """Convert a `Dinov2Model` / `Dinov2Backbone` torch state_dict (keys
    under `prefix`, e.g. "backbone." in a Depth-Anything state_dict) to the
    JAX package's numpy dict."""

    def g(name):
        return to_numpy(sd[prefix + name])

    p: Dict[str, np.ndarray] = {
        "cls_token": g("embeddings.cls_token"),
        "pos_embed": g("embeddings.position_embeddings"),
        # conv OIHW -> HWIO
        "patch_w": g("embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0),
        "patch_b": g("embeddings.patch_embeddings.projection.bias"),
        "ln_w": g("layernorm.weight"),
        "ln_b": g("layernorm.bias"),
    }
    i = 0
    while prefix + f"encoder.layer.{i}.norm1.weight" in sd:
        base = f"encoder.layer.{i}."
        att = base + "attention.attention."
        p.update({
            f"l{i}.ln1_w": g(base + "norm1.weight"),
            f"l{i}.ln1_b": g(base + "norm1.bias"),
            f"l{i}.q_w": g(att + "query.weight").T,
            f"l{i}.q_b": g(att + "query.bias"),
            f"l{i}.k_w": g(att + "key.weight").T,
            f"l{i}.k_b": g(att + "key.bias"),
            f"l{i}.v_w": g(att + "value.weight").T,
            f"l{i}.v_b": g(att + "value.bias"),
            f"l{i}.proj_w": g(base + "attention.output.dense.weight").T,
            f"l{i}.proj_b": g(base + "attention.output.dense.bias"),
            f"l{i}.ls1": g(base + "layer_scale1.lambda1"),
            f"l{i}.ln2_w": g(base + "norm2.weight"),
            f"l{i}.ln2_b": g(base + "norm2.bias"),
            f"l{i}.fc1_w": g(base + "mlp.fc1.weight").T,
            f"l{i}.fc1_b": g(base + "mlp.fc1.bias"),
            f"l{i}.fc2_w": g(base + "mlp.fc2.weight").T,
            f"l{i}.fc2_b": g(base + "mlp.fc2.bias"),
            f"l{i}.ls2": g(base + "layer_scale2.lambda1"),
        })
        i += 1
    return p


def _layernorm(x, w, b, eps):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)   # jnp.var: the population variance
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _attention(p, i, x, num_heads):
    B, T, C = x.shape
    dh = C // num_heads

    def heads(v):
        return v.reshape(B, T, num_heads, dh).transpose(1, 2)

    q = heads(x @ p[f"l{i}.q_w"] + p[f"l{i}.q_b"])
    k = heads(x @ p[f"l{i}.k_w"] + p[f"l{i}.k_b"])
    v = heads(x @ p[f"l{i}.v_w"] + p[f"l{i}.v_b"])
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, C)
    return out @ p[f"l{i}.proj_w"] + p[f"l{i}.proj_b"]


def embed(cfg: ViTConfig, p: Dict[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, 1 + hw, C] tokens (H, W multiples of the patch)."""
    B, H, W, _ = images.shape
    P, C = cfg.patch_size, cfg.hidden_size
    h, w = H // P, W // P
    x = images.reshape(B, h, P, w, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, h * w, P * P * 3)
    tok = x @ p["patch_w"].reshape(P * P * 3, C) + p["patch_b"]

    pos = p["pos_embed"]
    n_pos = pos.shape[1] - 1
    if not (h * w == n_pos and H == W):
        # bicubic resample of the patch position grid (modeling_dinov2.py:57-95)
        g = int(round(math.sqrt(n_pos)))
        patch_pos = interp2d(pos[:, 1:].reshape(1, g, g, C), h, w, "bicubic", align_corners=False)
        pos = torch.cat([pos[:, :1], patch_pos.reshape(1, h * w, C)], dim=1)
    cls = p["cls_token"].expand(B, 1, C)
    return torch.cat([cls, tok], dim=1) + pos


def forward(cfg: ViTConfig, p: Dict[str, torch.Tensor], images: torch.Tensor, out_indices: Sequence[int],
            apply_layernorm: bool = True) -> List[torch.Tensor]:
    """The hidden states at `out_indices` (0 = the embeddings, i = after
    block i), each [B, 1 + hw, C], final-layernormed as
    `Dinov2Backbone.forward` with apply_layernorm=True."""
    x = embed(cfg, p, images)
    wanted = set(int(i) for i in out_indices)
    taps: Dict[int, torch.Tensor] = {0: x} if 0 in wanted else {}
    for i in range(cfg.num_layers):
        h = _layernorm(x, p[f"l{i}.ln1_w"], p[f"l{i}.ln1_b"], cfg.layer_norm_eps)
        x = x + _attention(p, i, h, cfg.num_heads) * p[f"l{i}.ls1"]
        h = _layernorm(x, p[f"l{i}.ln2_w"], p[f"l{i}.ln2_b"], cfg.layer_norm_eps)
        h = F.gelu(h @ p[f"l{i}.fc1_w"] + p[f"l{i}.fc1_b"])    # the exact erf form
        x = x + (h @ p[f"l{i}.fc2_w"] + p[f"l{i}.fc2_b"]) * p[f"l{i}.ls2"]
        if i + 1 in wanted:
            taps[i + 1] = x
    out = []
    for i in out_indices:
        t = taps[int(i)]
        if apply_layernorm:
            t = _layernorm(t, p["ln_w"], p["ln_b"], cfg.layer_norm_eps)
        out.append(t)
    return out


class ViT(ParamModule):
    """The trunk as a module: `ViT(cfg, params)(images, out_indices)`."""

    def __init__(self, cfg: ViTConfig, params: Dict[str, np.ndarray]):
        super().__init__(params)
        self.cfg = cfg

    @torch.no_grad()
    def forward(self, images: torch.Tensor, out_indices: Sequence[int],
                apply_layernorm: bool = True) -> List[torch.Tensor]:
        return forward(self.cfg, self.params, images, out_indices, apply_layernorm)
