"""Sequential oracle blender (counterpart of
`splatter_a_video_tpu/ops/rasterize_ref.py`) — slow, exact, for tests only.

A per-Gaussian loop over all Gaussians in depth order (stable, ties by
index), vectorised over pixels. Per pixel, front to back:
  * the Gaussian takes part iff radius > 0 and the pixel's tile lies in
    its tile rect (what binning would emit);
  * vec = uv - pixel; power = -0.5(a vx^2 + c vy^2) - b vx vy;
  * skip if power > 0; alpha = min(0.99, opacity * exp(power) [+ bias]);
  * skip if alpha < 1/255; stop *without applying* when T(1 - alpha) < 1e-4;
  * F += feature * alpha * T; out = F + T_final * bg;
  * ncontrib counts applied Gaussians; the first `K_idx` applied ids are
    recorded (-1 padded).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class SplatOutput(NamedTuple):
    image: torch.Tensor             # [H, W, C] blended features (+ T * bg)
    final_T: torch.Tensor           # [H, W] final transmittance
    ncontrib: torch.Tensor          # [H, W] int32 applied-contribution count
    gs_idx: Optional[torch.Tensor]  # [H, W, K] int32 first-K ids or None


def splat_reference(
    uv, conic, opacity, features, depth, radius, rect_min, rect_max,
    W: int, H: int, bg, K_idx: int = 0, block=16,
) -> SplatOutput:
    """Blend all Gaussians into an [H, W, C] image, oracle path."""
    return _splat_impl(
        uv, conic, opacity, features, depth, radius, rect_min, rect_max,
        W, H, bg, K_idx, block, None,
    )


def splat_reference_with_bias(
    uv, conic, opacity, features, depth, radius, rect_min, rect_max,
    W: int, H: int, bg, opacity_bias, K_idx: int = 0, block=16,
) -> SplatOutput:
    """`alpha_blending_with_bias` variant: alpha = min(0.99, op*exp(power) + bias_g)."""
    return _splat_impl(
        uv, conic, opacity, features, depth, radius, rect_min, rect_max,
        W, H, bg, K_idx, block, opacity_bias,
    )


def _splat_impl(
    uv, conic, opacity, features, depth, radius, rect_min, rect_max,
    W, H, bg, K_idx, block, opacity_bias,
):
    dev = uv.device
    C = features.shape[1]
    order = torch.argsort(depth, stable=True)
    bx, by = block if isinstance(block, tuple) else (block, block)
    ys, xs = torch.meshgrid(
        torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij"
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    ptx = px // bx
    pty = py // by
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    P = px.shape[0]

    T = torch.ones(P, dtype=torch.float32, device=dev)
    F = torch.zeros(P, C, dtype=torch.float32, device=dev)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    cnt = torch.zeros(P, dtype=torch.int32, device=dev)
    gs_idx = torch.full((P, K_idx), -1, dtype=torch.int32, device=dev) if K_idx > 0 else None
    k_iota = torch.arange(K_idx, device=dev)

    for gi in order.tolist():
        inc = (
            (radius[gi] > 0)
            & (ptx >= rect_min[gi, 0])
            & (ptx < rect_max[gi, 0])
            & (pty >= rect_min[gi, 1])
            & (pty < rect_max[gi, 1])
        )
        vx = uv[gi, 0] - pxf
        vy = uv[gi, 1] - pyf
        power = -0.5 * (conic[gi, 0] * (vx * vx) + conic[gi, 2] * (vy * vy)) - conic[gi, 1] * vx * vy
        raw = opacity[gi] * torch.exp(power)
        if opacity_bias is not None:
            raw = raw + opacity_bias[gi]
        alpha = torch.clamp_max(raw, ALPHA_MAX)
        valid = inc & (power <= 0) & (alpha >= ALPHA_MIN) & ~done
        next_T = T * (1.0 - alpha)
        terminate = valid & (next_T < T_EPS)
        applied = valid & (next_T >= T_EPS)
        w = torch.where(applied, alpha * T, 0.0)
        F = F + w[:, None] * features[gi][None, :]
        T = torch.where(applied, next_T, T)
        done = done | terminate
        if gs_idx is not None:
            write = applied & (cnt < K_idx)
            sel = write[:, None] & (k_iota[None, :] == cnt[:, None])
            gs_idx = torch.where(sel, gi, gs_idx)
        cnt = cnt + applied.to(torch.int32)

    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    img = (F + T[:, None] * bg[None, :]).reshape(H, W, C)
    return SplatOutput(
        image=img,
        final_T=T.reshape(H, W),
        ncontrib=cnt.reshape(H, W),
        gs_idx=gs_idx.reshape(H, W, K_idx) if gs_idx is not None else None,
    )
