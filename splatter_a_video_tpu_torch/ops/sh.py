"""Spherical-harmonics colour evaluation (counterpart of
`splatter_a_video_tpu/ops/sh.py`).

`eval_sh` adds the +0.5 DC offset and clamps negatives to zero (ReLU), as
the reference's `compute_sh.cu` does. The polynomial is written term for
term as in the JAX package so both round alike.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_bases(deg: int) -> int:
    return (deg + 1) ** 2


def _eval_sh_basis(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH polynomial: sh [..., K, C] (K >= (deg+1)^2), dirs [..., 3] -> [..., C]."""
    if not 0 <= deg <= 3:
        raise ValueError(f"deg must be in [0,3], got {deg}")
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4, :]
                + SH_C2[1] * yz * sh[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + SH_C2[3] * xz * sh[..., 7, :]
                + SH_C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor, visible=None) -> torch.Tensor:
    """SH [N, K, C] + view dirs [N, 3] -> ReLU(basis + 0.5) [N, C]; rows with
    `visible` false are zero.

    The ReLU is `torch.maximum`, whose gradient at a tie (a colour of
    exactly 0, e.g. a black pixel's init colour) is split 0.5 / 0.5 as
    JAX's `maximum` splits it; `clamp_min` would pass all of it."""
    basis = _eval_sh_basis(deg, sh, dirs) + 0.5
    colors = torch.maximum(basis, basis.new_zeros(()))
    if visible is not None:
        colors = colors * visible.reshape(sh.shape[0], 1).to(colors.dtype)
    return colors


def eval_sh_free(deg: int, sh: torch.Tensor, dirs: torch.Tensor, visible=None) -> torch.Tensor:
    """The raw basis [N, C], with no +0.5 offset and no clamp (the
    reference's `compute_sh_free.cu`, for non-colour feature fields); rows
    with `visible` false are zero."""
    out = _eval_sh_basis(deg, sh, dirs)
    if visible is not None:
        out = out * visible.reshape(sh.shape[0], 1).to(out.dtype)
    return out


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> DC SH coefficient."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """DC SH coefficient -> RGB (inverse of `rgb_to_sh`)."""
    return sh * SH_C0 + 0.5
