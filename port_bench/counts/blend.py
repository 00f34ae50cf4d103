"""Operations and bytes of the blend kernels (K1 forward, K3 backward, K4
per-Gaussian sums), counted as `chip_smoke.blend_cost` counts them: each
input read once and each output written once, and the work these inputs
need. `tests` are the slot-pixel tests the tiles needed (each tile's slots
up to the one where its last pixel stopped, against its pixels inside the
frame), `applied` the pairs that blended; `gaussians` the Gaussians that
own a slot.
"""

from __future__ import annotations

from . import peaks


def k1(tests: int, applied: int, nint: int, tiles: int, gaussians: int, pixels: int, C: int):
    """(operations, bytes) of one K1 launch."""
    nbytes = 4 * nint + 4 * (tiles + 1) + gaussians * (8 + 12 + 4 + 4 * C) + 4 * C + pixels * (C + 2) * 4
    return tests * 15 + applied * 2 * C, nbytes


def k3(tests: int, applied: int, nint: int, tiles: int, gaussians: int, pixels: int, C: int):
    """(operations, bytes) of one K3 launch: K1's replay, then per applied
    pair the gradient terms of 8 + C rows."""
    R = 8 + C
    nbytes = (4 * nint + 4 * (tiles + 1) + gaussians * (8 + 12 + 4 + 4 * C) + 8 * C + pixels * (2 * C + 1) * 4
              + nint * R * 4)
    return tests * 15 + applied * (40 + 5 * C + R), nbytes


def k4(nint: int, C: int) -> int:
    """Operations of one K4 launch: one add per slot row element."""
    return nint * (8 + C)


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card needs: operations or bytes, whichever bounds."""
    return max(ops / peaks.FP32_FLOPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
