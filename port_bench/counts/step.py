"""Float32 operations one train step needs, from the cell's shapes and the
slots its blends walked. A lower bound: each part counts the arithmetic its
algorithm needs, not what an implementation spends (SSIM's separable
11-tap blur, not a dense banded product; no sort or selection counted).

  * the blend: K1, K3 and K4 (`blend.py`) on the slots walked;
  * SSIM: five blurs forward and three backward, 2 x 11 multiply-adds a
    pixel, channel and pass (two passes), plus ~60 operations of the map a
    pixel and channel forward and backward;
  * the other image losses: ~30 operations a pixel and channel;
  * per Gaussian slot: trajectory, projection, SH, covariance and EWA,
    ~400 forward and ~800 backward;
  * ARAP: the sampled points' distances to every slot, ~10 operations each;
  * Adam: ~12 operations per parameter element.
"""

from __future__ import annotations

from . import blend


def step_ops(tests: int, applied: int, nint: int, C: int, pixels: int, capacity: int, param_elems: int,
             arap_samples: int) -> float:
    k1, _ = blend.k1(tests, applied, nint, 0, 0, pixels, C)
    k3, _ = blend.k3(tests, applied, nint, 0, 0, pixels, C)
    ssim = pixels * 3 * (8 * 2 * 11 * 2 + 60)
    losses = pixels * C * 30
    gauss = capacity * 1200
    arap = arap_samples * capacity * 10
    adam = param_elems * 12
    return float(k1 + k3 + blend.k4(nint, C) + ssim + losses + gauss + arap + adam)
