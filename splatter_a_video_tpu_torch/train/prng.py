"""JAX's default random numbers in PyTorch (the threefry2x32 counter-based
generator with `jax_threefry_partitionable`, JAX's default), so that the
port draws the ARAP samples and the split children's noise that the JAX
package draws from the same seed.

A key is a CPU int64 tensor [2] holding two uint32 words, as
`jax.random.PRNGKey(seed)` does. The bits are computed on the host in
numpy (a few hundred thousand words at a density event, a few hundred per
step) and the values go to the caller's device. What is exact and what is
not:

  * `key`, `split`, `random_bits`, `randint` and `uniform` are bit for
    bit JAX's (XLA fuses uniform's scale and shift into one fused
    multiply-add, done here in float64 and rounded once);
  * `normal` applies XLA's single-precision erfinv polynomial (Giles,
    fused multiply-adds emulated the same way) to the same uniforms; its
    log1p may differ from XLA's, which leaves ~1% of the draws a few ulps
    off;
  * `choice` with probabilities inverts float32 prefix sums formed
    exactly (`prefix_sums`), where JAX adds in float32, so a draw that
    lands within rounding of a bin edge may pick the neighbouring index
    (rare: a bin edge within ~1e-7 of a uniform draw).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import to_device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 32-bit seeds (JAX without x64):
    words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & 0xFFFFFFFF], dtype=torch.int64)


def threefry2x32(k: torch.Tensor, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the count pairs (x0, x1) (uint32 arrays)
    under key k: 20 rounds in five groups of four, in numpy's wrapping
    uint32 arithmetic."""
    k0, k1 = (int(v) for v in k.tolist())
    ks = [np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _hash_iota(k: torch.Tensor, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """threefry2x32 of the 64-bit counts 0 .. n - 1 (high words 0)."""
    lo = np.arange(n, dtype=np.uint32)
    return threefry2x32(k, np.zeros_like(lo), lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: [num, 2] new keys."""
    b0, b1 = _hash_iota(k, num)
    return torch.from_numpy(np.stack([b0, b1], axis=1).astype(np.int64))


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element (uint32)."""
    b0, b1 = _hash_iota(k, int(np.prod(shape)))
    return (b0 ^ b1).reshape(tuple(shape))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors with one rounding (the float64 product
    of two float32s is exact)."""
    return (a.double() * b.double() + c.double()).float()


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32: 23 random mantissa bits of a float
    in [1, 2), minus 1, scaled to [minval, maxval)."""
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = torch.from_numpy(bits.view(np.float32)) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def randint(k: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint` for int32 results: two words per draw reduced
    modulo the span with uint32 wrap-around, as JAX computes it."""
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape).astype(np.uint64), random_bits(k2, shape).astype(np.uint64)
    span = np.uint64(max(int(maxval) - int(minval), 1))
    mult = np.uint64(((1 << 16) % int(span)) ** 2 % int(span))
    mask = np.uint64(0xFFFFFFFF)
    off = (((hi % span) * mult) & mask) + (lo % span)
    return torch.from_numpy((int(minval) + ((off & mask) % span).astype(np.int64)))


_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                  -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                  -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv: Giles' polynomial in w = -log1p(-x^2)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, torch.tensor(_ERFINV_W_LT_5[i], dtype=torch.float32),
                                 torch.tensor(_ERFINV_W_GE_5[i], dtype=torch.float32))
    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) erfinv(u), u uniform in
    (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32) * _erfinv(u)


def prefix_sums(p: torch.Tensor) -> torch.Tensor:
    """Float32 prefix sums of the probabilities p [n] (entries in [0, 1]),
    with the same bits in every run and on every device: the sums are
    formed exactly in int64 fixed point of 2^-(62 - bit_length(n)), then
    rounded. (`torch.cumsum` of floats on the card adds in an order that
    changes from run to run.) Entries of at least 2^-(38 - bit_length(n))
    are exact in that fixed point; smaller ones lose their low bits."""
    frac_bits = 62 - max(p.shape[0].bit_length(), 1)
    fixed = torch.floor(p.to(torch.float64) * 2.0**frac_bits).to(torch.int64)
    return (torch.cumsum(fixed, 0).to(torch.float64) * 2.0**-frac_bits).to(torch.float32)


def choice(k: torch.Tensor, n: int, shape: Sequence[int], p: torch.Tensor) -> torch.Tensor:
    """`jax.random.choice(k, n, shape, replace=True, p=p)`: int64 indices
    on p's device, drawn by inverting the prefix sums of the probabilities
    p (`prefix_sums`)."""
    if tuple(p.shape) != (n,):
        raise ValueError(f"p has shape {tuple(p.shape)}, expected ({n},)")
    p_cuml = prefix_sums(p)
    r = p_cuml[-1] * (1.0 - to_device(uniform(k, shape), p.device))
    return torch.searchsorted(p_cuml, r)

