"""Brute-force k-nearest neighbours (counterpart of
`splatter_a_video_tpu/ops/knn.py`).

Distances are |q|^2 + |p|^2 - 2 q.p^T, one matmul per chunk of queries,
then `torch.topk`; at 131k points no [N, N] matrix is ever formed.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pairwise_sq_dists(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[Q,3] x [N,3] -> [Q,N] squared euclidean distances, floored at 0."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    pp = torch.sum(p * p, dim=-1)[None, :]
    return torch.clamp_min(qq + pp - 2.0 * (q @ p.T), 0.0)


def sq_dists_fma(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """|q - p|^2 over the last axis (3) of broadcastable q and p, with the
    bits of `_pairwise_sq_dists` on a CPU (|q|^2 + |p|^2 - 2 q.p, whose
    GEMM there rounds the 3-term dot as the chain fma(q2, p2, fma(q1, p1,
    q0 p0)), as XLA's does) on every device. Each fused multiply-add is
    formed in float64, where the product of two float32s is exact, then
    rounded to float32 (a double rounding that differs from one fused
    rounding only at exact halfway cases). cuBLAS splits the dot
    otherwise, so a GEMM on the card can swap two neighbours at a near-tie
    that the CPU orders the other way."""
    dot = q[..., 0] * p[..., 0]
    for i in (1, 2):
        wide = q[..., i].double() * p[..., i].double()
        wide += dot
        dot = wide.float()
    sq = lambda x: (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    return torch.clamp_min(sq(q) + sq(p) - 2.0 * dot, 0.0)


def smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices [S, k] of the k smallest entries of each row of d2
    [S, N], ordered by value and, among equal values, by descending index:
    the same on every device. (`torch.topk` picks and orders equal values
    in an order of its own, on the card another than on the CPU.) Of the
    orders that are the same everywhere, this one stays nearest the JAX
    package's own fit on the lifted points' exact ties
    (`tests/test_torch_fit.py::test_fit_end_state_matches`)."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False)   # the values are the same on every device
    thr = vals[:, -1:]                           # the k-th smallest value of each row
    n_less = (vals < thr).sum(1, keepdim=True)   # every entry below it is among the k
    cols = torch.arange(d2.shape[1], dtype=torch.int32, device=d2.device)
    tied = torch.topk(torch.where(d2 == thr, cols, -1), k, dim=1).values.long()   # highest first
    j = torch.arange(k, device=d2.device)[None, :]
    out = torch.where(j < n_less, idx, torch.gather(tied, 1, (j - n_less).clamp_min(0)))
    # canonical order: descending index, then a stable sort by value
    out = torch.sort(out, dim=1, descending=True).values
    order = torch.sort(torch.gather(d2, 1, out), dim=1, stable=True).indices
    return torch.gather(out, 1, order)


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of `query` among `points`: (sq_dists [Q,k],
    idx [Q,k]) ascending. When query is points, slot 0 is the point itself.
    Tiny clouds (k > N) pad with +inf and the last index."""
    N = points.shape[0]
    k_eff = min(k, N)
    ds, idxs = [], []
    for s in range(0, query.shape[0], chunk):
        neg, idx = torch.topk(-_pairwise_sq_dists(query[s : s + chunk], points), k_eff, dim=1)
        ds.append(-neg)
        idxs.append(idx)
    d = torch.cat(ds) if ds else query.new_zeros((0, k_eff))
    idx = torch.cat(idxs) if idxs else torch.zeros((0, k_eff), dtype=torch.int64, device=query.device)
    if k_eff < k:
        d = torch.cat([d, d.new_full((d.shape[0], k - k_eff), float("inf"))], dim=1)
        idx = torch.cat([idx, idx[:, -1:].expand(-1, k - k_eff)], dim=1)
    return d, idx


def mean_knn3_sq_dist(points: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest neighbours
    (self excluded): the scale initialisation of `create_scene`."""
    if points.shape[0] < 2:
        return torch.full((points.shape[0],), 1e-4, dtype=torch.float32, device=points.device)
    d, _ = knn(points, points, k=4, chunk=chunk)
    d = torch.where(torch.isfinite(d), d, 0.0)
    return d[:, 1:4].sum(dim=-1) / min(points.shape[0] - 1, 3)
