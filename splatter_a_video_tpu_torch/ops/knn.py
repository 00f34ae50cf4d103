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
