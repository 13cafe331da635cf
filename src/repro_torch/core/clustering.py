"""Confidence-based cluster aggregation (paper Alg. 2, Phases B + C).

Counterpart of ``repro/core/clustering.py``.  Cluster k collects the
class-k weight vectors of every client whose most confident class was k,
and averages them.  The sums go through ``index_add_``: the uploads are
integer-valued f32 vectors, so every partial sum is exact and the order
of the adds cannot change the result, and the mean's divide is correctly
rounded — bit-identical to the JAX one-hot product.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ClusterResult(NamedTuple):
    cluster_weights: torch.Tensor  # (C, m) per-cluster averaged vectors
    counts: torch.Tensor           # (C,) f32, |K_k| members per cluster
    assignment: torch.Tensor       # (n_clients,) cluster id per client


def aggregate(uploads: torch.Tensor, assignment: torch.Tensor,
              n_clusters: int,
              prev: torch.Tensor | None = None) -> ClusterResult:
    """uploads (n, m) f32 — each client's W[c_max]; assignment (n,).

    Ids outside [0, n_clusters) (−1 = "not shared") contribute nothing.
    Empty clusters keep ``prev`` (zeros without history), per Alg. 2."""
    valid = (assignment >= 0) & (assignment < n_clusters)
    ids = assignment[valid].long()
    sums = torch.zeros((n_clusters, uploads.shape[-1]), dtype=uploads.dtype,
                       device=uploads.device)
    sums.index_add_(0, ids, uploads[valid])
    counts = torch.bincount(ids, minlength=n_clusters).to(uploads.dtype)
    mean = sums / counts.clamp(min=1)[:, None]
    if prev is None:
        prev = torch.zeros_like(mean)
    cluster_weights = torch.where(counts[:, None] > 0, mean, prev)
    return ClusterResult(cluster_weights, counts, assignment)
