"""Confidence-based cluster aggregation (paper Alg. 2, Phases B + C).

Counterpart of ``repro/core/clustering.py``.  Cluster k collects the
class-k weight vectors of every client whose most confident class was k,
and averages them.  The reference sums with the one-hot product
``onehot.T @ uploads``; under a lossy codec the uploads are ``q·scale``,
not integers, so the order of the adds sets the result.  The sums here
run in row order, one row at a time into its cluster's row (no atomics,
no parallel scan), so they are the same bits on every device and every
run, and the mean's divide is correctly rounded on both.

Row order is XLA:CPU's order where its dot adds the rows one after
another: one cluster (any row count), and ten clusters of 17 to 300
features up to 110 rows.  Elsewhere XLA's dot sums the rows in another
order (four lanes at 16 features or fewer; another past 110 rows at 300
features), and a non-integer aggregate may differ in the last place:
``ROADMAP.md``, queue C, pinned by ``tests/test_torch_codec.py``.
Integer-valued uploads (the float32 wire) sum exactly in any order.
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
    # rows that share nothing add into a spare row, dropped at the end
    ids = torch.where(valid, assignment, n_clusters).long()
    sums = torch.zeros((n_clusters + 1, uploads.shape[-1]),
                       dtype=uploads.dtype, device=uploads.device)
    for r in range(uploads.shape[0]):
        row = ids[r:r + 1]
        sums[row] = sums[row] + uploads[r:r + 1]
    sums = sums[:n_clusters]
    counts = torch.bincount(ids, minlength=n_clusters + 1)[:n_clusters].to(
        uploads.dtype)
    mean = sums / counts.clamp(min=1)[:, None]
    if prev is None:
        prev = torch.zeros_like(mean)
    cluster_weights = torch.where(counts[:, None] > 0, mean, prev)
    return ClusterResult(cluster_weights, counts, assignment)
