"""Confidence-based cluster aggregation (paper Alg. 2, Phases B + C).

Counterpart of ``repro/core/clustering.py``.  Cluster k collects the
class-k weight vectors of every client whose most confident class was k,
and averages them.  The reference sums with the one-hot product
``onehot.T @ uploads``; under a lossy codec the uploads are ``q·scale``,
not integers, so the order of the adds sets the result.  The sums here
add one row at a time into its cluster's row (no atomics, no parallel
scan), so they are the same bits on every device and every run, and the
mean's divide is correctly rounded on both.

The order of the adds is XLA:CPU's, chosen from the shapes (clusters C,
rows n, features m) and never from the data, as read off this host's
XLA by ``tools/xla_dot_order.py``:

* **four lanes** (:func:`four_lanes`): the first ``n - n % 4`` rows in
  four lanes (row r into lane r mod 4, each lane in row order), the
  lanes reduced as ``(l0 + l1) + (l2 + l3)``, the last ``n % 4`` rows
  summed apart in row order and added last.  At 62 clusters of 2 to 16
  features for every n from 4 to 48 (but n = 5 at 6 or 8 features, which
  is row order), and for n a multiple of 4 up to 128 at 62 clusters of
  17 to 24, 33, 40, 48, 100, 200 or 300 features and at 10 clusters of
  2 to 16;
* **row order** everywhere else: XLA's order at one cluster (any row
  count) and at ten clusters of 17 to 300 features up to 108 rows.

Other shapes (other row counts at those widths, other cluster counts,
ten clusters past 108 rows) XLA sums in still other orders that are not
emulated: there a non-integer aggregate may differ in the last place
(``ROADMAP.md``, queue C item 4, pinned by ``tests/test_torch_codec.py``).
Integer-valued uploads (the float32 wire) sum exactly in any order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ClusterResult(NamedTuple):
    cluster_weights: torch.Tensor  # (C, m) per-cluster averaged vectors
    counts: torch.Tensor           # (C,) f32, |K_k| members per cluster
    assignment: torch.Tensor       # (n_clients,) cluster id per client


# feature counts at which 62 clusters take four lanes for n a multiple of 4
_WIDE_LANES_62 = frozenset(range(17, 25)) | {33, 40, 48, 100, 200, 300}


def four_lanes(n_clusters: int, n: int, m: int) -> bool:
    """Whether XLA:CPU's ``onehot.T @ uploads`` over n rows of m features
    into ``n_clusters`` clusters adds the rows in four lanes (module
    docstring); below 4 rows the two orders are the same."""
    if n < 4:
        return False
    if n_clusters == 62 and 2 <= m <= 16 and n <= 48:
        return not (n == 5 and m in (6, 8))
    if n % 4 or n > 128:
        return False
    if n_clusters == 62:
        return 2 <= m <= 16 or m in _WIDE_LANES_62
    return n_clusters == 10 and 2 <= m <= 16


def aggregate(uploads: torch.Tensor, assignment: torch.Tensor,
              n_clusters: int,
              prev: torch.Tensor | None = None) -> ClusterResult:
    """uploads (n, m) f32 — each client's W[c_max]; assignment (n,).

    Ids outside [0, n_clusters) (−1 = "not shared") contribute nothing.
    Empty clusters keep ``prev`` (zeros without history), per Alg. 2."""
    n, m = uploads.shape
    valid = (assignment >= 0) & (assignment < n_clusters)
    # rows that share nothing add into a spare row, dropped at the end
    ids = torch.where(valid, assignment, n_clusters).long()
    lanes = four_lanes(n_clusters, n, m)
    # lanes 0-3, and lane 4 for the rows past the last multiple of 4
    sums = torch.zeros((5 if lanes else 1, n_clusters + 1, m),
                       dtype=uploads.dtype, device=uploads.device)
    whole = n - n % 4
    for r in range(n):
        lane = (r % 4 if r < whole else 4) if lanes else 0
        row = ids[r:r + 1]
        sums[lane, row] = sums[lane, row] + uploads[r:r + 1]
    if lanes:
        sums = ((sums[0] + sums[1]) + (sums[2] + sums[3])) + sums[4]
    else:
        sums = sums[0]
    sums = sums[:n_clusters]
    counts = torch.bincount(ids, minlength=n_clusters + 1)[:n_clusters].to(
        uploads.dtype)
    mean = sums / counts.clamp(min=1)[:, None]
    if prev is None:
        prev = torch.zeros_like(mean)
    cluster_weights = torch.where(counts[:, None] > 0, mean, prev)
    return ClusterResult(cluster_weights, counts, assignment)
