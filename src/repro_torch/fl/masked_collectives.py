"""Cluster-masked reductions: the in-process form.

Counterpart of ``repro/fl/masked_collectives.py``'s host forms.  The
async engine folds its matured buffer entries into the server with
:func:`clustered_weighted_mean`; the sharded forms (``all_gather`` /
``psum`` over a clients mesh) come with the multi-device slice
(ROADMAP.md, queue A8).

The reference computes ``Σ wᵢ·vᵢ`` as the product of the values with a
weighted one-hot, ``einsum("n...,nk->k...", vals, onehot·w)``, and
``Σ wᵢ`` as the one-hot's column sum.  XLA:CPU adds the dot's rows one
after another, each multiply fused into its add (one rounding a row:
``xla_f32.fma``), and sums a column in its reduction order
(``xla_f32.reduce_sum``); the divide is a true division.  Both are
emulated here, so the mean is the reference's bits at every weight and
value (held from 5 to 128 rows, 1 to 10 clusters and 16 to 101,770
features by ``tests/test_torch_async.py``).  Where every weight
is 0 or a power of two (a discount of 0.5, the default, or 0.25, …)
each product is exact in float64, and one float64 add rounded to float32
rounds the fused result once (the product and the sum fit 53 bits
wherever the smaller could move a float32 rounding): ``exact_products=
True`` takes that form, a handful of launches a row instead of the
emulated FMA's two dozen.  XLA:CPU runs with flush-to-zero and
denormals-are-zero, so the values are flushed on the way in and every
row's sum and the mean on the way out, in both forms
(:func:`repro_torch.xla_f32.ftz`): tiny values and products would
otherwise leave subnormals the reference never holds.  Rows are added
in row order, one at a time (no atomics), so the card gives the CPU's
bits too.
"""
from __future__ import annotations

import torch

from repro_torch import xla_f32


def clustered_weighted_mean(vals: torch.Tensor, assignment: torch.Tensor,
                            weights: torch.Tensor, n_clusters: int,
                            exact_products: bool = False) -> torch.Tensor:
    """Per-cluster weighted mean, the async-runtime form.

    vals: (n, ...), assignment: (n,) (−1 = masked out), weights: (n,)
    staleness discounts (0 also masks).  Returns (n_clusters, ...) of
    Σ wᵢ·vᵢ / Σ wᵢ per cluster (0 where no weight landed).
    ``exact_products``: the caller knows every weight is 0 or a power
    of two, so the products need no fused rounding."""
    n = vals.shape[0]
    flat = xla_f32.ftz(vals.reshape(n, -1).to(torch.float32))
    ids = assignment.long()
    onehot = (ids[:, None] == torch.arange(
        n_clusters, device=ids.device)[None, :]).to(torch.float32)
    onehot = onehot * weights.to(torch.float32)[:, None]        # (n, C)
    sums = torch.zeros((n_clusters, flat.shape[1]), dtype=torch.float32,
                       device=flat.device)
    if exact_products:
        flat64, onehot64 = flat.to(torch.float64), onehot.to(torch.float64)
    for r in range(n):
        if exact_products:
            fused = (sums.to(torch.float64) + flat64[r][None, :]
                     * onehot64[r][:, None]).to(torch.float32)
        else:
            fused = xla_f32.fma(flat[r][None, :], onehot[r][:, None], sums)
        sums = xla_f32.ftz(fused)
    total = xla_f32.reduce_sum(onehot.T)
    mean = xla_f32.ftz(sums / torch.clamp(total, min=1e-9)[:, None])
    return mean.reshape((n_clusters,) + tuple(vals.shape[1:]))
