"""Cluster-masked reductions: the in-process form and the sharded forms
over a clients process group.

Counterpart of ``repro/fl/masked_collectives.py``.  The async engine
folds its matured buffer entries into the server with
:func:`clustered_weighted_mean`; the shard-mapped executor
(``backend="shardmap"``) aggregates through the sharded forms below,
each one masked collective over the ``clients`` group of a
:class:`~repro_torch.launch.mesh.ClientsMesh`.

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

The sharded forms (the reference's run inside ``shard_map``; here each
rank of the group calls them with its own block):

* :func:`clustered_mean_gathered`: one ``all_gather`` of the blocks
  reassembles the uploads in client order on every rank, trimmed to
  ``n_valid``, then :func:`repro_torch.core.clustering.aggregate`, the
  in-process engine's reduction on the same values and shape: bit for
  bit the in-process result;
* :func:`clustered_weighted_mean_sharded`: each rank folds its block
  into a (C, m) partial sum and its (C,) weight totals, and one
  ``all_reduce`` of the (C, m + 1) accumulator gives every slot's mean:
  C·(m + 1) floats a rank whatever the number of uploads.  Exact where
  the products and sums are (integer uploads, power-of-two weights);
  elsewhere the ranks' partial sums add in another order than the host
  form's, so it is close, not equal, as in the reference;
* :func:`buffered_weighted_mean_sharded`: the async buffer's lanes are
  replicated; each rank takes its block of ``ceil(cap / W)`` rows (the
  tail padded with slot −1, weight 0) and reduces as above;
* :func:`clustered_mean_sharded`: one client a rank, its upload folded
  into the (C, m) accumulator; returns its cluster's mean.

:func:`all_gather`, :func:`all_reduce` and :func:`broadcast` are the
collectives the executor runs, on the tensors' own device (a group that
refuses a CUDA tensor is refused when the mesh is built:
``make_clients_mesh``).  Each meters what it moves into the mesh's
:class:`CollectiveMeter` under a label (the bytes landing on each rank,
padding rows apart, and the call's time).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch import tree, xla_f32
from repro_torch.core import clustering


def collective_payload_bytes(collective: str, n_uploads: int, dim: int,
                             n_clusters: int) -> int:
    """Per-rank payload bytes of the aggregation collective, the gauge the
    run manifest records (pure arithmetic, the reference's):

    * ``gather``: the full (n_uploads, dim) float32 matrix lands on each
      rank;
    * ``psum``: one all-reduce of the (n_clusters, dim) accumulator and
      its (n_clusters,) weight totals, whatever the number of uploads."""
    if collective == "gather":
        return 4 * n_uploads * dim
    if collective == "psum":
        return 4 * n_clusters * (dim + 1)
    raise ValueError(f"unknown collective {collective!r}")


# ---------------------------------------------------------------------------
# the in-process form
# ---------------------------------------------------------------------------

def _weighted_sums(vals: torch.Tensor, assignment: torch.Tensor,
                   weights: torch.Tensor, n_clusters: int,
                   exact_products: bool):
    """``(Σ wᵢ·vᵢ (C, m), Σ wᵢ (C,))`` per cluster over flattened values,
    in the order the module docstring gives."""
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
    return sums, xla_f32.reduce_sum(onehot.T)


def _mean(sums: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return xla_f32.ftz(sums / torch.clamp(total, min=1e-9)[:, None])


def clustered_weighted_mean(vals: torch.Tensor, assignment: torch.Tensor,
                            weights: torch.Tensor, n_clusters: int,
                            exact_products: bool = False) -> torch.Tensor:
    """Per-cluster weighted mean, the async-runtime form.

    vals: (n, ...), assignment: (n,) (−1 = masked out), weights: (n,)
    staleness discounts (0 also masks).  Returns (n_clusters, ...) of
    Σ wᵢ·vᵢ / Σ wᵢ per cluster (0 where no weight landed).
    ``exact_products``: the caller knows every weight is 0 or a power
    of two, so the products need no fused rounding."""
    sums, total = _weighted_sums(vals, assignment, weights, n_clusters,
                                 exact_products)
    return _mean(sums, total).reshape((n_clusters,) + tuple(vals.shape[1:]))


# ---------------------------------------------------------------------------
# the collectives, metered
# ---------------------------------------------------------------------------

class CollectiveMeter:
    """Bytes each labelled collective moved onto this rank, the padding
    rows' share apart (``pad``), the calls, and their ``seconds`` (host
    clock around the call, a card synced after it)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: dict[str, int] = {}
        self.pad: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.seconds: dict[str, float] = {}

    def add(self, label: str, nbytes: int, pad: int = 0,
            seconds: float = 0.0) -> None:
        self.bytes[label] = self.bytes.get(label, 0) + int(nbytes)
        self.pad[label] = self.pad.get(label, 0) + int(pad)
        self.calls[label] = self.calls.get(label, 0) + 1
        self.seconds[label] = self.seconds.get(label, 0.0) + seconds

    def payload(self, label: str) -> int:
        """The label's bytes without its padding rows."""
        return self.bytes.get(label, 0) - self.pad.get(label, 0)

    def snapshot(self) -> dict:
        return {"bytes": dict(self.bytes), "pad": dict(self.pad),
                "calls": dict(self.calls), "seconds": dict(self.seconds)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _clock(t: torch.Tensor) -> float:
    """The host clock, once ``t``'s card has finished its work."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def all_gather(mesh, t: torch.Tensor, label: str,
               pad_rows: int = 0) -> torch.Tensor:
    """Every rank's block of ``t`` (equal shapes), concatenated in rank
    order along the leading axis, on every rank; ``pad_rows`` of the
    result are padding (metered apart)."""
    dtype = t.dtype
    t0 = _clock(t)
    src = t.contiguous()
    if dtype == torch.bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    row = _nbytes(src) // max(src.shape[0], 1) if src.ndim else 0
    mesh.meter.add(label, _nbytes(out), pad=pad_rows * row,
                   seconds=_clock(out) - t0)
    return out.to(dtype)


def all_gather_tree(mesh, blocks, label: str, pad_rows: int = 0):
    return tree.map(lambda a: all_gather(mesh, a, label, pad_rows), blocks)


def all_reduce(mesh, t: torch.Tensor, label: str) -> torch.Tensor:
    """The sum of every rank's ``t`` on every rank (a new tensor)."""
    t0 = _clock(t)
    out = t.contiguous().clone()
    dist.all_reduce(out, group=mesh.group)
    mesh.meter.add(label, _nbytes(out), seconds=_clock(out) - t0)
    return out


def broadcast(mesh, t: torch.Tensor, label: str) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (``t`` gives the others the shape
    and dtype; a new tensor)."""
    dtype = t.dtype
    t0 = _clock(t)
    buf = t.contiguous().clone()
    if dtype == torch.bool:
        buf = buf.to(torch.uint8)
    dist.broadcast(buf, src=mesh.src, group=mesh.group)
    mesh.meter.add(label, _nbytes(buf), seconds=_clock(buf) - t0)
    return buf.to(dtype)


# ---------------------------------------------------------------------------
# the sharded forms
# ---------------------------------------------------------------------------

def clustered_mean_gathered(local_vals: torch.Tensor,
                            local_slots: torch.Tensor, n_clusters: int,
                            mesh, n_valid: int | None = None):
    """This rank's block of uploads ``(k_local, m)`` and slot ids
    ``(k_local,)`` (−1 = masked out) → the raw (C, m) per-slot means
    (zeros where empty) and the (C,) counts, on every rank: one
    ``all_gather`` a lane, the first ``n_valid`` rows (the rest pad the
    blocks to equal size) through ``clustering.aggregate``, the
    in-process reduction on the same values and shape, bit for bit."""
    blk = local_vals.shape[0]
    pad = 0 if n_valid is None else blk * mesh.size - n_valid
    vals = all_gather(mesh, local_vals, "aggregate", pad_rows=pad)
    slots = all_gather(mesh, local_slots, "lanes", pad_rows=pad)
    if n_valid is not None:
        vals, slots = vals[:n_valid], slots[:n_valid]
    res = clustering.aggregate(vals, slots, n_clusters)
    return res.cluster_weights, res.counts


def clustered_weighted_mean_sharded(local_vals: torch.Tensor,
                                    local_slots: torch.Tensor,
                                    local_weights: torch.Tensor,
                                    n_clusters: int, mesh,
                                    exact_products: bool = False):
    """Weighted per-slot mean by one masked ``all_reduce``: this rank's
    block folded into a (C, m) partial sum weighted by ``local_weights``
    (0 masks, as does slot −1) and its (C,) weight totals, reduced over
    the group as one (C, m + 1) accumulator.  Returns ``(means,
    total_weight)`` on every rank, means 0 where no weight landed."""
    sums, total = _weighted_sums(local_vals, local_slots, local_weights,
                                 n_clusters, exact_products)
    acc = all_reduce(mesh, torch.cat([sums, total[:, None]], 1),
                     "aggregate")
    return _mean(acc[:, :-1], acc[:, -1]), acc[:, -1]


def buffered_weighted_mean_sharded(vals: torch.Tensor, slots: torch.Tensor,
                                   weights: torch.Tensor, n_clusters: int,
                                   mesh, exact_products: bool = False):
    """The async buffer's staleness-discounted mean: ``vals`` (cap, m),
    ``slots``, ``weights`` are the replicated lanes; this rank reduces
    its block of ``ceil(cap / W)`` rows (the tail padded with slot −1 and
    weight 0, which the mask ignores) through
    :func:`clustered_weighted_mean_sharded`.  Returns ``(means,
    total_weight)`` on every rank."""
    cap = vals.shape[0]
    blk = -(-cap // mesh.size)
    lo, hi = min(mesh.rank * blk, cap), min((mesh.rank + 1) * blk, cap)
    pad = blk - (hi - lo)
    v, s, w = vals[lo:hi], slots[lo:hi], weights[lo:hi]
    if pad:
        v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        s = torch.cat([s, s.new_full((pad,), -1)])
        w = torch.cat([w, w.new_zeros((pad,))])
    return clustered_weighted_mean_sharded(v, s, w, n_clusters, mesh,
                                           exact_products)


def clustered_mean_sharded(local_val: torch.Tensor, my_cluster: torch.Tensor,
                           n_clusters: int, mesh) -> torch.Tensor:
    """One client a rank: its upload (m,) and cluster id → its cluster's
    new mean (m,), by one ``all_reduce`` of the (C, m + 1) accumulator
    (the masked all-reduce that replaces the server round trip)."""
    onehot = (my_cluster.long() == torch.arange(
        n_clusters, device=local_val.device)).to(torch.float32)
    contrib = onehot[:, None] * local_val.to(torch.float32)[None, :]
    acc = all_reduce(mesh, torch.cat([contrib, onehot[:, None]], 1),
                     "aggregate")
    means = acc[:, :-1] / torch.clamp(acc[:, -1], min=1.0)[:, None]
    return means[my_cluster.long()]
