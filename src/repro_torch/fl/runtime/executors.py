"""Where a round's compute runs: in this process, or over a clients mesh.

Counterpart of ``repro/fl/runtime/executors.py``.  Client training, the
server-side assignment, the masked per-slot mean, broadcast-apply with
the merge that keeps non-receivers' old state, and evaluation each run
once for the whole stacked cohort (or block), whatever tree the client
state is; on the GPU the TM's training and evaluation are one kernel
launch per stage.

* :class:`InProcessExecutor`: every stage on the whole cohort, on the
  cohort's device.
* :class:`ShardMapExecutor` (the reference's name): the same stages over
  a ``torch.distributed`` group of ranks (a
  :class:`~repro_torch.launch.mesh.ClientsMesh`), one engine a rank.
  Every rank holds the same replicated state (the host work, the codec
  and the schedule are deterministic), takes its contiguous block of the
  cohort, trains, merges and evaluates it and makes the outputs whole
  again by collectives, so to the engine it behaves as ``shard_map``'s
  ``P(axis)`` in and out specs do.  Training gathers the uploads onto
  every rank (the engine's codec runs there), so the stages after it
  start from replicated tensors: ``assign`` and the async insert are
  the in-process calls on every rank.  The aggregation is one masked
  collective from :mod:`repro_torch.fl.masked_collectives`: that
  ``all_gather`` of the uploads followed by the in-process reduction
  (``gather``, bit for bit the in-process engine), or each rank's block
  folded into the (C, m) accumulator and one ``all_reduce`` of it
  (``psum``).  On the identity wire under a sync barrier
  with no ``assign`` hook the whole round is one executor call
  (:meth:`ShardMapExecutor.fused_sync_round`: train, aggregate, server
  update, broadcast-apply and evaluation on the block).  The population
  stays replicated: a rank's trained block (:class:`Shard`) stays with
  it until the merge, and the merged blocks are gathered once a round.

Padding: a cohort of K clients is cut into W blocks of ``ceil(K / W)``;
the last blocks are padded with inert rows (row 0 repeated for state,
data and keys; slot −1 and ``active=False`` for the masks) whose results
are trimmed, and the padding is trimmed from the reduction's shape too
(``n_valid``), so the sums add in the in-process order.

The async buffered update (:meth:`InProcessExecutor.async_update`) runs
as tensor ops on the buffer's device: :func:`buffer_insert`, the
maturity gate and the staleness-discounted mean
(:func:`async_gate_and_mean`), with nothing read back to the host
between them.  The buffer is six fixed-capacity lanes carried in the
engine state: payloads (cap, d) and slot id / maturity round /
staleness weight / validity / insertion order (cap,).  Over the mesh the
buffer is replicated: every rank replays the same insert of the gathered
uploads, and the mean is the host form (``gather``) or
:func:`~repro_torch.fl.masked_collectives.buffered_weighted_mean_sharded`
(``psum``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import clustering
from repro_torch.fl import masked_collectives
from repro_torch.fl.runtime.strategy import resolve_server_update

_INT32_MAX = 2 ** 31 - 1
COLLECTIVES = ("gather", "psum")


def applied_slots(slots: torch.Tensor, counts: torch.Tensor,
                  arrive: torch.Tensor) -> torch.Tensor:
    """The slots pushed back to each client this round: it arrived, it
    shared the slot, and the slot received an aggregate (a never-fed
    slot row must not overwrite fresh local training)."""
    fed = counts[slots.clamp(min=0).long()] > 0
    return torch.where(arrive[:, None] & (slots >= 0) & fed, slots, -1)


def evaluate_population(executor, strategy, gather_cs, gather_data,
                        n: int, chunk: int) -> torch.Tensor:
    """Every client's accuracy over a host-side client store, in chunks
    of ``chunk`` clients: the mmap engine's ``store_eval="full"``.

    ``gather_cs(ids)`` / ``gather_data(ids) -> (x_test, y_test)`` bring
    each chunk's rows to the device (store gather, streaming ingestion),
    so only ``chunk`` clients are resident at a time.  A client's
    accuracy depends on its own row and data alone, so the concatenated
    vector equals one evaluation of the whole population."""
    accs = []
    for c0 in range(0, n, chunk):
        ids = np.arange(c0, min(c0 + chunk, n), dtype=np.int64)
        cs = gather_cs(ids)
        x, y = gather_data(ids)
        accs.append(executor.evaluate(strategy, cs, x, y))
    return torch.cat(accs)


def _apply_merge(strategy, new_sub, applied, rx_server, old_sub, recv):
    """Phase D: each client takes the decoded rows of the slots applied
    to it; clients that receive nothing (dropped, late) go back to their
    state from before the round.  ``recv`` is None when every client of
    the cohort arrived: nothing goes back."""
    bc = strategy.apply_broadcast(new_sub, applied, rx_server)
    if recv is None:
        return bc
    return tree.map(lambda new, old: torch.where(
        recv.reshape((-1,) + (1,) * (new.ndim - 1)), new, old), bc, old_sub)


class InProcessExecutor:
    """Every stage is a call on the whole cohort, on the cohort's device."""

    def train(self, strategy, sub_cs, server, sub_data, keys):
        new_sub, upload = strategy.fused_client_step(sub_cs, server,
                                                     sub_data, keys)
        return new_sub, upload.vecs, upload.slots      # (K,j,d), (K,j)

    def assign(self, strategy, server, dec, slots, arrive):
        """The strategy's server-side assignment over the decoded uploads
        of the cohort: (K, j) slot ids."""
        return strategy.assign(server, dec, slots, arrive)

    def masked_mean(self, strategy, dec, slots, arrive):
        """The Alg. 2 masked mean over the uploads that arrived (slot −1
        contributes nothing); returns the raw per-slot mean (zeros where
        empty) and the counts — retention is the server update's
        decision."""
        masked = torch.where(arrive[:, None], slots, -1)
        res = clustering.aggregate(dec.reshape(-1, strategy.vec_dim),
                                   masked.reshape(-1), strategy.n_slots)
        return res.cluster_weights, res.counts

    def apply_merge(self, strategy, new_sub, applied, rx_server, old_sub,
                    recv):
        return _apply_merge(strategy, new_sub, applied, rx_server, old_sub,
                            recv)

    def evaluate(self, strategy, cs, x_test, y_test):
        return strategy.fused_evaluate(cs, x_test, y_test)

    def async_update(self, strategy, buf, up, round_idx, prev,
                     min_uploads: int, exact_products: bool = False):
        """Insert this round's uploads into the buffer and fold in the
        matured entries: ``(server rows, counts, n_agg, n_buffered,
        n_evicted, buf)``, the three counts as () int32 tensors."""
        buf, evicted = buffer_insert(buf, *up)
        server, counts, n_agg, n_buf, buf = async_gate_and_mean(
            buf, round_idx, strategy.n_slots, min_uploads, prev,
            exact_products)
        return server, counts, n_agg, n_buf, evicted, buf


# ---------------------------------------------------------------------------
# the async buffered update
# ---------------------------------------------------------------------------

def buffer_insert(buf, up_vecs, up_slots, up_ready, up_weight, up_valid):
    """Insert one round's uploads (those with ``up_valid``, in order) into
    the buffer: ``(new_buf, evicted)``.  The reference scans the uploads
    one at a time, each taking the first free lane or, when the buffer is
    full, evicting the oldest insertion.  Here in closed form:

    * the t-th inserted upload takes the t-th free lane, in ascending
      index;
    * past the ``n_free`` free lanes it takes lane
      ``E[(t − n_free) mod cap]``, where ``E`` is the valid lanes in
      ascending ``seq`` (the first index among equal ones) followed by
      the free lanes in fill order: each eviction's entry becomes the
      newest, so the order of the oldest cycles through ``E``;
    * the last writer of a lane wins, and ``evicted = max(0, n_ins −
      n_free)``.

    A few (U, cap) tensor ops, no atomics and no read-back."""
    vecs, slots, ready, weight, valid, seq = buf
    cap = valid.shape[0]
    dev = valid.device
    lanes = torch.arange(cap, device=dev)
    next_seq = torch.where(valid.any(),
                           torch.where(valid, seq, -1).max() + 1,
                           0).to(torch.int32)
    free = ~valid
    n_free = free.sum()
    # the free lanes first, in ascending index
    free_first = torch.sort(free.to(torch.int8), descending=True,
                            stable=True).indices
    by_age = torch.sort(torch.where(valid, seq, _INT32_MAX),
                        stable=True).indices
    n_valid = cap - n_free
    # E: valid lanes by age, then the free lanes in fill order
    pos = lanes - n_valid
    order = torch.where(lanes < n_valid, by_age,
                        free_first[pos.clamp(min=0)])
    ins = up_valid.to(torch.bool)
    t = torch.cumsum(ins.to(torch.int64), 0) - 1          # insert rank
    n_ins = ins.sum()
    over = (t - n_free).clamp(min=0) % cap
    target = torch.where(t < n_free, free_first[t.clamp(0, cap - 1)],
                         order[over])
    target = torch.where(ins, target, -1)
    # the last insert aimed at a lane wins it
    hits = target[:, None] == lanes[None, :]                # (U, cap)
    rank = torch.arange(target.shape[0], device=dev)
    winner = torch.where(hits, rank[:, None], -1).max(0).values
    hit = winner >= 0
    w = winner.clamp(min=0)
    new_buf = (
        torch.where(hit[:, None], up_vecs[w].to(vecs.dtype), vecs),
        torch.where(hit, up_slots[w].to(slots.dtype), slots),
        torch.where(hit, up_ready[w].to(ready.dtype), ready),
        torch.where(hit, up_weight[w].to(weight.dtype), weight),
        valid | hit,
        torch.where(hit, (next_seq + t[w]).to(seq.dtype), seq))
    evicted = (n_ins - n_free).clamp(min=0).to(torch.int32)
    return new_buf, evicted


def async_gate_and_mean(buf, round_idx, n_slots: int, min_uploads: int,
                        prev, exact_products: bool = False, mean_fn=None):
    """Maturity gate and staleness-discounted mean, with no host branch.

    An entry is mature once ``round_idx`` reaches its ready round; it
    contributes if its discount weight is nonzero.  Below
    ``min_uploads`` mature entries every slot id is masked to −1: the
    counts are zero, the server keeps ``prev`` row for row and the
    buffer is left as it is.  ``exact_products``: every weight is 0 or a
    power of two (``clustered_weighted_mean``).  ``mean_fn(vals, slots,
    weights)`` replaces the host form's mean (the mesh's ``psum``).
    Returns ``(server rows, counts, n_agg, n_buffered, new_buf)``."""
    vecs, slots, ready, weight, valid, seq = buf
    mature = valid & (ready <= round_idx)
    # zero-discount entries can never move the weighted mean: consumed,
    # not aggregated
    contrib = mature & (weight > 0.0)
    gate = mature.sum() >= min_uploads
    use = contrib & gate
    s = torch.where(use, slots, -1)
    w = torch.where(use, weight, 0.0)
    if mean_fn is None:
        mean = masked_collectives.clustered_weighted_mean(
            vecs, s, w, n_slots, exact_products)
    else:
        mean = mean_fn(vecs, s, w)
    counts = (s[:, None] == torch.arange(n_slots, device=s.device)
              ).to(torch.float32).sum(0)
    server = torch.where(counts[:, None] > 0, mean, prev)
    valid = torch.where(gate, valid & ~mature, valid)
    n_agg = torch.where(gate, contrib.sum(), 0).to(torch.int32)
    return (server, counts, n_agg, valid.sum().to(torch.int32),
            (vecs, slots, ready, weight, valid, seq))


# ---------------------------------------------------------------------------
# the shard-mapped executor: one block of the cohort a rank
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    """A rank's trained block of a K-client cohort, kept on the rank from
    ``train`` to ``apply_merge`` (the population is gathered once a
    round, after the merge)."""

    block: Any      # client-state tree, leading axis ceil(K / W)
    k: int          # the cohort's size


def _rows(a: torch.Tensor, k: int, blk: int, rank: int, fill=None):
    """This rank's ``blk`` rows of the first ``k`` rows of ``a``, padded
    past ``k`` with ``fill`` (or row 0, inert: its results are
    trimmed)."""
    lo, hi = min(rank * blk, k), min((rank + 1) * blk, k)
    part = a[lo:hi]
    pad = blk - (hi - lo)
    if not pad:
        return part
    if fill is None:
        tail = a[:1].expand((pad,) + tuple(a.shape[1:]))
    else:
        tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
    return torch.cat([part, tail])


class ShardMapExecutor(InProcessExecutor):
    """Every stage over the ranks of a clients mesh (module docstring):
    ``mesh`` is this rank's :class:`~repro_torch.launch.mesh.ClientsMesh`,
    a ``torch.distributed`` group; ``collective`` the aggregation's form,
    ``gather`` (bit for bit the in-process engine) or ``psum``.  The
    stages whose inputs are replicated (``assign``, the ``gather`` mean,
    the async insert) are the in-process ones."""

    def __init__(self, mesh, collective: str = "gather"):
        if collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {collective!r}")
        if mesh is None:
            raise ValueError(
                "backend='shardmap' runs over a clients process group: "
                "pass Engine(..., mesh=...) a ClientsMesh "
                "(repro_torch.launch.mesh.spawn builds one a rank)")
        self.mesh = mesh
        self.collective = collective
        self.n_shards = mesh.size

    # -- blocks -------------------------------------------------------------

    def _cut(self, k: int):
        """``(rows a block, padding rows)`` of a K-client cohort."""
        blk = -(-k // self.n_shards)
        return blk, blk * self.n_shards - k

    def _mine(self, t, k: int, blk: int, fill=None):
        return tree.map(lambda a: _rows(a, k, blk, self.mesh.rank, fill), t)

    def _whole(self, t, k: int, pad: int, label: str):
        """The ranks' blocks of ``t`` gathered in client order, trimmed
        to ``k``."""
        return tree.map(lambda a: a[:k], masked_collectives.all_gather_tree(
            self.mesh, t, label, pad_rows=pad))

    def _mean(self, strategy, vals, slots, n_valid: int):
        """This rank's block of uploads → the replicated raw per-slot
        mean and counts, by the executor's one collective."""
        if self.collective == "gather":
            return masked_collectives.clustered_mean_gathered(
                vals, slots, strategy.n_slots, self.mesh, n_valid=n_valid)
        return masked_collectives.clustered_weighted_mean_sharded(
            vals, slots, torch.ones(slots.shape, dtype=torch.float32,
                                    device=slots.device),
            strategy.n_slots, self.mesh, exact_products=True)

    # -- the stages -----------------------------------------------------------

    def train(self, strategy, sub_cs, server, sub_data, keys):
        """Train this rank's block; the uploads are gathered onto every
        rank (the engine's codec runs there: under ``gather`` this is
        the aggregation's collective), the trained block stays here."""
        k = keys.shape[0]
        blk, pad = self._cut(k)
        new_b, up = strategy.fused_client_step(
            self._mine(sub_cs, k, blk), server, self._mine(sub_data, k, blk),
            self._mine(keys, k, blk))
        label = "aggregate" if self.collective == "gather" else "uploads"
        vecs = self._whole(up.vecs, k, pad, label)
        slots = self._whole(up.slots, k, pad, "lanes")
        return Shard(new_b, k), vecs, slots

    def masked_mean(self, strategy, dec, slots, arrive):
        """``gather``: the in-process mean of the gathered uploads;
        ``psum``: this rank's block of them folded and all-reduced."""
        if self.collective == "gather":
            return super().masked_mean(strategy, dec, slots, arrive)
        k = dec.shape[0]
        blk, pad = self._cut(k)
        masked = torch.where(arrive[:, None], slots, -1)
        j = strategy.j_slots
        return self._mean(
            strategy, self._mine(dec, k, blk).reshape(-1, strategy.vec_dim),
            self._mine(masked, k, blk, -1).reshape(-1), k * j)

    def apply_merge(self, strategy, new_sub: Shard, applied, rx_server,
                    old_sub, recv):
        """Merge this rank's trained block, then gather the merged blocks:
        the population's one gather of a round."""
        k = new_sub.k
        blk, pad = self._cut(k)
        merged = _apply_merge(
            strategy, new_sub.block, self._mine(applied, k, blk, -1),
            rx_server, self._mine(old_sub, k, blk),
            None if recv is None else self._mine(recv, k, blk, False))
        return self._whole(merged, k, pad, "population")

    def evaluate(self, strategy, cs, x_test, y_test):
        n = x_test.shape[0]
        blk, pad = self._cut(n)
        acc = strategy.fused_evaluate(self._mine(cs, n, blk),
                                      self._mine(x_test, n, blk),
                                      self._mine(y_test, n, blk))
        return self._whole(acc, n, pad, "accuracy")

    def fused_sync_round(self, strategy, sub_cs, server, sub_data, keys,
                         arrive):
        """The whole sync round on the identity wire, one call: train the
        block, aggregate by the one collective, fold into the server
        (``server_update``, on every rank), apply and merge the block,
        evaluate it, and gather the merged blocks, their slots, applied
        slots and accuracies.  Returns ``(merged, server, counts,
        applied, acc, slots)``."""
        k = keys.shape[0]
        blk, pad = self._cut(k)
        j = strategy.j_slots
        arrive_b = self._mine(arrive, k, blk, False)
        cs_b, data_b = self._mine(sub_cs, k, blk), self._mine(sub_data, k, blk)
        new_b, up = strategy.fused_client_step(
            cs_b, server.slots, data_b, self._mine(keys, k, blk))
        masked = torch.where(arrive_b[:, None], up.slots, -1)
        agg, counts = self._mean(strategy,
                                 up.vecs.reshape(-1, strategy.vec_dim),
                                 masked.reshape(-1), k * j)
        server = resolve_server_update(strategy)(server, agg, counts)
        applied_b = applied_slots(up.slots, counts, arrive_b)
        merged_b = _apply_merge(strategy, new_b, applied_b, server.slots,
                                cs_b, arrive_b)
        acc_b = strategy.fused_evaluate(merged_b, data_b.x_test,
                                        data_b.y_test)
        merged = self._whole(merged_b, k, pad, "population")
        return (merged, server, counts,
                self._whole(applied_b, k, pad, "lanes"),
                self._whole(acc_b, k, pad, "accuracy"),
                self._whole(up.slots, k, pad, "lanes"))

    def async_update(self, strategy, buf, up, round_idx, prev,
                     min_uploads: int, exact_products: bool = False):
        """The async buffered update on the replicated buffer and
        uploads: the in-process insert, gate and mean (``gather``), or
        the insert and gate with the buffer's ``psum`` mean."""
        if self.collective == "gather":
            return super().async_update(strategy, buf, up, round_idx, prev,
                                        min_uploads, exact_products)
        buf, evicted = buffer_insert(buf, *up)

        def mean_fn(v, s, w):
            return masked_collectives.buffered_weighted_mean_sharded(
                v, s, w, strategy.n_slots, self.mesh, exact_products)[0]

        server, counts, n_agg, n_buf, buf = async_gate_and_mean(
            buf, round_idx, strategy.n_slots, min_uploads, prev,
            exact_products, mean_fn)
        return server, counts, n_agg, n_buf, evicted, buf


class RankZeroStore:
    """The mmap client store on a clients mesh.  As in the reference, the
    store sits outside the sharded program: rank 0 holds the
    :class:`~repro_torch.fl.store.ClientStore` (``store``; ``None`` on the
    other ranks), reads the cohort's rows, spills and flushes; the rows
    reach the other ranks by ``broadcast`` (``template``: a row's tree of
    numpy arrays, for their shapes), and so do the I/O meters, so every
    rank's report reads the same."""

    def __init__(self, mesh, store, template):
        self.mesh = mesh
        self.store = store
        self.template = template
        self.io_read_bytes = self.io_written_bytes = 0

    def __getattr__(self, name):
        # rank 0's store answers the rest (manifest, written_count, ...)
        store = self.__dict__.get("store")
        if store is None:
            raise AttributeError(name)
        return getattr(store, name)

    def _sync_meters(self) -> None:
        local = (self.store.io_read_bytes, self.store.io_written_bytes) \
            if self.store is not None else (0, 0)
        t = masked_collectives.broadcast(
            self.mesh, torch.tensor(local, dtype=torch.int64,
                                    device=self.mesh.device), "store")
        self.io_read_bytes, self.io_written_bytes = (int(v) for v in t)

    def gather(self, ids):
        from repro_torch.fl.store import client_store
        ids = np.asarray(ids)
        if self.store is not None:
            rows = self.store.gather(ids)
        else:
            rows = client_store.tree_map(
                lambda a: np.zeros((ids.size,) + a.shape, a.dtype),
                self.template)
        leaves, unflatten = client_store.flatten(rows)
        dev = self.mesh.device
        out = [masked_collectives.broadcast(
            self.mesh, torch.from_numpy(np.ascontiguousarray(a)).to(dev),
            "store").cpu().numpy() for a in leaves]
        self._sync_meters()
        return unflatten(out)

    def spill(self, ids, rows) -> None:
        if self.store is not None:
            self.store.spill(ids, rows)
        self._sync_meters()

    def flush(self) -> None:
        if self.store is not None:
            self.store.flush()
