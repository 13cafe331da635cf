"""Where a round's compute runs: in this process, on one device.

Counterpart of the in-process half of ``repro/fl/runtime/executors.py``.
Client training, the server-side assignment, the masked per-slot mean,
broadcast-apply with the merge that keeps non-receivers' old state, and
evaluation each run once for the whole stacked cohort, whatever tree
the client state is; on the GPU the TM's training and evaluation are
one kernel launch per stage.  The
shard-mapped executor becomes ``torch.distributed`` in a later slice.

The async buffered update (:meth:`InProcessExecutor.async_update`) runs
as tensor ops on the buffer's device: :func:`buffer_insert`, the
maturity gate and the staleness-discounted mean
(:func:`async_gate_and_mean`), with nothing read back to the host
between them.  The buffer is six fixed-capacity lanes carried in the
engine state: payloads (cap, d) and slot id / maturity round /
staleness weight / validity / insertion order (cap,).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import clustering
from repro_torch.fl import masked_collectives

_INT32_MAX = 2 ** 31 - 1


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
        """Phase D: each client takes the decoded rows of the slots
        applied to it; clients that receive nothing (dropped, late)
        go back to their state from before the round.  ``recv`` is None
        when every client of the cohort arrived: nothing goes back."""
        bc = strategy.apply_broadcast(new_sub, applied, rx_server)
        if recv is None:
            return bc
        return tree.map(lambda new, old: torch.where(
            recv.reshape((-1,) + (1,) * (new.ndim - 1)), new, old),
            bc, old_sub)

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
                        prev, exact_products: bool = False):
    """Maturity gate and staleness-discounted mean, with no host branch.

    An entry is mature once ``round_idx`` reaches its ready round; it
    contributes if its discount weight is nonzero.  Below
    ``min_uploads`` mature entries every slot id is masked to −1: the
    counts are zero, the server keeps ``prev`` row for row and the
    buffer is left as it is.  ``exact_products``: every weight is 0 or a
    power of two (``clustered_weighted_mean``).  Returns ``(server rows,
    counts, n_agg, n_buffered, new_buf)``."""
    vecs, slots, ready, weight, valid, seq = buf
    mature = valid & (ready <= round_idx)
    # zero-discount entries can never move the weighted mean: consumed,
    # not aggregated
    contrib = mature & (weight > 0.0)
    gate = mature.sum() >= min_uploads
    use = contrib & gate
    s = torch.where(use, slots, -1)
    w = torch.where(use, weight, 0.0)
    mean = masked_collectives.clustered_weighted_mean(vecs, s, w, n_slots,
                                                      exact_products)
    counts = (s[:, None] == torch.arange(n_slots, device=s.device)
              ).to(torch.float32).sum(0)
    server = torch.where(counts[:, None] > 0, mean, prev)
    valid = torch.where(gate, valid & ~mature, valid)
    n_agg = torch.where(gate, contrib.sum(), 0).to(torch.int32)
    return (server, counts, n_agg, valid.sum().to(torch.int32),
            (vecs, slots, ready, weight, valid, seq))
