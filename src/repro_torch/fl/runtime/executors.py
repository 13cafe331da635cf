"""Where a round's compute runs: in this process, on one device.

Counterpart of the in-process half of ``repro/fl/runtime/executors.py``.
Client training, the server-side assignment, the masked per-slot mean,
broadcast-apply with the merge that keeps non-receivers' old state, and
evaluation each run once for the whole stacked cohort, whatever tree
the client state is; on the GPU the TM's training and evaluation are
one kernel launch per stage.  The
shard-mapped executor becomes ``torch.distributed`` in a later slice.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import clustering


def applied_slots(slots: torch.Tensor, counts: torch.Tensor,
                  arrive: torch.Tensor) -> torch.Tensor:
    """The slots pushed back to each client this round: it arrived, it
    shared the slot, and the slot received an aggregate (a never-fed
    slot row must not overwrite fresh local training)."""
    fed = counts[slots.clamp(min=0).long()] > 0
    return torch.where(arrive[:, None] & (slots >= 0) & fed, slots, -1)


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
