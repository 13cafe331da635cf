"""Who takes part in a round.

Counterpart of ``repro/fl/runtime/scheduler.py`` for the one setting this
slice of the port runs: full participation, no dropout, no stragglers.
Every round samples ``arange(N)`` in order, and every upload survives and
arrives on time.  Partial participation, weighted and round-robin
sampling, dropout and stragglers need ``jax.random.choice`` and come with
a later slice (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Participation(NamedTuple):
    idx: torch.Tensor        # (K,) int32 — sampled client ids


class Scheduler:
    def __init__(self, n_clients: int):
        self.n = self.k = n_clients

    def sample(self, round_idx: int, key: torch.Tensor) -> Participation:
        """This round's participation: the whole population in order.
        The full-participation branch draws nothing from ``key``, as in
        the reference, so the per-client training keys are unaffected."""
        del round_idx
        return Participation(
            idx=torch.arange(self.n, dtype=torch.int32, device=key.device))
