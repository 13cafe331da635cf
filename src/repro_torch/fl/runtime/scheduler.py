"""Partial-participation scheduling: who trains, who drops, who straggles.

Counterpart of ``repro/fl/runtime/scheduler.py``.  Per round the
scheduler draws a :class:`Participation` from the round key: K sampled
client ids, a dropout-survival mask and per-client staleness (rounds of
upload delay).  With the same key every field equals the reference's.

Sampling policies:

* ``uniform``     — K of N without replacement (a permutation's head);
  full participation (K == N) short-cuts to ``arange(N)``, drawing
  nothing;
* ``weighted``    — K of N without replacement, proportional to client
  weights (the engine passes ``ClientData.sizes``), through the Gumbel
  top-k with XLA:CPU's float32 ``log``;
* ``round_robin`` — the window ``(r·K + i) mod N``.

Dropout loses a sampled client's upload (it gets no broadcast either);
a straggler's upload arrives ``staleness ∈ [1, max_staleness]`` rounds
late, which the sync engine treats as a drop.  A real transport server
records what it observed instead (:func:`arrival_participation`): the
uploads that crossed the wire in a round, with their arrival lags.

``sample`` draws on the host and moves the result to the key's device
in one copy: the draw is a few hundred elementwise ops on K-element
vectors, launches and nothing else on a card.  ``draw`` runs the same
ops on the key's own device, with the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd

SAMPLING = ("uniform", "weighted", "round_robin")

# fold_in tags: scheduler randomness on streams disjoint from the
# per-client training keys, which consume the raw round key
_TAG_SELECT, _TAG_DROP, _TAG_STRAGGLE = 0x5C4ED, 0xD120F, 0x57A1E


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    participation: float = 1.0   # K = max(1, round(p·N)) clients per round
    sampling: str = "uniform"    # uniform | weighted | round_robin
    dropout: float = 0.0         # P(sampled client's upload is lost)
    straggler: float = 0.0       # P(surviving upload arrives late)
    max_staleness: int = 2       # stragglers' delay ∈ [1, max_staleness]

    def __post_init__(self):
        if self.sampling not in SAMPLING:
            raise ValueError(f"unknown sampling {self.sampling!r}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")


class Participation(NamedTuple):
    idx: torch.Tensor        # (K,) int32 — sampled client ids
    active: torch.Tensor     # (K,) bool  — survived dropout
    staleness: torch.Tensor  # (K,) int32 — 0 = on time, s ≥ 1 = straggler

    def summary(self) -> dict:
        """Host-side gauges for the telemetry plane, as the reference's:
        sampled / dropped / on-time / straggler counts and the staleness
        histogram of surviving uploads (index = rounds of delay)."""
        active = self.active.cpu().numpy()
        stale = self.staleness.cpu().numpy()
        surviving = stale[active]
        hist = (np.bincount(surviving) if surviving.size
                else np.zeros(1, np.int64))
        return {
            "sampled": int(active.shape[0]),
            "dropped": int((~active).sum()),
            "arrived_on_time": int((active & (stale == 0)).sum()),
            "stragglers": int((active & (stale > 0)).sum()),
            "staleness_hist": hist.tolist(),
        }


def arrival_participation(client_ids, observed_lag,
                          device=None) -> Participation:
    """Participation as a real transport server observed one round: the
    uploads that crossed the wire, with their arrival lags (arrival round
    − source round; 0 = produced and delivered in the same round), as
    the reference's.  Every listed upload arrived, so ``active`` is all
    True, and :meth:`Participation.summary` gives the observed staleness
    histogram in the scheduled view's schema.  The tensors lie on
    ``device`` (the GPU unless the caller names another)."""
    ids = np.asarray(client_ids, np.int32).ravel()
    lag = np.asarray(observed_lag, np.int32).ravel()
    if ids.shape != lag.shape:
        raise ValueError(
            f"arrival_participation: client_ids{ids.shape} and "
            f"observed_lag{lag.shape} must be the same length")
    if lag.size and int(lag.min()) < 0:
        raise ValueError(
            "arrival_participation: negative observed lag — an upload "
            "cannot arrive before the round that produced it")
    dev = devices.resolve(device)
    return Participation(
        idx=torch.from_numpy(ids).to(dev),
        active=torch.ones((ids.size,), dtype=torch.bool, device=dev),
        staleness=torch.from_numpy(lag).to(dev))


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, n_clients: int,
                 weights=None):
        self.cfg = cfg
        self.n = n_clients
        self.k = max(1, int(round(cfg.participation * n_clients)))
        # uniform full participation samples arange(N): the cohort is the
        # population in order
        self.full_in_order = self.k == self.n and cfg.sampling == "uniform"
        # no client can miss the sync barrier: every sampled upload arrives
        self.all_arrive = not (cfg.dropout > 0.0 or (
            cfg.straggler > 0.0 and cfg.max_staleness > 0))
        self.p = None
        if cfg.sampling == "weighted":
            # the one float32 cast of the weights, as in the reference:
            # any integer-exact source gives the same p
            w = torch.ones(n_clients) if weights is None \
                else torch.as_tensor(weights).to("cpu", torch.float32)
            if w.shape != (n_clients,):
                raise ValueError(f"client weights shape {tuple(w.shape)} "
                                 f"!= ({n_clients},)")
            if not bool((w >= 0).all()) or float(w.sum()) <= 0.0:
                raise ValueError("client weights must be non-negative "
                                 "with a positive sum")
            self.p = w / w.sum()

    def sample(self, round_idx: int, key: torch.Tensor) -> Participation:
        """This round's participation, drawn on the host from the round
        key and put on the key's device in one copy."""
        part = self.draw(round_idx, key.cpu())
        if key.device.type == "cpu":
            return part
        idx, active, staleness = torch.stack(
            [part.idx, part.active.to(torch.int32), part.staleness]
        ).to(key.device).unbind(0)
        return Participation(idx, active.bool(), staleness)

    def draw(self, round_idx: int, key: torch.Tensor) -> Participation:
        """This round's participation, drawn on the key's device from the
        round key through fold-in tags, so the per-client training keys
        are unaffected."""
        cfg, dev = self.cfg, key.device
        if cfg.sampling == "round_robin":
            idx = (round_idx * self.k + torch.arange(self.k, device=dev)
                   ) % self.n
        elif self.full_in_order:
            idx = torch.arange(self.n, device=dev)
        else:
            idx = rnd.choice(rnd.fold_in(key, _TAG_SELECT), self.n, self.k,
                             p=None if self.p is None else self.p.to(dev))
        idx = idx.to(torch.int32)

        if cfg.dropout > 0.0:
            active = rnd.bernoulli(rnd.fold_in(key, _TAG_DROP),
                                   1.0 - cfg.dropout, (self.k,))
        else:
            active = torch.ones(self.k, dtype=torch.bool, device=dev)

        if cfg.straggler > 0.0 and cfg.max_staleness > 0:
            k_who, k_lag = rnd.split(rnd.fold_in(key, _TAG_STRAGGLE)
                                     ).unbind(0)
            late = rnd.bernoulli(k_who, cfg.straggler, (self.k,))
            lag = rnd.randint(k_lag, (self.k,), 1, cfg.max_staleness + 1)
            staleness = torch.where(late, lag, 0).to(torch.int32)
        else:
            staleness = torch.zeros(self.k, dtype=torch.int32, device=dev)
        return Participation(idx, active, staleness)
