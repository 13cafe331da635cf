"""TPFL and FedTM as federated strategies on the Tsetlin Machine.

Counterpart of the TPFL and FedTM parts of
``repro/fl/runtime/strategy.py``.  A
round's contribution is ``j`` flat float32 vectors per client, each
tagged with a server slot (slot = cluster = class; −1 = nothing shared);
the engine meters them on the wire and averages them per slot.

The JAX strategy has a per-client ``client_step`` that executors vmap
and a client-batched ``fused_client_step`` for the kernel path.  Here
every hook is written for the whole stacked cohort (leading client axis
N) and runs the kernels on CUDA tensors, so only the batched forms
exist.  The MLP baselines and FLIS come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core import tm
from repro_torch.data.partition import ClientData


class Upload(NamedTuple):
    vecs: torch.Tensor    # (N, j, d) float32 — what goes on the wire
    slots: torch.Tensor   # (N, j) int32 — target server slot, −1 = none


class ServerState(NamedTuple):
    """The server's slot matrix, the rows that ride the wire."""

    slots: torch.Tensor   # (n_slots, d) float32


def default_server_update(server: ServerState, agg: torch.Tensor,
                          counts: torch.Tensor) -> ServerState:
    """The Alg. 2 retention rule: slots that received contributors take
    the aggregate, empty slots keep their previous row bit for bit."""
    return server._replace(
        slots=torch.where(counts[:, None] > 0, agg, server.slots))


@dataclasses.dataclass(frozen=True)
class TPFLStrategy:
    """Confidence-clustered selective sharing on the Tsetlin Machine."""

    tm_cfg: tm.TMConfig
    local_epochs: int = 10
    top_classes: int = 1                 # j — §7 multi-cluster extension
    conf_threshold: float | None = None  # §7 confidence gate (−1 below)
    weighted_confidence: bool = False    # Alg. 1 uses unweighted margins

    @property
    def n_slots(self) -> int:
        return self.tm_cfg.n_classes

    @property
    def vec_dim(self) -> int:
        return self.tm_cfg.n_clauses

    @property
    def j_slots(self) -> int:
        return self.top_classes

    def init(self, key: torch.Tensor, n_clients: int,
             data: ClientData | None = None):
        """Per-client ``init_params`` under ``split(key, n_clients)``,
        and an all-zero server."""
        del data
        params = tm.init_params(self.tm_cfg, rnd.split(key, n_clients))
        server = torch.zeros((self.n_slots, self.vec_dim),
                             dtype=torch.float32, device=key.device)
        return params, ServerState(server)

    def fused_client_step(self, cs: tm.TMParams, slots: torch.Tensor,
                          d: ClientData, keys: torch.Tensor):
        """Alg. 1 for the cohort: local training, per-class confidence,
        upload of the ``top_classes`` most confident weight vectors."""
        del slots            # TPFL clients train from their own state
        cfg = self.tm_cfg
        params = tm.train_batched(cs, d.x_train, d.y_train, keys, cfg,
                                  epochs=self.local_epochs)
        conf = tm.confidence_scores_batched(
            params, d.x_conf, cfg, weighted=self.weighted_confidence)
        # stable descending sort = lax.top_k's order: ties to the lower id
        vals, c_top = torch.sort(conf, dim=-1, descending=True, stable=True)
        vals, c_top = vals[:, :self.top_classes], c_top[:, :self.top_classes]
        if self.conf_threshold is not None:
            c_top = torch.where(vals >= self.conf_threshold, c_top, -1)
        rows = torch.arange(c_top.shape[0], device=c_top.device)[:, None]
        vecs = params.weights[rows, c_top.clamp(min=0)].to(torch.float32)
        # slot −1 ships a zero row, never class 0's weights
        vecs = torch.where((c_top >= 0)[..., None], vecs, 0.0)
        return params, Upload(vecs, c_top.to(torch.int32))

    @staticmethod
    def apply_broadcast(cs: tm.TMParams, slots: torch.Tensor,
                        slot_matrix: torch.Tensor) -> tm.TMParams:
        """Phase D for the cohort: each client overwrites each class it
        shared (slots (N, j), −1 = none) with its cluster's mean, rounded
        half to even, in order of j."""
        new_w = torch.round(slot_matrix[slots.clamp(min=0).long()]
                            ).to(torch.int32)                 # (N, j, m)
        w = cs.weights.clone()
        rows = torch.arange(w.shape[0], device=w.device)
        for j in range(slots.shape[1]):
            c = slots[:, j].long()
            cur = w[rows, c.clamp(min=0)]
            w[rows, c.clamp(min=0)] = torch.where((c >= 0)[:, None],
                                                  new_w[:, j], cur)
        return cs._replace(weights=w)

    def fused_evaluate(self, cs: tm.TMParams, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        return tm.accuracy_batched(cs, x, y, self.tm_cfg)

    def predict_batched(self, cs: tm.TMParams,
                        x: torch.Tensor) -> torch.Tensor:
        """Stacked per-client predictions (N, B, o) → (N, B): one
        fused-votes launch for a whole mixed-cluster batch."""
        return tm.predict_batched(cs, x, self.tm_cfg)


@dataclasses.dataclass(frozen=True)
class FedTMStrategy:
    """FedTM: the same TM as TPFL, but every client uploads its full
    (C, m) weight block into one global slot and applies the rounded
    global mean: no confidence pass, no selective upload."""

    tm_cfg: tm.TMConfig
    local_epochs: int = 10

    n_slots: int = dataclasses.field(default=1, init=False)
    j_slots: int = dataclasses.field(default=1, init=False)

    @property
    def vec_dim(self) -> int:
        return self.tm_cfg.n_classes * self.tm_cfg.n_clauses

    def init(self, key: torch.Tensor, n_clients: int,
             data: ClientData | None = None):
        del data
        params = tm.init_params(self.tm_cfg, rnd.split(key, n_clients))
        server = torch.zeros((1, self.vec_dim), dtype=torch.float32,
                             device=key.device)
        return params, ServerState(server)

    def fused_client_step(self, cs: tm.TMParams, slots: torch.Tensor,
                          d: ClientData, keys: torch.Tensor):
        """Local training; each client uploads its whole weight block
        (N, 1, C·m) to slot 0."""
        del slots            # clients hold last round's global weights
        params = tm.train_batched(cs, d.x_train, d.y_train, keys,
                                  self.tm_cfg, epochs=self.local_epochs)
        n = params.weights.shape[0]
        vecs = params.weights.to(torch.float32).reshape(n, 1, -1)
        return params, Upload(vecs, torch.zeros((n, 1), dtype=torch.int32,
                                                device=vecs.device))

    def apply_broadcast(self, cs: tm.TMParams, slots: torch.Tensor,
                        slot_matrix: torch.Tensor) -> tm.TMParams:
        """Clients whose slot is ≥ 0 take the global row, rounded half
        to even, as their weights."""
        cfg = self.tm_cfg
        new_w = torch.round(slot_matrix[0]).to(torch.int32).reshape(
            cfg.n_classes, cfg.n_clauses)
        w = torch.where((slots[:, 0] >= 0)[:, None, None], new_w,
                        cs.weights)
        return cs._replace(weights=w)

    def fused_evaluate(self, cs: tm.TMParams, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        return tm.accuracy_batched(cs, x, y, self.tm_cfg)

    def predict_batched(self, cs: tm.TMParams,
                        x: torch.Tensor) -> torch.Tensor:
        return tm.predict_batched(cs, x, self.tm_cfg)
