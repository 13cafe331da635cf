"""The TPFL federation loop: paper Algs. 1 and 2, end to end.

Counterpart of ``repro/core/federation.py``.  One TPFL round (Fig. 2):

* Phase A (client, Alg. 1): local TM training on D_train, per-class
  confidence on D_conf, upload of ``(c_max, W[c_max])``;
* Phases B + C (aggregator): route each upload to cluster k = c_max and
  average each cluster's vectors (:func:`repro_torch.core.clustering.
  aggregate`, empty clusters keep their previous row);
* Phase D (aggregator → clients): cluster k's mean goes back to cluster
  k's members only; every client evaluates on D_test.

The population is one stacked ``TMParams`` (leading axis = clients), so
Phase A is one client-batched :meth:`TPFLStrategy.fused_client_step`
(kernel 1 trains, kernel 2 scores confidence on the card) and the
evaluation one ``tm.accuracy_batched``.  :func:`run_round` is the legacy
in-process loop with the §6.7 byte arithmetic (upload per client = one
weight vector + class id; download per Fig. 5 = one broadcast per
non-empty cluster; the per-client download beside it).  :func:`run`
drives the same federation through the round engine
(:class:`repro_torch.fl.runtime.Engine`), whose default settings give
``run_round``'s results bit for bit, bytes metered from the encoded
frames.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core import clustering, tm
from repro_torch.data.partition import ClientData
from repro_torch.fl.runtime.strategy import TPFLStrategy


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 100
    rounds: int = 10
    local_epochs: int = 10
    weighted_confidence: bool = False   # Alg. 1 uses unweighted margins
    bytes_per_weight: int = 4           # int32 clause weights on the wire
    top_classes: int = 1                # j > 1: §7 multi-cluster sharing
    conf_threshold: float | None = None  # §7: share only confident classes


class RoundMetrics(NamedTuple):
    mean_accuracy: torch.Tensor       # paper metric: mean over all clients
    per_client_accuracy: torch.Tensor
    assignment: torch.Tensor          # (n_clients,) cluster ids; (n, j)
    cluster_counts: torch.Tensor      # (C,)
    upload_bytes: int
    download_bytes_broadcast: int     # paper Fig.-5 accounting
    download_bytes_per_client: int


class TPFLState(NamedTuple):
    client_params: tm.TMParams        # leading axis = clients
    cluster_weights: torch.Tensor     # (C, m) aggregator memory


def init_state(tm_cfg: tm.TMConfig, fed_cfg: FedConfig,
               key: torch.Tensor) -> TPFLState:
    """Per-client ``init_params`` under ``split(key, n_clients)`` and an
    all-zero (C, m) server, on the key's device."""
    params = tm.init_params(tm_cfg, rnd.split(key, fed_cfg.n_clients))
    cw = torch.zeros((tm_cfg.n_classes, tm_cfg.n_clauses),
                     dtype=torch.float32, device=key.device)
    return TPFLState(params, cw)


def _strategy(tm_cfg: tm.TMConfig, fed_cfg: FedConfig) -> TPFLStrategy:
    return TPFLStrategy(
        tm_cfg, local_epochs=fed_cfg.local_epochs,
        top_classes=fed_cfg.top_classes,
        conf_threshold=fed_cfg.conf_threshold,
        weighted_confidence=fed_cfg.weighted_confidence)


def _phase_a(state: TPFLState, data: ClientData, key: torch.Tensor,
             tm_cfg: tm.TMConfig, fed_cfg: FedConfig):
    """Local training + confidence + selective upload (Alg. 1) for the
    whole population under ``split(key, n_clients)``.  Returns the
    trained params, c_top (n, j) int32 (−1 = below ``conf_threshold``)
    and the uploads (n, j, m) float32."""
    keys = rnd.split(key, fed_cfg.n_clients)
    params, up = _strategy(tm_cfg, fed_cfg).fused_client_step(
        state.client_params, state.cluster_weights, data, keys)
    return params, up.slots, up.vecs


def _phase_d(params: tm.TMParams, assignment: torch.Tensor,
             cluster_weights: torch.Tensor) -> tm.TMParams:
    """Each client overwrites its shared classes with the cluster mean.

    assignment: (n, j) class/cluster ids (−1 = not shared)."""
    return TPFLStrategy.apply_broadcast(params, assignment, cluster_weights)


def run_round(state: TPFLState, data: ClientData, key: torch.Tensor,
              tm_cfg: tm.TMConfig, fed_cfg: FedConfig
              ) -> tuple[TPFLState, RoundMetrics]:
    params, c_top, uploads = _phase_a(state, data, key, tm_cfg, fed_cfg)
    j = fed_cfg.top_classes
    res = clustering.aggregate(uploads.reshape(-1, tm_cfg.n_clauses),
                               c_top.reshape(-1), tm_cfg.n_classes,
                               prev=state.cluster_weights)      # B + C
    params = _phase_d(params, c_top, res.cluster_weights)        # D

    acc = tm.accuracy_batched(params, data.x_test, data.y_test, tm_cfg)

    m = tm_cfg.n_clauses
    bpw = fed_cfg.bytes_per_weight
    up = fed_cfg.n_clients * j * (m * bpw + 4)       # j vectors + class ids
    nonempty = int((res.counts > 0).sum())
    down_bc = nonempty * m * bpw                     # per-cluster broadcast
    down_pc = fed_cfg.n_clients * j * m * bpw        # per-client accounting
    assignment = c_top[:, 0] if j == 1 else c_top
    metrics = RoundMetrics(acc.mean(), acc, assignment, res.counts,
                           up, down_bc, down_pc)
    return TPFLState(params, res.cluster_weights), metrics


def run(data: ClientData, tm_cfg: tm.TMConfig, fed_cfg: FedConfig,
        key: torch.Tensor, runtime_cfg=None
        ) -> tuple[TPFLState, list[RoundMetrics]]:
    """Run the federation through the round engine.

    With the default ``runtime_cfg`` (sync, full participation, float32
    wire) this is the :func:`run_round` loop from ``split(key)``'s
    ``(k_init, k_rounds)``, round r keyed ``fold_in(k_rounds, r)``: the
    same assignment, accuracy and byte totals, the bytes metered from
    the encoded frames.  A :class:`repro_torch.fl.runtime.RuntimeConfig`
    runs it under partial participation, dropout, stragglers, lossy
    codecs or async aggregation; ``fed_cfg.rounds`` overrides its round
    count."""
    from repro_torch.fl.runtime import Engine, RuntimeConfig

    if runtime_cfg is None:
        runtime_cfg = RuntimeConfig()
    runtime_cfg = dataclasses.replace(runtime_cfg, rounds=fed_cfg.rounds)
    engine = Engine(_strategy(tm_cfg, fed_cfg), data, runtime_cfg)
    end, reports = engine.run(key)
    j = fed_cfg.top_classes
    history = [
        RoundMetrics(
            mean_accuracy=rep.mean_accuracy,
            per_client_accuracy=rep.per_client_accuracy,
            assignment=rep.assignment[:, 0] if j == 1 else rep.assignment,
            cluster_counts=rep.cluster_counts,
            upload_bytes=rep.upload_bytes,
            download_bytes_broadcast=rep.download_bytes_broadcast,
            download_bytes_per_client=rep.download_bytes_per_client)
        for rep in reports
    ]
    return TPFLState(end.client_state, end.server.slots), history


def total_comm_mb(history: list[RoundMetrics]) -> tuple[float, float]:
    """(upload MB, download MB) over the federation — paper Table 4."""
    up = sum(h.upload_bytes for h in history) / 1e6
    down = sum(h.download_bytes_broadcast for h in history) / 1e6
    return up, down
