"""The paper's baselines as straight-line loops (Table 3/5).

Counterpart of ``repro/core/baselines.py``: FedAvg, FedProx (µ = 0.1),
IFCA, FLIS (DC and HC) on the MLP of :mod:`repro_torch.core.mlp`, and
FedTM on the same TM as TPFL.  These are not the primary path (every
method runs through the round engine, one strategy each); they are the
references the engine's strategies are pinned against, with the
engine's key chain (``k_init, k_rounds = split(key)``; round r uses
``split(fold_in(k_rounds, r), n)``) and its aggregation primitive
(``clustering.aggregate`` on the flattened wire format), but no
scheduler, codec or executor in between.

Each loop runs the whole population as one stacked cohort.
``_similarity_clusters`` / ``_average_linkage_clusters`` are the
reference's numpy clusterings, copied numpy for numpy, which the
engine's ``flis_dc_labels`` / ``flis_hc_labels`` are held against.
Communication is metered from the parameter byte counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import clustering, mlp, tm
from repro_torch.data.partition import ClientData
from repro_torch.fl.runtime.strategy import (_flatten_mlp, _mlp_layout,
                                             _unflatten_mlp,
                                             flis_similarity)


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    n_clients: int = 100
    rounds: int = 10
    local_epochs: int = 10
    lr: float = 0.05
    batch: int = 32
    n_hidden: int = 128
    prox_mu: float = 0.1       # FedProx (paper §6.6: 0.1)
    ifca_k: int = 10
    flis_threshold: float = 0.9
    flis_probe: int = 64
    flis_max_slots: int = 8    # server rows: dynamic clusters are capped


class History(NamedTuple):
    accuracy: list[float]            # mean client accuracy per round
    upload_mb: float                 # totals over all rounds
    download_mb: float
    assignments: list | None = None  # per-round cluster ids (FLIS/FedTM)


def _client_keys(key: torch.Tensor, n: int, r: int) -> torch.Tensor:
    return rnd.split(rnd.fold_in(key, r), n)


def _train(params, data: ClientData, cfg: BaselineConfig, keys,
           prox_mu: float = 0.0, prox_ref=None) -> mlp.Params:
    return mlp.local_train(params, data.x_train, data.y_train, keys,
                           epochs=cfg.local_epochs, batch=cfg.batch,
                           lr=cfg.lr, prox_mu=prox_mu, prox_ref=prox_ref)


# ---------------------------------------------------------------------------
# FedAvg / FedProx
# ---------------------------------------------------------------------------

def run_fedavg(data: ClientData, cfg: BaselineConfig, key: torch.Tensor,
               n_features: int, n_classes: int,
               prox: bool = False) -> History:
    k_init, k_train = rnd.split(key).unbind(0)
    global_params = mlp.init(k_init, n_features, cfg.n_hidden, n_classes)
    pbytes = mlp.n_bytes(global_params)
    mu = cfg.prox_mu if prox else 0.0
    accs = []
    for r in range(cfg.rounds):
        ks = _client_keys(k_train, cfg.n_clients, r)
        start = mlp.stack(global_params, cfg.n_clients)
        stacked = _train(start, data, cfg, ks, mu, start if prox else None)
        global_params = mlp.tree_mean(stacked)
        acc = mlp.accuracy(global_params, data.x_test, data.y_test).mean()
        accs.append(float(acc))
    total = cfg.rounds * cfg.n_clients * pbytes / 1e6
    return History(accs, total, total)


def run_fedprox(data: ClientData, cfg: BaselineConfig, key: torch.Tensor,
                n_features: int, n_classes: int) -> History:
    return run_fedavg(data, cfg, key, n_features, n_classes, prox=True)


# ---------------------------------------------------------------------------
# IFCA
# ---------------------------------------------------------------------------

def run_ifca(data: ClientData, cfg: BaselineConfig, key: torch.Tensor,
             n_features: int, n_classes: int) -> History:
    k_init, k_train = rnd.split(key).unbind(0)
    models = mlp.init(rnd.split(k_init, cfg.ifca_k), n_features,
                      cfg.n_hidden, n_classes)            # stacked (k, ...)
    pbytes = mlp.n_bytes({k: v[0] for k, v in models.items()})
    accs = []
    for r in range(cfg.rounds):
        ks = _client_keys(k_train, cfg.n_clients, r)
        # each client picks the cluster model with its lowest local loss
        losses = mlp.loss_fn({k: v[None] for k, v in models.items()},
                             data.x_train[:, None], data.y_train[:, None])
        choice = torch.argmin(losses, dim=-1)             # (n,)
        trained = _train({k: v[choice] for k, v in models.items()}, data,
                         cfg, ks)
        onehot = torch.nn.functional.one_hot(
            choice, cfg.ifca_k).to(torch.float32)         # (n, k)
        counts = onehot.sum(0)

        def agg(new, old):
            s = torch.einsum("n...,nk->k...", new, onehot)
            shape = (-1,) + (1,) * (new.ndim - 1)
            mean = s / torch.clamp(counts, min=1).reshape(shape)
            return torch.where((counts > 0).reshape(shape), mean, old)

        models = {k: agg(trained[k], models[k]) for k in models}
        acc = mlp.accuracy({k: v[choice] for k, v in models.items()},
                           data.x_test, data.y_test).mean()
        accs.append(float(acc))
    up = cfg.rounds * cfg.n_clients * pbytes / 1e6
    down = cfg.rounds * cfg.n_clients * cfg.ifca_k * pbytes / 1e6
    return History(accs, up, down)


# ---------------------------------------------------------------------------
# FLIS (dynamic clustering): the engine's reference loop
# ---------------------------------------------------------------------------

def _similarity_clusters(sim: np.ndarray, threshold: float) -> np.ndarray:
    """FLIS-DC: connected components of the thresholded similarity
    graph, labelled in order of first appearance (= minimum member
    index)."""
    n = sim.shape[0]
    labels = -np.ones(n, dtype=np.int64)
    cur = 0
    for i in range(n):
        if labels[i] >= 0:
            continue
        stack = [i]
        labels[i] = cur
        while stack:
            u = stack.pop()
            for v in range(n):
                if labels[v] < 0 and sim[u, v] >= threshold:
                    labels[v] = cur
                    stack.append(v)
        cur += 1
    return labels


def _average_linkage_clusters(sim: np.ndarray, threshold: float,
                              max_clusters: int) -> np.ndarray:
    """FLIS-HC: average-linkage agglomerative clustering.  Repeatedly
    merge the pair of clusters with the highest average cross-similarity
    while that maximum stays ≥ ``threshold``, or unconditionally while
    more than ``max_clusters`` remain; merges fold the larger root into
    the smaller, so a cluster's root is its minimum member index."""
    n = sim.shape[0]
    size = np.ones(n, np.float32)
    active = np.ones(n, bool)
    cross = sim.astype(np.float32).copy()
    np.fill_diagonal(cross, 0.0)
    labels = np.arange(n)
    while True:
        pair_ok = active[:, None] & active[None, :] & ~np.eye(n, dtype=bool)
        avg = np.where(pair_ok,
                       cross / np.maximum(np.outer(size, size),
                                          np.float32(1.0)),
                       -np.inf).astype(np.float32)
        flat = int(np.argmax(avg))
        a, b = flat // n, flat % n
        best = avg.reshape(-1)[flat]
        n_active = int(active.sum())
        if not (np.isfinite(best) and n_active > 1
                and (n_active > max_clusters or best >= threshold)):
            break
        row = cross[a] + cross[b]
        row[a] = 0.0
        row[b] = 0.0
        cross[a, :] = row
        cross[:, a] = row
        cross[b, :] = 0.0
        cross[:, b] = 0.0
        size[a] += size[b]
        size[b] = 0.0
        active[b] = False
        labels[labels == b] = a
    rank = np.cumsum(active.astype(np.int64)) - 1
    return rank[labels]


def run_flis(data: ClientData, cfg: BaselineConfig, key: torch.Tensor,
             n_features: int, n_classes: int,
             linkage: str = "dc") -> History:
    """The FLIS loop ``FLISStrategy`` is pinned against: the engine's key
    chain (``FLISStrategy.init`` splits ``k_init`` into params / probe),
    the shared similarity (``flis_similarity``), the Alg. 2 aggregate on
    the flattened wire format, and the numpy clusterings above."""
    layout = _mlp_layout(n_features, cfg.n_hidden, n_classes)
    k_init, k_rounds = rnd.split(key).unbind(0)
    k_params, k_probe = rnd.split(k_init).unbind(0)
    stacked = mlp.init(rnd.split(k_params, cfg.n_clients), n_features,
                       cfg.n_hidden, n_classes)
    pbytes = mlp.n_bytes({k: v[0] for k, v in stacked.items()})
    # shared unlabeled probe set (server-side, standard FLIS assumption)
    pool = data.x_conf.reshape(-1, n_features)
    probe = pool[rnd.choice(k_probe, pool.shape[0], cfg.flis_probe).long()]

    accs, assignments = [], []
    for r in range(cfg.rounds):
        ks = _client_keys(k_rounds, cfg.n_clients, r)
        stacked = _train(stacked, data, cfg, ks)
        flat = _flatten_mlp(stacked, layout)
        sim = flis_similarity(flat, probe, layout).cpu().numpy()
        if linkage == "dc":
            labels = np.minimum(_similarity_clusters(sim,
                                                     cfg.flis_threshold),
                                cfg.flis_max_slots - 1)
        else:
            labels = _average_linkage_clusters(sim, cfg.flis_threshold,
                                               cfg.flis_max_slots)
        lab = torch.as_tensor(labels, dtype=torch.int32, device=flat.device)
        res = clustering.aggregate(flat, lab, cfg.flis_max_slots)
        stacked = _unflatten_mlp(res.cluster_weights[lab.long()], layout)
        acc = mlp.accuracy(stacked, data.x_test, data.y_test).mean()
        accs.append(float(acc))
        assignments.append(np.asarray(labels, np.int64))
    total = cfg.rounds * cfg.n_clients * pbytes / 1e6
    return History(accs, total, total, assignments)


def run_flis_hc(data: ClientData, cfg: BaselineConfig, key: torch.Tensor,
                n_features: int, n_classes: int) -> History:
    return run_flis(data, cfg, key, n_features, n_classes, linkage="hc")


# ---------------------------------------------------------------------------
# FedTM (full-model TM averaging): the engine's reference loop
# ---------------------------------------------------------------------------

def run_fedtm(data: ClientData, tm_cfg: tm.TMConfig, cfg: BaselineConfig,
              key: torch.Tensor) -> History:
    """The FedTM loop ``FedTMStrategy`` is pinned against: the engine's
    key chain and its one-slot Alg. 2 aggregate (integer sums are exact
    in float32, so the rounded global mean is the reference's bits)."""
    k_init, k_rounds = rnd.split(key).unbind(0)
    params = tm.init_params(tm_cfg, rnd.split(k_init, cfg.n_clients))
    wbytes = tm_cfg.n_classes * tm_cfg.n_clauses * 4   # all-classes weights
    zeros = torch.zeros((cfg.n_clients,), dtype=torch.int32,
                        device=key.device)

    accs, assignments = [], []
    for r in range(cfg.rounds):
        ks = _client_keys(k_rounds, cfg.n_clients, r)
        params = tm.train_batched(params, data.x_train, data.y_train, ks,
                                  tm_cfg, epochs=cfg.local_epochs)
        # full (C, m) weight averaging across every client: one global
        # slot, no clustering
        flat = params.weights.to(torch.float32).reshape(cfg.n_clients, -1)
        res = clustering.aggregate(flat, zeros, 1)
        w_global = torch.round(res.cluster_weights[0]).to(
            torch.int32).reshape(tm_cfg.n_classes, tm_cfg.n_clauses)
        params = params._replace(
            weights=w_global.expand(params.weights.shape).clone())
        acc = tm.accuracy_batched(params, data.x_test, data.y_test,
                                  tm_cfg).mean()
        accs.append(float(acc))
        assignments.append(np.zeros(cfg.n_clients, np.int64))
    total = cfg.rounds * cfg.n_clients * wbytes / 1e6
    return History(accs, total, total, assignments)


BASELINES: dict[str, Callable] = {
    "fedavg": run_fedavg,
    "fedprox": run_fedprox,
    "ifca": run_ifca,
    "flis": run_flis,
    "flis_hc": run_flis_hc,
}
