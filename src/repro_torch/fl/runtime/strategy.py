"""Every federated method as one strategy: TPFL, FedTM, and the DL
baselines FedAvg / FedProx, IFCA and FLIS (DC and HC).

Counterpart of ``repro/fl/runtime/strategy.py``.  A round's contribution
is ``j`` flat float32 vectors per client, each tagged with a server slot
(slot = cluster; −1 = nothing shared); the engine meters them on the
wire and averages them per slot.  Two optional server-side hooks sit
between the uplink and the broadcast:

* ``assign(server, vecs, slots, arrive) → slots`` recomputes each
  upload's slot from the decoded uploads (FLIS's per-round clusters);
  without it the client-proposed slots stand;
* ``server_update(server, agg, counts) → server`` folds the per-slot
  mean into the server state (:func:`resolve_server_update`; the Alg. 2
  :func:`default_server_update` without it).

The server state is :class:`ServerState`: the slot matrix that rides
the wire and an ``aux`` tree only the strategy reads (FLIS's probe set
and membership table; ``()``, no leaves, for the rest).

The JAX strategy has a per-client ``client_step`` that executors vmap
and a client-batched ``fused_client_step`` for the kernel path.  Here
every hook is written for the whole stacked cohort (leading client axis
N): the TM strategies run the kernels on CUDA tensors, the MLP
strategies one batched product for the cohort.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.core import mlp, tm
from repro_torch.data.partition import ClientData

DOWNLOADS = ("assigned", "all_slots")


class Upload(NamedTuple):
    vecs: torch.Tensor    # (N, j, d) float32 — what goes on the wire
    slots: torch.Tensor   # (N, j) int32 — target server slot, −1 = none


class ServerState(NamedTuple):
    """Strategy-owned server state: the slot matrix that rides the wire
    and an aux tree only the strategy reads."""

    slots: torch.Tensor   # (n_slots, d) float32
    aux: Any = ()         # strategy-private tree (empty for most)


def ensure_server_state(server) -> ServerState:
    """A bare slot matrix (a v1 ``init`` return) as a :class:`ServerState`."""
    if isinstance(server, ServerState):
        return server
    return ServerState(slots=torch.as_tensor(server, dtype=torch.float32))


def default_server_update(server: ServerState, agg: torch.Tensor,
                          counts: torch.Tensor) -> ServerState:
    """The Alg. 2 retention rule: slots that received contributors take
    the aggregate, empty slots keep their previous row bit for bit."""
    return server._replace(
        slots=torch.where(counts[:, None] > 0, agg, server.slots))


def resolve_server_update(strategy):
    """The strategy's ``server_update`` hook, or the Alg. 2 default."""
    return getattr(strategy, "server_update", None) or default_server_update


@runtime_checkable
class Strategy(Protocol):
    """What the engine needs of a strategy: every hook takes the whole
    stacked cohort (leading client axis N)."""

    n_slots: int          # rows in the server slot matrix
    vec_dim: int          # d — length of one uploaded vector
    j_slots: int          # uploads per client per round
    downloads: Literal["assigned", "all_slots"]   # checked by the engine

    def init(self, key: torch.Tensor, n_clients: int,
             data: ClientData | None = None): ...
    def fused_client_step(self, cs, slots: torch.Tensor, d: ClientData,
                          keys: torch.Tensor): ...
    def apply_broadcast(self, cs, slots: torch.Tensor,
                        slot_matrix: torch.Tensor): ...
    def fused_evaluate(self, cs, x: torch.Tensor, y: torch.Tensor): ...
    # optional hooks (absent = the client-proposed slots / Alg. 2):
    #   assign(server: ServerState, vecs (K,j,d), slots (K,j),
    #          arrive (K,)) -> (K,j) int32
    #   server_update(server: ServerState, agg (C,d), counts (C,))
    #          -> ServerState


def _tm_init_cohort(cfg: tm.TMConfig, key: torch.Tensor, ids,
                    n_clients: int) -> tm.TMParams:
    """Rows ``ids`` of ``init_params(cfg, split(key, n_clients))``: the
    same per-client keys, drawn for the cohort only."""
    ids = torch.as_tensor(ids, dtype=torch.long, device=key.device)
    return tm.init_params(cfg, rnd.split(key, n_clients)[ids])


@dataclasses.dataclass(frozen=True)
class TPFLStrategy:
    """Confidence-clustered selective sharing on the Tsetlin Machine."""

    tm_cfg: tm.TMConfig
    local_epochs: int = 10
    top_classes: int = 1                 # j — §7 multi-cluster extension
    conf_threshold: float | None = None  # §7 confidence gate (−1 below)
    weighted_confidence: bool = False    # Alg. 1 uses unweighted margins

    downloads: str = dataclasses.field(default="assigned", init=False)

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

    # -- the O(K) init hooks (client_store="mmap") -------------------------
    # The store regenerates never-spilled rows per cohort:
    # ``init_cohort(key, ids, n) == init(key, n)[0][ids]`` bit for bit
    # (the same key split, indexed) and ``init_server`` is the server
    # part alone.  Only the (n, 2) key table is O(N), and transient.

    def init_cohort(self, key: torch.Tensor, ids, n_clients: int):
        return _tm_init_cohort(self.tm_cfg, key, ids, n_clients)

    def init_server(self, key: torch.Tensor, n_clients: int) -> ServerState:
        del n_clients
        return ServerState(torch.zeros((self.n_slots, self.vec_dim),
                                       dtype=torch.float32,
                                       device=key.device))

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


# ---------------------------------------------------------------------------
# MLP flatten/unflatten (FedAvg / FedProx / IFCA / FLIS wire format)
# ---------------------------------------------------------------------------

def _mlp_layout(n_features: int, n_hidden: int, n_classes: int):
    return (("w1", (n_features, n_hidden)), ("b1", (n_hidden,)),
            ("w2", (n_hidden, n_classes)), ("b2", (n_classes,)))


def _flatten_mlp(params: mlp.Params, layout) -> torch.Tensor:
    """(..., d) float32: each leaf raveled in layout order, over the
    params' leading axes."""
    lead = params[layout[0][0]].ndim - len(layout[0][1])
    return torch.cat([params[k].to(torch.float32).flatten(lead)
                      for k, _ in layout], dim=-1)


def _unflatten_mlp(vec: torch.Tensor, layout) -> mlp.Params:
    out, off = {}, 0
    for k, shape in layout:
        size = 1
        for s in shape:
            size *= s
        out[k] = vec[..., off:off + size].reshape(vec.shape[:-1] + shape)
        off += size
    return out


@dataclasses.dataclass(frozen=True)
class MLPStrategyBase:
    """Shared substrate of the DL strategies (FedAvg/FedProx, IFCA,
    FLIS): one MLP layout, one flatten/unflatten wire format, one
    slot-row broadcast-apply, one evaluation.  Subclasses differ only in
    routing: which slot an upload targets and which row a client
    applies."""

    n_features: int
    n_hidden: int
    n_classes: int
    local_epochs: int = 10
    batch: int = 32
    lr: float = 0.05

    @property
    def _layout(self):
        return _mlp_layout(self.n_features, self.n_hidden, self.n_classes)

    @property
    def vec_dim(self) -> int:
        total = 0
        for _, shape in self._layout:
            size = 1
            for s in shape:
                size *= s
            total += size
        return total

    def _train(self, params, d: ClientData, keys, prox_mu=0.0,
               prox_ref=None) -> mlp.Params:
        return mlp.local_train(params, d.x_train, d.y_train, keys,
                               epochs=self.local_epochs, batch=self.batch,
                               lr=self.lr, prox_mu=prox_mu,
                               prox_ref=prox_ref)

    def _upload(self, p: mlp.Params, slot: torch.Tensor) -> "Upload":
        return Upload(_flatten_mlp(p, self._layout)[:, None, :],
                      slot.to(torch.int32)[:, None])

    def _apply_slot_row(self, cs: mlp.Params, slot: torch.Tensor,
                        slot_matrix: torch.Tensor) -> mlp.Params:
        """Each client applies the row it was routed to (slot (N,)); slot
        −1 = nothing was aggregated for it, so it keeps its locally
        trained model."""
        new = _unflatten_mlp(slot_matrix[slot.clamp(min=0).long()],
                             self._layout)
        return tree.map(lambda nw, old: torch.where(
            (slot >= 0).reshape((-1,) + (1,) * (old.ndim - 1)), nw, old),
            new, cs)

    def apply_broadcast(self, cs: mlp.Params, slots: torch.Tensor,
                        slot_matrix: torch.Tensor) -> mlp.Params:
        return self._apply_slot_row(cs, slots[:, 0], slot_matrix)

    def fused_evaluate(self, cs: mlp.Params, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        return mlp.accuracy(cs, x, y)

    def predict_batched(self, cs: mlp.Params,
                        x: torch.Tensor) -> torch.Tensor:
        """Stacked per-client predictions (N, B, F) → (N, B) int32."""
        return mlp.apply(cs, x).argmax(-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FedAvgStrategy(MLPStrategyBase):
    """FedAvg (and FedProx with ``prox_mu > 0``): one global slot."""

    prox_mu: float = 0.0          # > 0 → FedProx proximal objective

    n_slots: int = dataclasses.field(default=1, init=False)
    j_slots: int = dataclasses.field(default=1, init=False)
    downloads: str = dataclasses.field(default="assigned", init=False)

    def init(self, key: torch.Tensor, n_clients: int,
             data: ClientData | None = None):
        del data
        g = mlp.init(key, self.n_features, self.n_hidden, self.n_classes)
        server = _flatten_mlp(g, self._layout)[None, :]
        return mlp.stack(g, n_clients), ServerState(server)

    def fused_client_step(self, cs: mlp.Params, slots: torch.Tensor,
                          d: ClientData, keys: torch.Tensor):
        """Every client trains from the global row (as it holds it)."""
        del cs
        start = mlp.stack(_unflatten_mlp(slots[0], self._layout),
                            keys.shape[0])
        ref = start if self.prox_mu > 0 else None
        p = self._train(start, d, keys, self.prox_mu, ref)
        return p, self._upload(p, torch.zeros(
            keys.shape[0], dtype=torch.int32, device=keys.device))


@dataclasses.dataclass(frozen=True)
class IFCAStrategy(MLPStrategyBase):
    """IFCA: k global models; each client picks the one with the lowest
    loss on its whole training split, trains from it and uploads to its
    slot.  Every client downloads all k rows."""

    k: int = 10

    j_slots: int = dataclasses.field(default=1, init=False)
    downloads: str = dataclasses.field(default="all_slots", init=False)

    @property
    def n_slots(self) -> int:
        return self.k

    def init(self, key: torch.Tensor, n_clients: int,
             data: ClientData | None = None):
        del data
        models = mlp.init(rnd.split(key, self.k), self.n_features,
                          self.n_hidden, self.n_classes)
        server = _flatten_mlp(models, self._layout)
        g = _unflatten_mlp(server[0], self._layout)
        return mlp.stack(g, n_clients), ServerState(server)

    def slot_losses(self, slots: torch.Tensor, d: ClientData
                    ) -> torch.Tensor:
        """(N, k): each client's mean loss under each slot model."""
        models = _unflatten_mlp(slots[None], self._layout)   # (1, k, ...)
        return mlp.loss_fn(models, d.x_train[:, None], d.y_train[:, None])

    def fused_client_step(self, cs: mlp.Params, slots: torch.Tensor,
                          d: ClientData, keys: torch.Tensor):
        del cs
        choice = torch.argmin(self.slot_losses(slots, d), dim=-1)
        start = _unflatten_mlp(slots[choice], self._layout)
        p = self._train(start, d, keys)
        return p, self._upload(p, choice)


# ---------------------------------------------------------------------------
# FLIS: dynamic clusters from inference similarity on a probe set
# ---------------------------------------------------------------------------

@mlp._fp32
def flis_similarity(flat_models: torch.Tensor, probe: torch.Tensor,
                    layout) -> torch.Tensor:
    """Pairwise inference similarity of K uploaded models on the probe
    set: cosine similarity of the flattened softmax prediction profiles,
    ``(K, d) × (P, F) → (K, K)``."""
    params = _unflatten_mlp(flat_models, layout)
    preds = torch.softmax(mlp.apply(params, probe), dim=-1)   # (K, P, C)
    flat = preds.reshape(flat_models.shape[0], -1)
    flat = flat / torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    return flat @ flat.T


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def flis_dc_labels(sim: torch.Tensor, arrive: torch.Tensor,
                   threshold: float, max_slots: int) -> torch.Tensor:
    """FLIS-DC: connected components of the thresholded similarity graph
    among the arrived clients, by K steps of min-label propagation (a
    component's label is its minimum member index), densely renumbered
    in order of first appearance and clipped into ``max_slots`` rows
    (overflow components share the last).  Non-arrived clients get −1.
    Integer steps: the reference's labels for the same ``sim``."""
    k = sim.shape[0]
    arrive = arrive.to(torch.bool)
    ids = torch.arange(k, dtype=torch.int32, device=sim.device)
    adj = (sim >= _f32(threshold, sim)) & arrive[:, None] & arrive[None, :]
    labels = torch.where(arrive, ids, k)
    for _ in range(k):
        cand = torch.where(adj, labels[None, :], k)
        labels = torch.minimum(labels, cand.min(dim=1).values)
    is_rep = arrive & (labels == ids)
    rank = torch.cumsum(is_rep.to(torch.int32), 0) - 1
    dense = rank[labels.clamp(0, k - 1).long()]
    dense = torch.clamp(dense, max=max_slots - 1)
    return torch.where(arrive, dense, -1).to(torch.int32)


def flis_hc_labels(sim: torch.Tensor, arrive: torch.Tensor,
                   threshold: float, max_slots: int) -> torch.Tensor:
    """FLIS-HC: average-linkage agglomerative clustering, K−1 masked
    merge steps.  Each merges the pair of active clusters with the
    highest average cross-similarity (row-major first maximum) while it
    stays ≥ ``threshold``, or unconditionally while more than
    ``max_slots`` clusters remain, folding the larger index into the
    smaller.  The reference's float32 adds and divides, element for
    element, so its labels for the same ``sim``."""
    k = sim.shape[0]
    dev = sim.device
    arrive = arrive.to(torch.bool)
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    thr = _f32(threshold, sim)
    size = torch.where(arrive, 1.0, 0.0).to(torch.float32)
    cross = torch.where(arrive[:, None] & arrive[None, :] & ~eye,
                        sim.to(torch.float32), 0.0)
    ids = torch.arange(k, dtype=torch.int32, device=dev)
    labels = torch.where(arrive, ids, k)
    active = arrive.clone()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    neg_inf = _f32(float("-inf"), sim)
    for _ in range(k - 1):
        pair_ok = active[:, None] & active[None, :] & ~eye
        avg = torch.where(pair_ok, cross / torch.clamp(
            size[:, None] * size[None, :], min=1.0), neg_inf)
        flat_i = torch.argmax(avg.reshape(-1))     # first max: a < b
        a, b = flat_i // k, flat_i % k
        best = avg.reshape(-1)[flat_i]
        n_active = active.sum()
        merge = (~done) & torch.isfinite(best) & (n_active > 1) \
            & ((n_active > max_slots) | (best >= thr))
        row = cross[a] + cross[b]
        row = row.index_fill(0, torch.stack([a, b]), 0.0)
        cross2 = cross.clone()
        cross2[a, :] = row
        cross2[:, a] = row
        cross2[b, :] = 0.0
        cross2[:, b] = 0.0
        size2 = size.clone()
        size2[a] = size[a] + size[b]
        size2[b] = 0.0
        active2 = active.clone()
        active2[b] = False
        labels2 = torch.where(labels == b, a.to(torch.int32), labels)
        cross = torch.where(merge, cross2, cross)
        size = torch.where(merge, size2, size)
        active = torch.where(merge, active2, active)
        labels = torch.where(merge, labels2, labels)
        done = done | ~merge
    rank = torch.cumsum(active.to(torch.int32), 0) - 1
    dense = rank[labels.clamp(0, k - 1).long()]
    return torch.where(arrive, dense, -1).to(torch.int32)


class FLISAux(NamedTuple):
    """FLIS's server aux: the shared unlabeled probe set (server-side,
    the standard FLIS assumption) and the last round's membership table
    (contributors per slot)."""

    probe: torch.Tensor     # (probe_size, n_features)
    members: torch.Tensor   # (n_slots,) float32


class FLISClientState(NamedTuple):
    """FLIS per-client state: the MLP and the cluster row the client last
    applied (the tag its upload carries, so a sparse-delta uplink
    encodes against the row it holds)."""

    params: mlp.Params
    prev_slot: torch.Tensor   # (N,) int32, 0 at init


@dataclasses.dataclass(frozen=True)
class FLISStrategy(MLPStrategyBase):
    """FLIS: cluster membership derived server-side each round from
    inference similarity on a probe set.

    Clients train from their own state and upload the flattened MLP
    tagged with the row they last applied; :meth:`assign` discards the
    tags and clusters the decoded uploads (DC = thresholded connected
    components, HC = average linkage) into at most ``max_slots`` rows;
    :meth:`server_update` applies the Alg. 2 retention and records the
    round's membership table in ``aux.members``."""

    max_slots: int = 8
    probe_size: int = 64
    threshold: float = 0.9
    linkage: str = "dc"            # dc | hc

    j_slots: int = dataclasses.field(default=1, init=False)
    downloads: str = dataclasses.field(default="assigned", init=False)

    def __post_init__(self):
        if self.linkage not in ("dc", "hc"):
            raise ValueError(f"unknown FLIS linkage {self.linkage!r}; "
                             f"choose 'dc' or 'hc'")

    @property
    def n_slots(self) -> int:
        return self.max_slots

    def init(self, key: torch.Tensor, n_clients: int,
             data: ClientData | None = None):
        if data is None:
            raise ValueError(
                "FLISStrategy.init needs the engine's ClientData: the "
                "server-side probe set is drawn from the confidence "
                "split (x_conf)")
        k_params, k_probe = rnd.split(key).unbind(0)
        stacked = mlp.init(rnd.split(k_params, n_clients), self.n_features,
                           self.n_hidden, self.n_classes)
        pool = data.x_conf.reshape(-1, self.n_features)
        if self.probe_size > pool.shape[0]:
            raise ValueError(
                f"probe_size={self.probe_size} exceeds the confidence "
                f"split's pooled sample count ({pool.shape[0]}) — the "
                f"probe set is drawn without replacement from x_conf; "
                f"lower --probe-size or enlarge the conf split")
        idx = rnd.choice(k_probe.to(pool.device), pool.shape[0],
                         self.probe_size).long()
        dev = key.device
        server = torch.zeros((self.n_slots, self.vec_dim),
                             dtype=torch.float32, device=dev)
        aux = FLISAux(probe=pool[idx], members=torch.zeros(
            (self.n_slots,), dtype=torch.float32, device=dev))
        cs = FLISClientState(stacked, torch.zeros(
            (n_clients,), dtype=torch.int32, device=dev))
        return cs, ServerState(server, aux)

    def fused_client_step(self, cs: FLISClientState, slots: torch.Tensor,
                          d: ClientData, keys: torch.Tensor):
        del slots            # clients train from their own cluster model
        p = self._train(cs.params, d, keys)
        return (FLISClientState(p, cs.prev_slot),
                self._upload(p, cs.prev_slot))   # tag = last applied row

    def apply_broadcast(self, cs: FLISClientState, slots: torch.Tensor,
                        slot_matrix: torch.Tensor) -> FLISClientState:
        """Apply the routed row and remember it: ``prev_slot`` advances
        only where a row was applied."""
        s = slots[:, 0]
        return FLISClientState(
            self._apply_slot_row(cs.params, s, slot_matrix),
            torch.where(s >= 0, s, cs.prev_slot))

    def fused_evaluate(self, cs: FLISClientState, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        return mlp.accuracy(cs.params, x, y)

    def predict_batched(self, cs: FLISClientState,
                        x: torch.Tensor) -> torch.Tensor:
        return super().predict_batched(cs.params, x)

    def assign(self, server: ServerState, vecs: torch.Tensor,
               slots: torch.Tensor, arrive: torch.Tensor) -> torch.Tensor:
        """Inference similarity on the probe set, then DC/HC clustering
        of the arrived uploads into at most ``max_slots`` clusters."""
        del slots                      # the tags carry no signal here
        sim = flis_similarity(vecs[:, 0, :], server.aux.probe, self._layout)
        labels = flis_dc_labels if self.linkage == "dc" else flis_hc_labels
        return labels(sim, arrive, self.threshold, self.n_slots)[:, None]

    def server_update(self, server: ServerState, agg: torch.Tensor,
                      counts: torch.Tensor) -> ServerState:
        """Alg. 2 retention on the rows, and the round's membership table
        recorded into ``aux``."""
        slots = torch.where(counts[:, None] > 0, agg, server.slots)
        return ServerState(slots, server.aux._replace(members=counts))


# ---------------------------------------------------------------------------
# FedTM: full-weight TM averaging, one global slot, no personalization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedTMStrategy:
    """FedTM: the same TM as TPFL, but every client uploads its full
    (C, m) weight block into one global slot and applies the rounded
    global mean: no confidence pass, no selective upload."""

    tm_cfg: tm.TMConfig
    local_epochs: int = 10

    n_slots: int = dataclasses.field(default=1, init=False)
    j_slots: int = dataclasses.field(default=1, init=False)
    downloads: str = dataclasses.field(default="assigned", init=False)

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

    # the O(K) init hooks, TPFLStrategy's contract
    def init_cohort(self, key: torch.Tensor, ids, n_clients: int):
        return _tm_init_cohort(self.tm_cfg, key, ids, n_clients)

    def init_server(self, key: torch.Tensor, n_clients: int) -> ServerState:
        del n_clients
        return ServerState(torch.zeros((1, self.vec_dim),
                                       dtype=torch.float32,
                                       device=key.device))

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


def build_baseline_strategy(name: str, *, n_features: int, n_classes: int,
                            n_hidden: int = 128, local_epochs: int = 10,
                            batch: int = 32, lr: float = 0.05,
                            prox_mu: float = 0.1,
                            ifca_k: int | None = None,
                            max_slots: int = 8, probe_size: int = 64,
                            flis_threshold: float = 0.9):
    """The name → strategy factory of the MLP baselines, the reference's
    hyperparameters.  FedTM is built apart (it needs the TM config)."""
    kw = dict(n_features=n_features, n_classes=n_classes,
              n_hidden=n_hidden, local_epochs=local_epochs,
              batch=batch, lr=lr)
    if name == "fedavg":
        return FedAvgStrategy(**kw)
    if name == "fedprox":
        return FedAvgStrategy(prox_mu=prox_mu, **kw)
    if name == "ifca":
        return IFCAStrategy(k=ifca_k or min(10, n_classes), **kw)
    if name in ("flis_dc", "flis_hc"):
        return FLISStrategy(linkage=name.removeprefix("flis_"),
                            max_slots=max_slots, probe_size=probe_size,
                            threshold=flis_threshold, **kw)
    raise ValueError(f"unknown baseline strategy {name!r}")
