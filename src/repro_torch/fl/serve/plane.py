"""The serving plane: client id → personalized model → prediction, in
mixed-cluster batches.

Counterpart of ``repro/fl/serve/plane.py``.  A :class:`ServingPlane`
holds exactly one *active* model version — an immutable
:class:`ActiveModel` snapshot of (version, engine state) pulled from the
:class:`~repro_torch.fl.serve.registry.ModelRegistry` — and answers
batched requests over heterogeneous clients:

**Resolution.**  Each requested client id resolves to the row it is
evaluated with offline:

* a resident checkpoint carries the population in
  ``state.client_state``; training folded the assigned slot row in at
  every broadcast, so each row already is the cluster-resolved
  personalized model;
* with the training run's mmap
  :class:`~repro_torch.fl.store.ClientStore` attached, spilled rows are
  gathered (digest-verified) onto the plane's device as the
  personalized model, and a never-sampled client falls back to the
  store's deterministic per-client init, the row the engine's own
  population eval resolves for it.  Each batch's personalized /
  fallback split goes to telemetry.

**Inference.**  The whole batch — R requests against up to R distinct
models — is one call of ``strategy.predict_batched`` (each request its
own lane): for the TM one ``fused_votes_batched`` launch on the GPU,
for the MLP one batched product.  Duplicate client ids share one
resolved row, whatever tree the client state is.

**Warm swap.**  ``refresh()`` pulls a newer registry version (fully
verifying it) and then swaps the active snapshot with one reference
assignment.  ``predict`` reads that snapshot once, at entry, so a
version landing mid-request cannot mix into it (the tests race this on
purpose through ``resolve_hook``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.fl.store import client_store
from repro_torch.fl.serve.registry import ModelRegistry, RegistryError
from repro_torch.fl.serve.telemetry import NULL_SERVE


class ActiveModel(NamedTuple):
    """One immutable serving snapshot: a version and its verified state."""

    version: int
    state: Any          # EngineState pulled from the registry


def _rows(state, idx: torch.Tensor):
    """Rows ``idx`` of every tensor of a client-state tree."""
    return tree.map(lambda a: a[idx], state)


class ServingPlane:
    """Personalized inference over one trained population.

    ``like`` is a fresh ``engine.init(key)`` state — the structure
    template every registry pull decodes into, and whose device the
    plane serves on.  ``store`` attaches the training run's mmap
    ``ClientStore`` (keyed by the same ``k_init``); without it the
    active checkpoint must carry a resident population.
    ``resolve_hook``, if given, runs inside ``predict`` right after the
    active snapshot is taken — a test seam for racing warm swaps
    against in-flight requests."""

    def __init__(self, strategy, registry: ModelRegistry, like, *,
                 store=None, telemetry=None,
                 resolve_hook: Callable[["ServingPlane"], None] | None
                 = None):
        self.strategy = strategy
        self.registry = registry
        self.store = store
        self.obs = telemetry if telemetry is not None else NULL_SERVE
        self._like = like
        self._resolve_hook = resolve_hook
        self._active: ActiveModel | None = None
        self.last_served_version: int | None = None

    @property
    def device(self) -> torch.device:
        return self._like.round_idx.device

    @property
    def active_version(self) -> int | None:
        a = self._active
        return a.version if a is not None else None

    def refresh(self) -> bool:
        """Activate the newest registry version if it supersedes the
        active one.  Pull-verify first, swap last (one reference
        assignment).  Returns True iff a swap happened."""
        newest = self.registry.latest()
        cur = self._active
        if newest is None or (cur is not None and newest <= cur.version):
            return False
        state = self.registry.pull(newest, self._like)
        self._active = ActiveModel(newest, state)
        self.obs.swap_event(cur.version if cur is not None else None,
                            newest)
        return True

    def _resolve_rows(self, state, uniq: np.ndarray):
        """Stacked per-client rows for the unique requested ids, plus
        the personalized mask (False = deterministic-init fallback)."""
        if self.store is not None:
            rows = client_store.tree_map(
                lambda a: torch.from_numpy(a).to(self.device),
                self.store.gather(uniq)["cs"])
            return rows, self.store.written_mask(uniq)
        cs = state.client_state
        n = tree.leaves(cs)[0].shape[0]
        if n == 0:
            raise RegistryError(
                "the active checkpoint carries no resident population "
                "(it was written by the mmap engine) — attach the "
                "training run's ClientStore to serve personalized rows")
        if uniq.size and int(uniq.max()) >= n:
            raise RegistryError(
                f"client id {int(uniq.max())} is outside the trained "
                f"population [0, {n})")
        idx = torch.as_tensor(np.asarray(uniq, np.int64), device=self.device)
        return _rows(cs, idx), np.ones((uniq.size,), bool)

    def predict(self, client_ids, x) -> np.ndarray:
        """Predictions for ``x[i]`` under ``client_ids[i]``'s model.

        ``client_ids`` is (R,) int, ``x`` is (R, n_features), a tensor or
        an array; returns (R,) int32.  The active snapshot is read once,
        at entry."""
        active = self._active
        if active is None:
            raise RegistryError(
                "the serving plane has no active model — publish a "
                "checkpoint and call refresh() first")
        if self._resolve_hook is not None:
            self._resolve_hook(self)
        ids = np.asarray(client_ids, np.int64).reshape(-1)
        x = torch.as_tensor(x, device=self.device)
        if x.shape[0] != ids.size:
            raise ValueError(
                f"batch mismatch: {ids.size} client ids, {x.shape[0]} "
                f"feature rows")
        with self.obs.span("serve/resolve"):
            uniq, inv = np.unique(ids, return_inverse=True)
            rows_u, written = self._resolve_rows(active.state, uniq)
            # lane per request: duplicates share the resolved row
            rows = _rows(rows_u, torch.as_tensor(inv, device=self.device))
        with self.obs.span("serve/predict"):
            preds = self.strategy.predict_batched(rows, x[:, None, :])
            self.obs.fence(preds)
        preds = preds[:, 0].cpu().numpy().astype(np.int32)
        personalized = int(written[inv].sum())
        self.last_served_version = active.version
        self.obs.batch_event(version=active.version, batch=int(ids.size),
                             unique_clients=int(uniq.size),
                             personalized=personalized,
                             fallback=int(ids.size) - personalized)
        return preds
