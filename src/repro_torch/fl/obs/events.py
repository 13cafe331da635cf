"""Structured round events: every ``RoundReport`` plus derived gauges,
one JSON object per line.

Counterpart of ``repro/fl/obs/events.py``, with the same schema.  The
event is built *from* the report; nothing here reaches into the round's
math:

* ``accuracy``: mean, the 11 decile quantiles of the per-client
  accuracy and the worst-decile mean;
* ``cluster``: per-slot contributor counts, slot occupancy and per-slot
  accuracy from the assignment, the empty-slot retention rate and the
  assignment churn against the previous round;
* ``scheduler``: sampled / dropped / straggler counts and the staleness
  histogram (``Participation.summary()``);
* ``bytes``: codec-metered wire traffic by direction;
* ``async``: aggregated / still-buffered / evicted uploads (sync: the
  last two are 0);
* ``store``: the mmap client store's host I/O this round (0 on the
  resident engine);
* ``transport``: the framed bytes the real transport (loopback or
  socket, ``repro_torch.fl.transport``) put on and took off the wire
  this round and, under async aggregation, the observed staleness of
  the uploads that arrived; ``None`` in process, where nothing crosses
  a wire;
* ``phases``: the round's phase-span wall times, the transport's
  ``wire_tx`` / ``wire_rx`` spans and the spans inside the stages
  (``tracer.SUBSPANS``) included.

:func:`to_jsonable` coerces numpy and torch scalars and arrays, paths and
non-finite floats into plain JSON values before anything is written.
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Any

import numpy as np
import torch

SCHEMA_VERSION = 1

# decile grid: 0 % (worst client) through 100 % (best), step 10
_DECILES = np.linspace(0.0, 1.0, 11)


def to_jsonable(value: Any) -> Any:
    """Recursively coerce a value into plain JSON types: numpy and torch
    scalars and arrays (→ nested lists), paths (→ str), NaN and ±inf
    (→ None, since JSON has no spelling for them)."""
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    if isinstance(value, pathlib.Path):
        return str(value)
    if isinstance(value, torch.Tensor):
        return to_jsonable(value.detach().cpu().tolist())
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        f = float(value)
        return f if math.isfinite(f) else None
    if isinstance(value, np.ndarray):
        return to_jsonable(value.tolist())
    return value


def as_numpy(value, dtype=None) -> np.ndarray:
    """A numpy copy or view of a tensor (any device) or array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype)


def accuracy_deciles(per_client_accuracy) -> list[float]:
    """The 11 decile quantiles (worst client … best) of the accuracies."""
    acc = as_numpy(per_client_accuracy, np.float64).ravel()
    return [float(q) for q in np.quantile(acc, _DECILES)]


def worst_decile_mean(per_client_accuracy) -> float:
    """Mean accuracy of the worst 10 % of clients (at least one)."""
    acc = np.sort(as_numpy(per_client_accuracy, np.float64).ravel())
    k = max(1, int(np.ceil(acc.size / 10)))
    return float(acc[:k].mean())


def _cluster_gauges(report, prev_assignment) -> dict:
    counts = as_numpy(report.cluster_counts, np.float64)
    assignment = as_numpy(report.assignment)
    acc = as_numpy(report.per_client_accuracy, np.float64)
    n_slots = counts.shape[0]
    # a client occupies every slot it shares into (−1 = none)
    occupancy = np.zeros(n_slots, np.int64)
    slot_acc_sum = np.zeros(n_slots, np.float64)
    for j in range(assignment.shape[1] if assignment.ndim == 2 else 0):
        col = assignment[:, j]
        shared = col >= 0
        np.add.at(occupancy, col[shared], 1)
        np.add.at(slot_acc_sum, col[shared], acc[shared])
    slot_accuracy = [
        float(slot_acc_sum[s] / occupancy[s]) if occupancy[s] else None
        for s in range(n_slots)]
    churn = None
    if prev_assignment is not None:
        prev = as_numpy(prev_assignment)
        if prev.shape == assignment.shape:
            churn = float((prev != assignment).any(axis=-1).mean())
    return {
        "counts": counts.tolist(),
        "populated_slots": int((counts > 0).sum()),
        "empty_slot_retention_rate": float((counts == 0).mean()),
        "occupancy": occupancy.tolist(),
        "slot_accuracy": slot_accuracy,
        "churn_vs_prev": churn,
    }


def round_event(report, spans: dict | None = None,
                prev_assignment=None) -> dict:
    """One structured event from a ``RoundReport`` (duck-typed: the obs
    layer does not import the runtime).  Pure derivation."""
    part = report.participation
    return {
        "schema": SCHEMA_VERSION,
        "round": int(report.round_idx),
        "accuracy": {
            "mean": float(report.mean_accuracy),
            "deciles": accuracy_deciles(report.per_client_accuracy),
            "worst_decile_mean": worst_decile_mean(
                report.per_client_accuracy),
        },
        "cluster": _cluster_gauges(report, prev_assignment),
        "scheduler": part.summary() if hasattr(part, "summary") else None,
        "bytes": {
            "upload": int(report.upload_bytes),
            "download_broadcast": int(report.download_bytes_broadcast),
            "download_per_client": int(report.download_bytes_per_client),
        },
        "async": {
            "aggregated": int(report.aggregated_uploads),
            "buffered": int(report.buffered_uploads),
            "evicted": int(report.evicted_uploads),
        },
        "store": {
            "read_bytes": int(getattr(report, "store_read_bytes", 0)),
            "written_bytes": int(getattr(report, "store_written_bytes", 0)),
        },
        "transport": _transport_gauges(report),
        "phases": dict(spans) if spans else None,
    }


def _transport_gauges(report) -> dict | None:
    """Per-direction framed-byte gauges and the observed arrival
    staleness of the real transport; ``None`` when nothing crossed a
    process wire (the in-process engine)."""
    tx = int(getattr(report, "wire_tx_bytes", 0))
    rx = int(getattr(report, "wire_rx_bytes", 0))
    observed = getattr(report, "observed_staleness", None)
    if tx == 0 and rx == 0 and observed is None:
        return None
    gauges = {"wire_tx_bytes": tx, "wire_rx_bytes": rx}
    if observed is not None:
        # the runner's arrival_participation(...).summary() dict
        gauges["observed"] = observed
    return gauges


def append_event(path: str | pathlib.Path, event: dict) -> dict:
    """Append one event as a JSONL line and return the jsonable form
    that was written."""
    jsonable = to_jsonable(event)
    with open(path, "a") as f:
        f.write(json.dumps(jsonable, sort_keys=True) + "\n")
    return jsonable


def read_events(path: str | pathlib.Path) -> list[dict]:
    """Load a run's ``events.jsonl`` back into a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
