"""Serve-side observability: request spans and registry events as JSONL.

Counterpart of ``repro/fl/serve/telemetry.py``.  A
:class:`ServeTelemetry` is a :class:`~repro_torch.fl.obs.tracer.PhaseTracer`
(the plane wraps resolve / predict in ``span(...)`` with ``fence`` on the
device output) plus an event sink appending one JSON object per line to
``serve_events.jsonl`` in the run directory:

* ``{"event": "batch", ...}``   — one per served request batch: size,
  active version, wall latency, personalized-vs-fallback row counts,
  and the batch's phase spans;
* ``{"event": "swap", ...}``    — one per atomic warm swap (old and new
  versions; old is None for the first activation);
* ``{"event": "publish", ...}`` — one per checkpoint ``fed_serve``
  published into the registry.

Nothing the telemetry computes flows back into resolution or inference:
serving with :data:`NULL_SERVE` (the default) gives the same predictions
as serving instrumented.
"""
from __future__ import annotations

import pathlib

from repro_torch.fl.obs import events
from repro_torch.fl.obs.tracer import NullTracer, PhaseTracer

EVENTS_NAME = "serve_events.jsonl"


class NullServeTelemetry(NullTracer):
    """Serving uninstrumented: every hook is a no-op."""

    def batch_event(self, **fields) -> None:
        pass

    def swap_event(self, old: int | None, new: int) -> None:
        pass

    def publish_event(self, version: int, path) -> None:
        pass


NULL_SERVE = NullServeTelemetry()


class ServeTelemetry(PhaseTracer):
    """Span timing + JSONL event sink for one serving run."""

    def __init__(self, run_dir: str | pathlib.Path):
        super().__init__()
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.events_path = self.run_dir / EVENTS_NAME

    def _emit(self, event: dict) -> dict:
        return events.append_event(self.events_path, event)

    def batch_event(self, **fields) -> dict:
        """One served batch; pops the batch's accumulated spans and
        reports their sum as the batch's wall latency."""
        phases = self.take()
        return self._emit({"event": "batch", "phases": phases,
                           "latency_s": sum(phases.values()), **fields})

    def swap_event(self, old: int | None, new: int) -> dict:
        return self._emit({"event": "swap", "from_version": old,
                           "to_version": new})

    def publish_event(self, version: int, path) -> dict:
        return self._emit({"event": "publish", "version": version,
                           "path": str(path)})
