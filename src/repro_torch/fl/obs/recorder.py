"""The run recorder: one object the engine talks telemetry through.

Counterpart of ``repro/fl/obs/recorder.py``.  The engine holds one
``telemetry`` object and calls four hooks: ``span(name)`` /
``fence(values)`` around each round stage, ``on_round(report)`` after
each round, and reads ``manifest`` when it checkpoints.  :data:`NULL`
(telemetry off, the default) answers all of them as no-ops;
:class:`RunRecorder` times the spans, derives the round event and
appends it to the run directory:

    run-dir/
      manifest.json    config, seed, devices, git sha, torch / CUDA
      events.jsonl     one structured event per round

A recorder without a run directory records in memory only
(``history``).  It only consumes round outputs and host clocks: nothing
it computes flows back into the engine, so telemetry on and off give
the same bits (``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import pathlib

import numpy as np

from repro_torch.fl.obs import events as ev
from repro_torch.fl.obs import manifest as mf
from repro_torch.fl.obs.tracer import NullTracer, PhaseTracer, profile_trace


class NullTelemetry(NullTracer):
    """Telemetry disabled: every hook a no-op, shared singleton."""

    manifest = None

    def on_round(self, report) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullTelemetry()


class RunRecorder(PhaseTracer):
    """Telemetry enabled: spans and structured events, plus an optional
    ``torch.profiler`` capture into ``profile_dir`` (see :meth:`start`)."""

    def __init__(self, run_dir: str | pathlib.Path | None = None,
                 profile_dir: str | pathlib.Path | None = None):
        super().__init__()
        self.run_dir = pathlib.Path(run_dir) if run_dir else None
        self.events_path = (self.run_dir / mf.EVENTS_NAME
                            if self.run_dir else None)
        self.profile_dir = profile_dir
        self.manifest: dict | None = None
        self.history: list[dict] = []      # jsonable events, in order
        self._prev_assignment = None
        self._profile_ctx = None

    def start(self, manifest: dict | None = None) -> "RunRecorder":
        """Write the manifest (with a run dir) and start the profiler
        capture (with a profile dir); call before the first round."""
        self.manifest = manifest
        if self.run_dir is not None:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            if manifest is not None:
                mf.write_manifest(self.run_dir, manifest)
        if self.profile_dir is not None and self._profile_ctx is None:
            self._profile_ctx = profile_trace(self.profile_dir)
            self._profile_ctx.__enter__()
        return self

    def close(self) -> None:
        """Stop the profiler capture (events are flushed per round)."""
        if self._profile_ctx is not None:
            ctx, self._profile_ctx = self._profile_ctx, None
            ctx.__exit__(None, None, None)

    def on_round(self, report) -> dict:
        """Derive this round's event from the report and the spans since
        the last call, and append it to the log."""
        event = ev.round_event(report, spans=self.take(),
                               prev_assignment=self._prev_assignment)
        self._prev_assignment = np.array(ev.as_numpy(report.assignment))
        if self.events_path is not None:
            event = ev.append_event(self.events_path, event)
        else:
            event = ev.to_jsonable(event)
        self.history.append(event)
        return event
