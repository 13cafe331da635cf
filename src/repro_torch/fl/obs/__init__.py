"""Federated telemetry plane, counterpart of ``repro/fl/obs``.

* phase spans (:mod:`.tracer`): host wall time per round stage, fenced
  with ``torch.cuda.synchronize()``, and an optional ``torch.profiler``
  capture;
* structured round events (:mod:`.events`, :mod:`.manifest`,
  :mod:`.recorder`): one JSONL event a round next to a run manifest;
* a consumer (:mod:`.summarize`):
  ``python -m repro_torch.fl.obs summarize <run-dir>``.

None of it perturbs the round: telemetry on and off give the same bits.
"""
from repro_torch.fl.obs.events import (SCHEMA_VERSION, accuracy_deciles,
                                       append_event, read_events,
                                       round_event, to_jsonable,
                                       worst_decile_mean)
from repro_torch.fl.obs.manifest import (build_manifest, git_sha,
                                         read_manifest, write_manifest)
from repro_torch.fl.obs.recorder import NULL, NullTelemetry, RunRecorder
from repro_torch.fl.obs.summarize import phase_medians, summarize
from repro_torch.fl.obs.tracer import NullTracer, PhaseTracer, profile_trace

__all__ = [
    "SCHEMA_VERSION", "accuracy_deciles", "append_event", "read_events",
    "round_event", "to_jsonable", "worst_decile_mean",
    "build_manifest", "git_sha", "read_manifest", "write_manifest",
    "NULL", "NullTelemetry", "RunRecorder",
    "phase_medians", "summarize",
    "NullTracer", "PhaseTracer", "profile_trace",
]
