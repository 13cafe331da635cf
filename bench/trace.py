"""Spans around the engine's stages and the reduction of a device trace.

:class:`Spans` is the telemetry the engine's ``run_round`` calls
(``span(name)``, ``fence(*values)``): each span's host wall time is
added up by name, and, with ``fenced``, the span waits for the device
at its end, so its time covers the device work it launched.  Each span
also opens a ``torch.profiler.record_function`` of its name, so a
profiled cycle tells which span the host was in when the device idled.

:func:`reduce_profile` turns a ``torch.profiler`` capture of one cycle
into the device's busy time (the union of its kernel, copy and set
intervals, so overlapping work counts once), each kernel's summed
device time, and the breakdown: the top device operations and the idle
time by host span.
"""
from __future__ import annotations

import time

import torch

CYCLE = "bench_cycle"


class _Span:
    __slots__ = ("_spans", "_name", "_t0", "_rf")

    def __init__(self, spans, name):
        self._spans, self._name = spans, name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        self._spans.totals[self._name] = (
            self._spans.totals.get(self._name, 0.0) + dt)
        return False


class Spans:
    def __init__(self, fenced: bool):
        self.fenced = fenced
        self.totals: dict[str, float] = {}

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def fence(self, *values) -> None:
        if self.fenced and torch.cuda.is_available():
            torch.cuda.synchronize()


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def reduce_profile(prof, span_names) -> dict:
    """``{"window_s", "busy_s", "kernel_s": {name: s}, "device_ops",
    "idle_gaps"}`` of the profiled cycle (the ``CYCLE`` annotation)."""
    events = list(prof.events())
    cyc = [e for e in events if e.name == CYCLE and not _is_device(e)]
    if not cyc:
        return {}
    t0, t1 = cyc[0].time_range.start, cyc[0].time_range.end
    # the annotations' own ranges on the device timeline are no work
    marks = set(span_names) | {CYCLE}
    dev = sorted((max(t0, e.time_range.start), min(t1, e.time_range.end),
                  e.name) for e in events if _is_device(e)
                 and e.name not in marks and e.time_range.end > t0
                 and e.time_range.start < t1)
    busy, gaps, cur_end = 0.0, [], t0
    for s, e, _ in dev:
        if s > cur_end:
            gaps.append((cur_end, s))
        if e > cur_end:
            busy += e - max(s, cur_end)
            cur_end = e
    if t1 > cur_end:
        gaps.append((cur_end, t1))
    by_kernel: dict[str, float] = {}
    for s, e, name in dev:
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s) * 1e-6
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _is_device(e)
                  and e.name in span_names)
    idle: dict[str, float] = {}
    for gs, ge in gaps:
        label = "outside the engine's spans"
        for hs, he, name in host:          # the innermost span open at gs
            if hs <= gs < he:
                label = name
        idle[label] = idle.get(label, 0.0) + (ge - gs) * 1e-6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "kernel_s": by_kernel,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]]}
