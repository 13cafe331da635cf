"""Phase-span tracing: host wall time of named spans, with fences.

Counterpart of ``repro/fl/obs/tracer.py``.  A :class:`PhaseTracer`
times named spans around the round's stages (and serving's);
``fence(values)`` waits for the device (``torch.cuda.synchronize()``)
when any value holds a CUDA tensor, so a span's wall time covers the
device work it launched and not only the Python dispatch.  With
telemetry off, a :class:`NullTracer`'s hooks do nothing.  Tracing only
reads: it never feeds a value back, so traced and untraced runs compute
the same results.

:func:`profile_trace` wraps a run in a ``torch.profiler`` capture and
writes its Chrome trace (``trace.json``) into ``--profile-dir``.
"""
from __future__ import annotations

import contextlib
import pathlib
import time

import torch


class _NullSpan:
    """Reusable zero-cost context manager — the disabled span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Telemetry off: every hook is a no-op (no timing, no fences)."""

    enabled = False

    def span(self, name: str):
        return _NULL_SPAN

    def fence(self, *values):
        pass


class _Span:
    """One live span: records ``perf_counter`` deltas into the tracer."""

    __slots__ = ("_tracer", "_name", "_t0")

    def __init__(self, tracer: "PhaseTracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._record(self._name, time.perf_counter() - self._t0)
        return False


def _has_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return any(_has_cuda(v) for v in value)
    return False


class PhaseTracer:
    """Host-side wall-time spans, accumulated until :meth:`take`.

    Re-entering a name accumulates; ``take()`` pops the ``{name:
    seconds}`` dict gathered so far."""

    enabled = True

    def __init__(self):
        self._spans: dict[str, float] = {}

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _record(self, name: str, dt: float) -> None:
        self._spans[name] = self._spans.get(name, 0.0) + dt

    def fence(self, *values) -> None:
        """Wait for the device if any value (trees allowed) holds a CUDA
        tensor, so the enclosing span bills the device work it
        launched."""
        if _has_cuda(values):
            torch.cuda.synchronize()

    def take(self) -> dict[str, float]:
        spans, self._spans = self._spans, {}
        return spans


@contextlib.contextmanager
def profile_trace(profile_dir: str | pathlib.Path | None):
    """A ``torch.profiler`` capture (host, and the GPU when there is one)
    scoped to a ``with`` block, written to ``profile_dir/trace.json``; a
    no-op when ``profile_dir`` is None."""
    if profile_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
