"""Phase-span tracing: host wall time of named spans, with fences.

Counterpart of ``repro/fl/obs/tracer.py``.  A :class:`PhaseTracer`
times named spans around the round's stages (and serving's);
``fence(values)`` waits for the device (``torch.cuda.synchronize()``)
when any value holds a CUDA tensor, so a span's wall time covers the
device work it launched and not only the Python dispatch.  With
telemetry off, a :class:`NullTracer`'s hooks do nothing.  Tracing only
reads: it never feeds a value back, so traced and untraced runs compute
the same results.

Code below the engine (``core/``, the strategies) opens its spans on
:func:`current`, the tracer of the round that is running: the engine's
``run_round`` installs its telemetry there for the round (a context
variable, so threads that run no round see :data:`NULL`).  Those spans
are :data:`SUBSPANS`, named once here; they lie inside the engine's
stages and open no fence, so the next launch never waits for them.

While a ``torch.profiler`` capture records, each :class:`PhaseTracer`
span also opens a ``record_function`` of its name, so the Chrome trace
puts the device's work and gaps under the program's spans.  Without a
capture it opens none: a ``record_function`` costs about 15 µs of host
time even when nothing records.

:func:`profile_trace` wraps a run in a ``torch.profiler`` capture and
writes its Chrome trace (``trace.json``) into ``--profile-dir``.
"""
from __future__ import annotations

import contextlib
import contextvars
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
    """One live span: records ``perf_counter`` deltas into the tracer,
    and names itself to the profiler while a capture records."""

    __slots__ = ("_tracer", "_name", "_t0", "_rf")

    def __init__(self, tracer: "PhaseTracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._record(self._name, time.perf_counter() - self._t0)
        if self._rf is not None:
            self._rf.__exit__(*exc)
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


NULL = NullTracer()

# The spans below the engine's stages: the epoch key chain and the rest
# of a local epoch (``core/tm.py``), the confidence votes and the
# top-class pick (``TPFLStrategy.fused_client_step``), and the
# population eval's scatter of the cohort's rows and its votes.
SUBSPANS = ("key_chain", "train_epoch", "confidence", "top_class",
            "eval_scatter", "eval_votes")
KEY_CHAIN, TRAIN_EPOCH, CONFIDENCE, TOP_CLASS, EVAL_SCATTER, EVAL_VOTES = \
    SUBSPANS

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tracer", default=NULL)


def current():
    """The tracer of the round running in this context (:data:`NULL`
    outside a round)."""
    return _CURRENT.get()


@contextlib.contextmanager
def running(tracer):
    """Make ``tracer`` :func:`current` inside the block; the previous
    one comes back on exit, also when the block raises."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


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
