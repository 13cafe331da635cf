"""Device operations and device time by the program span that launched
them.

:func:`reduce_profile` returns what ``bench.trace.reduce_profile`` does
for the same capture, unchanged, and two keys more:

* ``launches_by_span`` ``{span: n}``: every device operation that
  ``trace.reduce_profile`` keeps (a kernel, copy or set within the
  profiled cycle), counted under the span that launched it;
* ``device_s_by_span`` ``{span: s}``: their device time, clipped to the
  cycle as ``kernel_s`` is, so the two sum to the same seconds.

An operation's launch is the CUDA runtime or driver call with its
correlation id (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cuLaunchKernel``, ...: the host events named ``cu...``; the
profiler's frontend events number themselves apart, so an id alone
can name an ``aten::`` op as well).  The id alone decides: the device's
timestamps can sit milliseconds off the host's in a capture (an H100
capture put every operation 1.84 ms before its own call), so no rule
of time order is used.  The span is the innermost span open at that
call's host start: the rule ``trace.reduce_profile`` gives an idle gap,
and its label for no span, which also takes an operation whose call the
capture lacks.
"""
from __future__ import annotations

import bisect

from bench import trace

OUTSIDE = "outside the engine's spans"
RUNTIME = "cu"


def _innermost(host, starts, t: float) -> str:
    """The span of ``host`` (sorted by start) that started last among
    those open at ``t``."""
    for hs, he, name in reversed(host[:bisect.bisect_right(starts, t)]):
        if t < he:
            return name
    return OUTSIDE


def by_span(events, span_names) -> dict:
    """``{"launches_by_span", "device_s_by_span"}`` of the profiled
    cycle among ``events`` (the ``CYCLE`` annotation); ``{}`` without
    it."""
    cyc = [e for e in events if e.name == trace.CYCLE
           and not trace._is_device(e)]
    if not cyc:
        return {}
    t0, t1 = cyc[0].time_range.start, cyc[0].time_range.end
    marks = set(span_names) | {trace.CYCLE}
    calls = {e.id: e.time_range.start for e in events
             if not trace._is_device(e) and e.name.startswith(RUNTIME)}
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not trace._is_device(e)
                  and e.name in span_names)
    starts = [h[0] for h in host]
    launches: dict[str, int] = {}
    device_s: dict[str, float] = {}
    for e in events:
        s, f = e.time_range.start, e.time_range.end
        if not trace._is_device(e) or e.name in marks or f <= t0 \
                or s >= t1:
            continue
        at = calls.get(e.id)
        label = OUTSIDE if at is None else _innermost(host, starts, at)
        launches[label] = launches.get(label, 0) + 1
        device_s[label] = (device_s.get(label, 0.0)
                           + (min(t1, f) - max(t0, s)) * 1e-6)
    return {"launches_by_span": launches, "device_s_by_span": device_s}


def reduce_profile(prof, span_names) -> dict:
    """``trace.reduce_profile``'s keys and :func:`by_span`'s."""
    out = trace.reduce_profile(prof, span_names)
    if out:
        out.update(by_span(list(prof.events()), span_names))
    return out
