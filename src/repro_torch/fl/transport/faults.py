"""Deterministic fault injection + retry policy for the transport.

Counterpart of ``repro/fl/transport/faults.py``, its code line for line.

Real networks delay, drop and disconnect; the robustness tests need
those behaviours on demand and *reproducibly*.  A :class:`FaultPlan` is
a static schedule — no randomness, no wall clock — so a test can assert
exactly which upload went missing and when a retry had to fire:

* ``delay``      — ``(round, client, extra)``: the client's upload is
  held ``extra`` additional rounds before the worker sends it (async
  mode; under a sync barrier added delay means missing the barrier).
* ``drop``       — ``(round, client)``: the upload of that round is
  lost outright — the worker never sends it.
* ``disconnect`` — ``(rank, nth_recv)``: the server's n-th ``recv``
  from that worker (0-based, counted per rank over the run) raises
  :class:`~repro_torch.fl.transport.framing.DisconnectError` once; the frame
  is delivered intact on the retry.  This exercises the server's
  per-client retry/backoff loop without a real flaky link.

:class:`RetryPolicy` bounds how the server waits: ``attempts`` tries
per expected message, ``timeout`` seconds of socket wait per try, and
an exponential ``backoff`` sleep between tries.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    delay: tuple = ()        # ((round, client, extra_rounds), ...)
    drop: tuple = ()         # ((round, client), ...)
    disconnect: tuple = ()   # ((rank, nth_recv), ...)

    def delay_for(self, round_idx: int, client: int) -> int:
        return sum(extra for r, c, extra in self.delay
                   if r == round_idx and c == client)

    def dropped(self, round_idx: int, client: int) -> bool:
        return any(r == round_idx and c == client for r, c in self.drop)

    def disconnects_at(self, rank: int, nth_recv: int) -> bool:
        return any(rk == rank and n == nth_recv
                   for rk, n in self.disconnect)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    attempts: int = 3        # tries per expected message, >= 1
    timeout: float = 60.0    # seconds of blocking wait per try (socket)
    backoff: float = 0.05    # sleep before retry k is backoff * 2**k

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("RetryPolicy.attempts must be >= 1")
