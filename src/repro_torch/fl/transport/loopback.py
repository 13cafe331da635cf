"""LoopbackTransport: the in-memory reference transport.

Counterpart of ``repro/fl/transport/loopback.py``, its code line for
line.

Every message still becomes real framed bytes — ``send`` packs the
frame, hands the *bytes* to the worker's decode path, and the worker's
responses queue as framed bytes for ``recv`` — so the whole wire stack
(framing, message pack/unpack, codec frames) is exercised exactly as
the socket transport exercises it, minus the kernel socket.  That is
what lets the conformance suite pin a loopback run bit-identical to the
in-process engine on the identity wire: same math, same bytes, no
process boundary to make timing nondeterministic.

Fault injection: a :class:`~repro_torch.fl.transport.faults.FaultPlan`
``disconnect`` entry makes the n-th ``recv`` from a rank raise
:class:`~repro_torch.fl.transport.framing.DisconnectError` once, with the
queued frame left intact for the retry — deterministic food for the
server's retry/backoff loop.
"""
from __future__ import annotations

import collections

from repro_torch.fl.transport import framing
from repro_torch.fl.transport.faults import FaultPlan


class LoopbackTransport:
    """In-memory transport over a list of in-process ClientWorkers."""

    def __init__(self, workers, faults: FaultPlan | None = None):
        self.workers = {w.rank: w for w in workers}
        self.ranks = sorted(self.workers)
        self.faults = faults or FaultPlan()
        self._inbox = {r: collections.deque() for r in self.ranks}
        self._recv_count = {r: 0 for r in self.ranks}

    def send(self, rank: int, kind: int, payload: bytes) -> int:
        """Frame the message, run it through the worker, queue the
        worker's framed responses.  Returns framed bytes sent."""
        frame = framing.pack_frame(kind, payload)
        in_kind, in_payload, consumed = framing.decode_frame(frame)
        if consumed != len(frame):
            raise framing.WireError(
                f"loopback frame has {len(frame) - consumed} stray bytes")
        for out_kind, out_payload in self.workers[rank].handle(
                in_kind, in_payload):
            self._inbox[rank].append(
                framing.pack_frame(out_kind, out_payload))
        return len(frame)

    def recv(self, rank: int, timeout: float | None = None
             ) -> tuple[int, bytes, int]:
        """Pop the next queued frame → (kind, payload, framed_bytes).
        ``timeout`` is accepted for interface parity and ignored — the
        loopback queue is synchronous."""
        nth = self._recv_count[rank]
        self._recv_count[rank] += 1
        if self.faults.disconnects_at(rank, nth):
            raise framing.DisconnectError(
                f"injected disconnect: recv #{nth} from worker {rank}")
        if not self._inbox[rank]:
            raise framing.WireError(
                f"protocol error: no frame pending from worker {rank}")
        frame = self._inbox[rank].popleft()
        kind, payload, _ = framing.decode_frame(frame)
        return kind, payload, len(frame)

    def reconnect(self, rank: int) -> None:
        """Nothing to re-establish in memory; the retry just re-reads."""

    def close(self) -> None:
        pass
