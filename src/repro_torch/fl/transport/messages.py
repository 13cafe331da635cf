"""Typed message payloads for the federated transport.

Counterpart of ``repro/fl/transport/messages.py``, its code line for
line (numpy only): every message packs to the reference's bytes.

One message = one frame (``framing.py``); this module owns what lives
*inside* the payload.  Everything is little-endian and explicitly
sized — the same buffer parses identically on both ends of a socket,
and a truncated payload raises loudly through :class:`Reader`.

The round protocol (server ↔ each worker, per round):

    server → worker   WORK      round, encoded server rows, the worker's
                                sampled clients (id, rng key, active,
                                scheduled staleness)
    worker → server   UPLOAD    the round's codec frames per client —
                                the *actual* uplink bytes, tagged with
                                source round for observed staleness
    server → worker   DOWNLINK  post-aggregate rows + per-client
                                arrive/applied routing
    worker → server   EVAL      the worker block's per-client accuracy

plus HELLO (worker handshake), SHUTDOWN (server → worker, run over) and
BYE (worker's acknowledgement).  The uplink codec frame itself (slot id
+ encoded vector, ``fl/runtime/codec.py``) is carried opaquely: the
engine's byte meter counts exactly those frame bytes, while the wire
gauges (``wire_tx/wire_rx``) count whole framed messages — envelopes,
headers and all.
"""
from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

from repro_torch.fl.transport.framing import WireError


class MsgKind(enum.IntEnum):
    HELLO = 1
    WORK = 2
    UPLOAD = 3
    DOWNLINK = 4
    EVAL = 5
    SHUTDOWN = 6
    BYE = 7


_U1 = struct.Struct("<B")
_U4 = struct.Struct("<I")
_I4 = struct.Struct("<i")
_F4 = struct.Struct("<f")


class Writer:
    """Append-only little-endian payload builder."""

    def __init__(self):
        self._parts: list[bytes] = []

    def u1(self, v: int):
        self._parts.append(_U1.pack(v))

    def u4(self, v: int):
        self._parts.append(_U4.pack(v))

    def i4(self, v: int):
        self._parts.append(_I4.pack(v))

    def f4(self, v: float):
        self._parts.append(_F4.pack(v))

    def blob(self, b: bytes):
        """Length-prefixed byte string (u4 length + raw bytes)."""
        self._parts.append(_U4.pack(len(b)))
        self._parts.append(bytes(b))

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    """Sequential little-endian payload parser; loud on truncation."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def _take(self, n: int) -> bytes:
        end = self.off + n
        if end > len(self.buf):
            raise WireError(
                f"message payload truncated: wanted {n} B at offset "
                f"{self.off}, have {len(self.buf)} B total")
        out = self.buf[self.off:end]
        self.off = end
        return out

    def u1(self) -> int:
        return _U1.unpack(self._take(1))[0]

    def u4(self) -> int:
        return _U4.unpack(self._take(4))[0]

    def i4(self) -> int:
        return _I4.unpack(self._take(4))[0]

    def f4(self) -> float:
        return _F4.unpack(self._take(4))[0]

    def blob(self) -> bytes:
        return self._take(self.u4())

    def done(self):
        if self.off != len(self.buf):
            raise WireError(
                f"message payload has {len(self.buf) - self.off} "
                f"trailing bytes past the parsed structure")


# -- handshake ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hello:
    rank: int
    lo: int          # the worker's client block is [lo, hi)
    hi: int

    def pack(self) -> bytes:
        w = Writer()
        w.u4(self.rank), w.u4(self.lo), w.u4(self.hi)
        return w.getvalue()

    @classmethod
    def unpack(cls, buf: bytes) -> "Hello":
        r = Reader(buf)
        out = cls(rank=r.u4(), lo=r.u4(), hi=r.u4())
        r.done()
        return out


# -- server → worker: the round's work order ---------------------------------

@dataclasses.dataclass(frozen=True)
class WorkClient:
    gidx: int        # global client id
    key: tuple       # raw PRNGKey words (uint32, uint32)
    active: bool     # survived the dropout draw
    staleness: int   # scheduled upload delay in rounds


@dataclasses.dataclass(frozen=True)
class Work:
    round_idx: int
    dim: int                      # server row width d
    rows: tuple                   # n_slots dense codec frames (bytes)
    clients: tuple                # WorkClient — this worker's sampled ids

    def pack(self) -> bytes:
        w = Writer()
        w.u4(self.round_idx), w.u4(self.dim), w.u4(len(self.rows))
        for row in self.rows:
            w.blob(row)
        w.u4(len(self.clients))
        for c in self.clients:
            w.u4(c.gidx)
            w.u4(int(c.key[0])), w.u4(int(c.key[1]))
            w.u1(1 if c.active else 0)
            w.u4(c.staleness)
        return w.getvalue()

    @classmethod
    def unpack(cls, buf: bytes) -> "Work":
        r = Reader(buf)
        round_idx, dim, n_rows = r.u4(), r.u4(), r.u4()
        rows = tuple(r.blob() for _ in range(n_rows))
        clients = tuple(
            WorkClient(gidx=r.u4(), key=(r.u4(), r.u4()),
                       active=bool(r.u1()), staleness=r.u4())
            for _ in range(r.u4()))
        r.done()
        return cls(round_idx, dim, rows, clients)


# -- worker → server: real uplink frames -------------------------------------

@dataclasses.dataclass(frozen=True)
class UploadEntry:
    gidx: int
    src_round: int   # round the upload was produced (arrival − src =
    #                  observed staleness)
    staleness: int   # scheduled delay tag (sync barrier accounting)
    frames: tuple    # (j_idx, slot, frame_bytes) per shared slot; the
    #                  frame is the codec's slot-id+payload unit — the
    #                  byte-metered quantity; j_idx is envelope


@dataclasses.dataclass(frozen=True)
class Upload:
    round_idx: int   # arrival round (the WORK round being answered)
    entries: tuple

    def pack(self) -> bytes:
        w = Writer()
        w.u4(self.round_idx), w.u4(len(self.entries))
        for e in self.entries:
            w.u4(e.gidx), w.u4(e.src_round), w.u4(e.staleness)
            w.u4(len(e.frames))
            for j_idx, slot, frame in e.frames:
                w.u1(j_idx), w.i4(slot)
                w.blob(frame)
        return w.getvalue()

    @classmethod
    def unpack(cls, buf: bytes) -> "Upload":
        r = Reader(buf)
        round_idx, n = r.u4(), r.u4()
        entries = []
        for _ in range(n):
            gidx, src, stale = r.u4(), r.u4(), r.u4()
            frames = tuple((r.u1(), r.i4(), r.blob())
                           for _ in range(r.u4()))
            entries.append(UploadEntry(gidx, src, stale, frames))
        r.done()
        return cls(round_idx, tuple(entries))


# -- server → worker: broadcast + routing ------------------------------------

@dataclasses.dataclass(frozen=True)
class DownClient:
    gidx: int
    arrive: bool     # applies the broadcast (sync: made the barrier)
    applied: tuple   # j_slots slot ids (−1 = nothing applied)


@dataclasses.dataclass(frozen=True)
class Downlink:
    round_idx: int
    dim: int
    rows: tuple                   # post-aggregate rows, dense frames
    clients: tuple                # DownClient per sampled block client

    def pack(self) -> bytes:
        w = Writer()
        w.u4(self.round_idx), w.u4(self.dim), w.u4(len(self.rows))
        for row in self.rows:
            w.blob(row)
        j = len(self.clients[0].applied) if self.clients else 0
        w.u4(j), w.u4(len(self.clients))
        for c in self.clients:
            w.u4(c.gidx), w.u1(1 if c.arrive else 0)
            for s in c.applied:
                w.i4(int(s))
        return w.getvalue()

    @classmethod
    def unpack(cls, buf: bytes) -> "Downlink":
        r = Reader(buf)
        round_idx, dim, n_rows = r.u4(), r.u4(), r.u4()
        rows = tuple(r.blob() for _ in range(n_rows))
        j, n = r.u4(), r.u4()
        clients = tuple(
            DownClient(gidx=r.u4(), arrive=bool(r.u1()),
                       applied=tuple(r.i4() for _ in range(j)))
            for _ in range(n))
        r.done()
        return cls(round_idx, dim, rows, clients)


# -- worker → server: block evaluation ---------------------------------------

@dataclasses.dataclass(frozen=True)
class Eval:
    round_idx: int
    acc: np.ndarray               # (block_size,) float32

    def pack(self) -> bytes:
        w = Writer()
        w.u4(self.round_idx)
        w.blob(np.asarray(self.acc, np.float32).tobytes())
        return w.getvalue()

    @classmethod
    def unpack(cls, buf: bytes) -> "Eval":
        r = Reader(buf)
        round_idx = r.u4()
        acc = np.frombuffer(r.blob(), np.float32)
        r.done()
        return cls(round_idx, acc)
