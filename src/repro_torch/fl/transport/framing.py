"""Length-prefixed message framing for the federated transport.

Counterpart of ``repro/fl/transport/framing.py``, its code line for
line: the port and the reference put the same bytes on the wire.

Every message on the wire — loopback queue or real socket — is one frame:

    magic  <u2>   0x7F4C ("FL")
    kind   <u1>   message kind (see messages.MsgKind)
    length <u4>   payload byte count
    payload       `length` bytes, opaque to this layer

Little-endian throughout, matching the wire codec.  The framing layer is
deliberately loud: a bad magic, an oversized length prefix, or a stream
that ends mid-frame each raise a *typed* error instead of yielding a
silently truncated payload — the robustness tests pin each failure mode.
"""
from __future__ import annotations

import struct

MAGIC = 0x7F4C
HEADER = struct.Struct("<HBI")          # magic, kind, payload length
MAX_FRAME = 1 << 30                     # 1 GiB: anything larger is a bug


class WireError(Exception):
    """Base class for transport wire faults."""


class BadMagicError(WireError):
    """Frame header does not start with the FL magic (corrupted length
    prefix or desynchronized stream)."""


class FrameTooLargeError(WireError):
    """Length prefix exceeds MAX_FRAME — a corrupted header, not a real
    payload."""


class TruncatedFrameError(WireError):
    """Stream ended inside a frame (header or payload cut short)."""


class DisconnectError(WireError):
    """Peer closed the connection at a frame boundary when more frames
    were expected."""


def pack_frame(kind: int, payload: bytes) -> bytes:
    """One message → header + payload bytes."""
    if len(payload) > MAX_FRAME:
        raise FrameTooLargeError(
            f"refusing to send {len(payload)} B payload "
            f"(MAX_FRAME = {MAX_FRAME} B)")
    return HEADER.pack(MAGIC, kind, len(payload)) + payload


def unpack_header(buf: bytes) -> tuple[int, int]:
    """Header bytes → (kind, payload_length); loud on every corruption."""
    if len(buf) < HEADER.size:
        raise TruncatedFrameError(
            f"stream ended inside frame header "
            f"({len(buf)} of {HEADER.size} B)")
    magic, kind, length = HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise BadMagicError(
            f"bad frame magic 0x{magic:04X} (expected 0x{MAGIC:04X}); "
            "corrupted length prefix or desynchronized stream")
    if length > MAX_FRAME:
        raise FrameTooLargeError(
            f"frame length prefix {length} B exceeds "
            f"MAX_FRAME = {MAX_FRAME} B; corrupted header")
    return kind, length


def read_frame(recv_exact) -> tuple[int, bytes]:
    """Read one frame via ``recv_exact(n) -> bytes`` (may return short
    only at EOF).  Returns (kind, payload).

    Raises :class:`DisconnectError` on EOF at a frame boundary and
    :class:`TruncatedFrameError` on EOF inside a frame.
    """
    head = recv_exact(HEADER.size)
    if not head:
        raise DisconnectError("peer closed connection between frames")
    kind, length = unpack_header(head)
    payload = recv_exact(length)
    if len(payload) != length:
        raise TruncatedFrameError(
            f"stream ended inside payload "
            f"({len(payload)} of {length} B)")
    return kind, payload


def decode_frame(buf: bytes) -> tuple[int, bytes, int]:
    """Decode one frame from a byte buffer → (kind, payload, consumed).
    Loud on truncation, like the stream path."""
    kind, length = unpack_header(buf)
    end = HEADER.size + length
    if len(buf) < end:
        raise TruncatedFrameError(
            f"buffer ended inside payload "
            f"({len(buf) - HEADER.size} of {length} B)")
    return kind, buf[HEADER.size:end], end
