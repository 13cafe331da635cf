"""Wire codec for federated uploads and broadcasts: real bytes.

Counterpart of ``repro/fl/runtime/codec.py`` for the one format this
slice of the port runs, the dense ``float32`` frame: the payload is the
raw little-endian ``<f4`` vector, ``4·m`` bytes, with no header (both
endpoints know the codec and ``m``).  Every vector that crosses the
client/aggregator boundary is encoded to such a buffer and decoded back,
so the engine's byte totals are ``len`` of what would really be sent;
the frames are byte-identical to the reference's float32 frames.

The reference's int8 / int4, sparse-delta, varint+RLE index and
error-feedback formats come with the slice that runs them (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np


def encode(vec: np.ndarray) -> bytes:
    """One float vector → its float32 frame."""
    return np.asarray(vec, dtype=np.float32).ravel().astype("<f4").tobytes()


def decode(buf: bytes, m: int) -> np.ndarray:
    """A float32 frame → the float32 vector (m,); bit-exact round trip."""
    return np.frombuffer(buf, dtype="<f4", count=m).astype(np.float32)
