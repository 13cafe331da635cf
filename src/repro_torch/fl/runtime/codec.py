"""Wire codec for federated uploads and broadcasts: real bytes.

Counterpart of ``repro/fl/runtime/codec.py``, copied numpy for numpy
(the reference module is numpy-only, but its package imports jax).
Every vector that crosses the client/aggregator boundary is encoded to
an actual ``bytes`` buffer and decoded back before aggregation, so the
engine's byte totals are ``len`` of what would really be sent, and the
lossy codecs perturb the aggregate as they would in deployment.  Every
frame, decoded vector and error-feedback residual is bit for bit the
reference's (``tests/test_torch_codec.py``): each float step is the same
numpy operation on the same numpy semantics, on the host.

Formats (little-endian throughout; the codec config is shared out of
band by both endpoints, so frames carry no codec or type tags):

* ``float32`` dense: the raw ``<f4`` vector, ``4·m`` bytes.
* ``int8`` dense: ``scale <f4`` + ``m`` bytes; symmetric quantization
  ``q = rint(x / scale)``, ``scale = max|x| / 127``.
* ``int4`` dense: ``scale <f4`` + ``ceil(m/2)`` bytes; nibbles
  ``q ∈ [−7, 7]`` biased by +8, two per byte.
* sparse delta (``sparse=True``, any dtype): the encoder subtracts the
  shared reference ``ref``, quantizes the delta and sends only its
  nonzero entries: ``flag u1`` (1) + [``scale <f4``] + ``count <u4`` +
  ``count·(idx <u2 + value)``.  When that is not smaller than the dense
  frame, or the vector is longer than ``<u2`` addresses, the encoder
  falls back to dense (``flag`` 0).  The engine tracks the reference
  per client (``EngineState.ref_vecs``).
* ``index_coding="vrle"``: the sparse index stream as run-length pairs
  of LEB128 varints: ``flag`` 2 + [``scale <f4``] + ``varint count`` +
  ``varint n_runs`` + ``n_runs·(varint gap, varint run_len)`` + values;
  vectors of any length.
* ``error_feedback=True``: the sender keeps a residual per (client,
  slot), encodes ``vec + residual`` (:func:`ef_encode`) and keeps this
  frame's quantization error as the next residual.  Lossy codecs only.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

CODECS = ("float32", "int8", "int4")
INDEX_CODINGS = ("u2", "vrle")

_QMAX = {"int8": 127, "int4": 7}


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    name: str = "float32"       # float32 | int8 | int4
    sparse: bool = False        # sparse delta encoding vs shared reference
    error_feedback: bool = False  # EF residual memory (lossy codecs only)
    index_coding: str = "u2"    # u2 | vrle (varint+RLE sparse indices)

    def __post_init__(self):
        if self.name not in CODECS:
            raise ValueError(f"unknown codec {self.name!r}; "
                             f"choose from {CODECS}")
        if self.index_coding not in INDEX_CODINGS:
            raise ValueError(f"unknown index_coding "
                             f"{self.index_coding!r}; "
                             f"choose from {INDEX_CODINGS}")
        if self.index_coding == "vrle" and not self.sparse:
            raise ValueError("index_coding='vrle' entropy-codes the "
                             "sparse index stream and requires "
                             "sparse=True (dense frames have no "
                             "index stream)")
        if self.error_feedback and self.name == "float32":
            raise ValueError("error_feedback requires a lossy codec "
                             "(int8 | int4); float32 round-trips "
                             "bit-exact, so the residual would be "
                             "identically zero")


# ---------------------------------------------------------------------------
# dense payloads
# ---------------------------------------------------------------------------

def _quantize(vec: np.ndarray, qmax: int) -> tuple[np.ndarray, float]:
    peak = float(np.max(np.abs(vec))) if vec.size else 0.0
    scale = peak / qmax if peak > 0 else 1.0
    q = np.clip(np.rint(vec / scale), -qmax, qmax).astype(np.int8)
    return q, scale


def _pack_int4(q: np.ndarray) -> bytes:
    """q in [−7, 7] → biased nibbles [1, 15], two per byte."""
    b = (q.astype(np.int16) + 8).astype(np.uint8)
    if b.size % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return ((b[0::2] << 4) | b[1::2]).tobytes()


def _unpack_int4(buf: bytes, m: int) -> np.ndarray:
    b = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(b.size * 2, np.int16)
    out[0::2] = b >> 4
    out[1::2] = b & 0x0F
    return (out[:m] - 8).astype(np.float32)


def _encode_dense(vec: np.ndarray, name: str) -> bytes:
    if name == "float32":
        return vec.astype("<f4").tobytes()
    q, scale = _quantize(vec, _QMAX[name])
    head = struct.pack("<f", scale)
    if name == "int8":
        return head + q.tobytes()
    return head + _pack_int4(q)


def _decode_dense(buf: bytes, m: int, name: str) -> np.ndarray:
    if name == "float32":
        return np.frombuffer(buf, dtype="<f4", count=m).astype(np.float32)
    (scale,) = struct.unpack_from("<f", buf, 0)
    if name == "int8":
        q = np.frombuffer(buf, dtype=np.int8, count=m,
                          offset=4).astype(np.float32)
    else:
        q = _unpack_int4(buf[4:], m)
    return q * scale


def _value_bytes(name: str, count: int) -> int:
    if name == "float32":
        return 4 * count
    if name == "int8":
        return count
    return (count + 1) // 2


# ---------------------------------------------------------------------------
# compression v2: varint + run-length index coding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    """Unsigned LEB128."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if off >= len(buf):
            raise ValueError("truncated varint in sparse v2 frame")
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _index_runs(nz: np.ndarray) -> list[tuple[int, int]]:
    """Sorted indices → (gap, run_len) pairs over maximal consecutive
    runs; gap is the distance from the end of the previous run."""
    runs: list[tuple[int, int]] = []
    prev_end = 0                              # one past last emitted index
    i = 0
    while i < nz.size:
        j = i
        while j + 1 < nz.size and nz[j + 1] == nz[j] + 1:
            j += 1
        runs.append((int(nz[i]) - prev_end, j - i + 1))
        prev_end = int(nz[j]) + 1
        i = j + 1
    return runs


def _encode_vrle_indices(nz: np.ndarray) -> bytes:
    runs = _index_runs(nz)
    parts = [_varint(nz.size), _varint(len(runs))]
    for gap, run_len in runs:
        parts.append(_varint(gap))
        parts.append(_varint(run_len))
    return b"".join(parts)


def _decode_vrle_indices(buf: bytes, off: int
                         ) -> tuple[np.ndarray, int]:
    count, off = _read_varint(buf, off)
    n_runs, off = _read_varint(buf, off)
    idx = np.empty(count, np.int64)
    pos = prev_end = 0
    for _ in range(n_runs):
        gap, off = _read_varint(buf, off)
        run_len, off = _read_varint(buf, off)
        start = prev_end + gap
        idx[pos:pos + run_len] = np.arange(start, start + run_len)
        pos += run_len
        prev_end = start + run_len
    if pos != count:
        raise ValueError("sparse v2 frame: run lengths disagree with "
                         f"count ({pos} != {count})")
    return idx, off


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------

def encode(vec: np.ndarray, cfg: CodecConfig,
           ref: np.ndarray | None = None) -> bytes:
    """Encode one float vector; ``ref`` is the shared delta reference
    (ignored unless ``cfg.sparse``)."""
    vec = np.asarray(vec, dtype=np.float32).ravel()
    if not cfg.sparse:
        return _encode_dense(vec, cfg.name)

    delta = vec if ref is None else vec - np.asarray(ref, np.float32).ravel()
    if cfg.name == "float32":
        q, scale = delta, None
        nz = np.nonzero(delta)[0]
    else:
        q, scale = _quantize(delta, _QMAX[cfg.name])
        nz = np.nonzero(q)[0]
    dense_cost = 1 + len(_encode_dense(vec, cfg.name))
    head = b"" if scale is None else struct.pack("<f", scale)

    def _values() -> bytes:
        if cfg.name == "float32":
            return delta[nz].astype("<f4").tobytes()
        if cfg.name == "int8":
            return q[nz].tobytes()
        return _pack_int4(q[nz])

    if cfg.index_coding == "vrle":
        idx_stream = _encode_vrle_indices(nz)
        if 1 + len(head) + len(idx_stream) \
                + _value_bytes(cfg.name, nz.size) < dense_cost:
            return b"".join([b"\x02", head, idx_stream, _values()])
        return b"\x00" + _encode_dense(vec, cfg.name)

    if nz.size > 0xFFFF or vec.size > 0xFFFF:
        nz = None                         # u2 indices can't address it
    if nz is not None:
        sparse_cost = 5 + len(head) \
            + 2 * nz.size + _value_bytes(cfg.name, nz.size)
        if sparse_cost < dense_cost:
            return b"".join([b"\x01", head,
                             struct.pack("<I", nz.size),
                             nz.astype("<u2").tobytes(), _values()])
    return b"\x00" + _encode_dense(vec, cfg.name)


def decode(buf: bytes, m: int, cfg: CodecConfig,
           ref: np.ndarray | None = None) -> np.ndarray:
    """Decode one frame produced by :func:`encode` back to float32 (m,)."""
    if not cfg.sparse:
        return _decode_dense(buf, m, cfg.name)

    flag, buf = buf[0], buf[1:]
    if flag == 0:
        return _decode_dense(buf, m, cfg.name)
    if flag not in (1, 2):
        raise ValueError(f"unknown sparse frame flag {flag}")
    off = 0
    scale = None
    if cfg.name != "float32":
        (scale,) = struct.unpack_from("<f", buf, off)
        off += 4
    if flag == 2:
        idx, off = _decode_vrle_indices(buf, off)
        count = idx.size
    else:
        (count,) = struct.unpack_from("<I", buf, off)
        off += 4
        idx = np.frombuffer(buf, dtype="<u2", count=count, offset=off
                            ).astype(np.int64)
        off += 2 * count
    if cfg.name == "float32":
        vals = np.frombuffer(buf, dtype="<f4", count=count, offset=off
                             ).astype(np.float32)
    elif cfg.name == "int8":
        vals = np.frombuffer(buf, dtype=np.int8, count=count, offset=off
                             ).astype(np.float32) * scale
    else:
        vals = _unpack_int4(buf[off:], count) * scale
    delta = np.zeros(m, np.float32)
    delta[idx] = vals
    base = np.zeros(m, np.float32) if ref is None \
        else np.asarray(ref, np.float32).ravel().copy()
    return base + delta


def ef_encode(vec: np.ndarray, cfg: CodecConfig, residual: np.ndarray,
              ref: np.ndarray | None = None
              ) -> tuple[bytes, np.ndarray]:
    """Error-feedback encode: compress ``vec + residual`` and return the
    frame plus the *new* residual (the quantization error this frame
    leaves behind).  Both endpoints decode with the plain :func:`decode`;
    only the sender holds residual memory."""
    vec = np.asarray(vec, dtype=np.float32).ravel()
    target = vec + np.asarray(residual, np.float32).ravel()
    buf = encode(target, cfg, ref=ref)
    decoded = decode(buf, vec.size, cfg, ref=ref)
    return buf, target - decoded


def roundtrip_tolerance(vec: np.ndarray, cfg: CodecConfig) -> float:
    """Worst-case |decode(encode(x)) − x| for this codec on this vector
    (half a quantization step, plus float slack)."""
    if cfg.name == "float32":
        return 0.0
    peak = float(np.max(np.abs(np.asarray(vec)))) if np.size(vec) else 0.0
    return 0.5 * peak / _QMAX[cfg.name] + 1e-5
