"""Byte-exact IDX codec — the MNIST-family on-disk format, both ways.

A copy of ``repro/data/ingest/idx.py`` (numpy only), so the port reads
and writes the same bytes without importing the JAX package.

The IDX format (Y. LeCun's spec, as served for MNIST / FashionMNIST /
EMNIST) is::

    magic      4 bytes   00 00 <dtype code> <ndim>
    dims       ndim × u4 big-endian
    data       prod(dims) elements, big-endian, row-major

dtype codes: 0x08 u1, 0x09 i1, 0x0B i2, 0x0C i4, 0x0D f4, 0x0E f8.

``decode(encode(a)) == a`` bit-for-bit for every supported dtype — the
ingest test suite pins this property over random shapes.  ``read`` /
``write`` add the file layer: gzip transparent on read (sniffed from the
two-byte gzip magic, so a ``.gz``-less gzipped file still parses) and
driven by the ``.gz`` suffix on write.

A cache file can carry a ``<name>.sha256`` sidecar holding the hex
digest of the stored bytes (post-gzip).  :func:`verify_bytes` rejects
corruption before a single byte is parsed (the readers check the buffer
they just read — one pass over the file); the offline mirror writes a
sidecar next to everything it generates.
"""
from __future__ import annotations

import gzip
import hashlib
import pathlib
import struct

import numpy as np

# dtype code ↔ numpy dtype (big-endian on the wire)
DTYPE_OF_CODE = {0x08: np.dtype(np.uint8), 0x09: np.dtype(np.int8),
                 0x0B: np.dtype(np.int16), 0x0C: np.dtype(np.int32),
                 0x0D: np.dtype(np.float32), 0x0E: np.dtype(np.float64)}
CODE_OF_DTYPE = {v: k for k, v in DTYPE_OF_CODE.items()}

_GZIP_MAGIC = b"\x1f\x8b"


class IDXFormatError(ValueError):
    """Malformed IDX bytes: bad magic, dtype code, or truncated payload."""


class ChecksumError(ValueError):
    """A cache file does not match its recorded sha256 sidecar."""


# ---------------------------------------------------------------------------
# bytes codec
# ---------------------------------------------------------------------------

def encode(arr: np.ndarray) -> bytes:
    """Serialize ``arr`` to IDX bytes (big-endian payload)."""
    arr = np.asarray(arr)
    code = CODE_OF_DTYPE.get(arr.dtype)
    if code is None:
        raise IDXFormatError(
            f"dtype {arr.dtype} has no IDX code; supported: "
            f"{sorted(str(d) for d in CODE_OF_DTYPE)}")
    if arr.ndim < 1 or arr.ndim > 255:
        raise IDXFormatError(f"IDX needs 1..255 dims, got {arr.ndim}")
    head = struct.pack(">BBBB", 0, 0, code, arr.ndim)
    dims = struct.pack(f">{arr.ndim}I", *arr.shape)
    body = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder(">"))
    return head + dims + body.tobytes()


def decode(buf: bytes) -> np.ndarray:
    """Parse IDX bytes back to a (native-byte-order) numpy array.

    Strict: the buffer must hold *exactly* ``prod(dims)`` elements —
    truncation and trailing garbage are both rejected, so a cache hit is
    byte-exactly the file the writer produced.
    """
    if len(buf) < 4:
        raise IDXFormatError("IDX header truncated")
    z0, z1, code, ndim = struct.unpack_from(">BBBB", buf, 0)
    if z0 != 0 or z1 != 0:
        raise IDXFormatError(f"bad IDX magic {buf[:4]!r}")
    dtype = DTYPE_OF_CODE.get(code)
    if dtype is None:
        raise IDXFormatError(f"unknown IDX dtype code 0x{code:02x}")
    if len(buf) < 4 + 4 * ndim:
        raise IDXFormatError("IDX dims truncated")
    dims = struct.unpack_from(f">{ndim}I", buf, 4)
    off = 4 + 4 * ndim
    count = int(np.prod(dims, dtype=np.int64)) if ndim else 0
    expect = off + count * dtype.itemsize
    if len(buf) != expect:
        raise IDXFormatError(
            f"IDX payload is {len(buf) - off} bytes, dims {dims} need "
            f"{expect - off}")
    data = np.frombuffer(buf, dtype=dtype.newbyteorder(">"), count=count,
                         offset=off)
    return data.astype(dtype).reshape(dims)


# ---------------------------------------------------------------------------
# file layer (gzip-aware) + checksum sidecars
# ---------------------------------------------------------------------------

def write(path: str | pathlib.Path, arr: np.ndarray,
          checksum: bool = True) -> pathlib.Path:
    """Write ``arr`` as an IDX file (gzipped when the name ends ``.gz``),
    plus a ``.sha256`` sidecar unless ``checksum=False``."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    raw = encode(arr)
    if path.suffix == ".gz":
        # fixed mtime so identical arrays produce identical file bytes
        raw = gzip.compress(raw, mtime=0)
    path.write_bytes(raw)
    if checksum:
        write_checksum(path)
    return path


def read(path: str | pathlib.Path, verify: bool = True) -> np.ndarray:
    """Read an IDX file; gzip is sniffed from the stored magic.  With
    ``verify`` (default) a ``.sha256`` sidecar, if present, is checked
    against the stored bytes first (on the single buffer already read —
    no second pass over the file)."""
    path = pathlib.Path(path)
    buf = path.read_bytes()
    if verify:
        verify_bytes(path, buf)
    if buf[:2] == _GZIP_MAGIC:
        buf = gzip.decompress(buf)
    return decode(buf)


def sha256_file(path: str | pathlib.Path) -> str:
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def checksum_path(path: str | pathlib.Path) -> pathlib.Path:
    path = pathlib.Path(path)
    return path.with_name(path.name + ".sha256")


def write_checksum(path: str | pathlib.Path) -> pathlib.Path:
    """Record ``sha256(stored bytes)`` in the file's sidecar."""
    side = checksum_path(path)
    side.write_text(sha256_file(path) + "\n")
    return side


def verify_bytes(path: str | pathlib.Path, buf: bytes) -> None:
    """Check ``buf`` (the stored bytes of ``path``, already in memory)
    against the sidecar digest, if one exists."""
    side = checksum_path(path)
    if not side.exists():
        return
    want = side.read_text().strip()
    got = hashlib.sha256(buf).hexdigest()
    if got != want:
        raise ChecksumError(
            f"checksum mismatch for {path}: sidecar {want[:12]}…, "
            f"file {got[:12]}… — if the file is corrupt, delete it and "
            f"re-fetch; if you deliberately replaced it (e.g. real data "
            f"over a mirror file), delete the stale {side.name!r} "
            f"sidecar")
