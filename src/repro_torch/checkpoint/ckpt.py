"""Checkpoints as a msgpack tensor store, readable without ``msgpack``.

Counterpart of ``repro/checkpoint/ckpt.py``: a tree of tensors (named
tuples, dicts, lists, tuples; ``None`` holds nothing) is saved as one
msgpack map ``{leaf key: {"dtype", "shape", "data"}}``, with the
reference's leaf keys (``'.client_state/.ta_state'``: a named tuple's
field is ``.name``, a dict's key is itself, a sequence index its number,
joined by ``/``).  :func:`restore` walks the *template's* leaves and
ignores extra keys in the file.  The port's engine state has the
reference's leaves in the reference's order, the six async buffer lanes
(``.buf_*``) and the wire's ``.ref_vecs`` / ``.ref_round`` /
``.ef_residual`` lanes included, so each package restores the other's
checkpoints.

The port's machine has no ``msgpack``, so :func:`packb` and
:func:`unpackb` implement the subset the payload uses (map, str, bin,
array, unsigned int), byte for byte as ``msgpack.packb`` writes it.
"""
from __future__ import annotations

import pathlib
import struct
from typing import Any, Callable

import numpy as np
import torch


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

def _head(out: list, n: int, fix: int | None, fix_max: int,
          codes: tuple[tuple[int, str, int], ...]) -> None:
    """A length (or value) header: the fix form up to ``fix_max``, else
    the first ``(code, struct format, max)`` that holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: {n} is too large")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _pack(obj: Any, out: list) -> None:
    if isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, ((0xDE, ">H", _U16),
                                        (0xDF, ">I", _U32)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, ((0xD9, ">B", _U8),
                                        (0xDA, ">H", _U16),
                                        (0xDB, ">I", _U32)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), None, -1, ((0xC4, ">B", _U8),
                                        (0xC5, ">H", _U16),
                                        (0xC6, ">I", _U32)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, ((0xDC, ">H", _U16),
                                        (0xDD, ">I", _U32)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        _head(out, obj, 0x00, 0x7F, ((0xCC, ">B", _U8), (0xCD, ">H", _U16),
                                     (0xCE, ">I", _U32),
                                     (0xCF, ">Q", (1 << 64) - 1)))
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for maps, str, bytes, lists and unsigned
    ints, the only types a checkpoint payload holds."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
        0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
        0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}


def _unpack(buf: memoryview, pos: int) -> tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if 0x80 <= code <= 0x8F or 0x90 <= code <= 0x9F or 0xA0 <= code <= 0xBF:
        kind = {0x80: "map", 0x90: "array"}.get(code & 0xF0, "str")
        n = code & (0x1F if kind == "str" else 0x0F)
    elif code in _LEN:
        fmt = _LEN[code]
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        if code in (0xCC, 0xCD, 0xCE, 0xCF):
            return n, pos
        kind = ("bin" if code <= 0xC6 else "str" if code <= 0xDB
                else "array" if code <= 0xDD else "map")
    else:
        raise ValueError(f"msgpack subset: type byte {code:#04x} at "
                         f"{pos - 1} is not one a checkpoint holds")
    if kind == "map":
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        return out, pos
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    if pos + n > len(buf):
        raise ValueError("msgpack subset: truncated data")
    raw = bytes(buf[pos:pos + n])
    return (raw.decode("utf-8") if kind == "str" else raw), pos + n


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)`` for the subset :func:`packb` writes."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack subset: {len(data) - pos} trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def _map(fn: Callable[[str, torch.Tensor], Any], tree: Any,
         path: tuple = ()) -> Any:
    """The tree with each tensor leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn("/".join(path), tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"checkpoint: leaf {'/'.join(path)!r} is a "
                    f"{type(tree).__name__}, not a tensor")


def _dtype_name(dtype: torch.dtype) -> str:
    """The dtype string a checkpoint records for a tensor dtype."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty((), dtype=dtype).numpy().dtype.name


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf's bytes on the host; bfloat16 as its raw 2-byte words."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def save(path: str | pathlib.Path, tree: Any) -> None:
    """bfloat16 leaves are written as the reference writes them (through
    ml_dtypes): dtype string ``"bfloat16"``, the raw 2-byte words."""
    flat = {}

    def put(key, leaf):
        flat[key] = (_dtype_name(leaf.dtype), _host(leaf))

    _map(put, tree)
    payload = {k: {"dtype": name, "shape": list(v.shape),
                   "data": v.tobytes()} for k, (name, v) in flat.items()}
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(payload))


def _array(entry: dict) -> tuple[str, np.ndarray]:
    """A payload entry as (dtype name, array); bfloat16 as int16 words,
    so no ``ml_dtypes`` is needed."""
    name = entry["dtype"]
    if name == "bfloat16":
        arr = np.frombuffer(entry["data"], dtype=np.int16)
    else:
        arr = np.frombuffer(entry["data"], dtype=name)
        name = arr.dtype.name
    return name, arr.reshape(entry["shape"])


def restore(path: str | pathlib.Path, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors), each
    leaf on its template's device with its template's dtype."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    flat = {k: _array(v) for k, v in payload.items()}

    def take(key, leaf):
        entry = flat.get(key)
        if entry is None:
            raise KeyError(
                f"checkpoint {path} lacks leaf {key!r} — it was saved "
                f"by an older state layout; restart without --resume "
                f"(or delete the stale checkpoint directory)")
        name, arr = entry
        want = _dtype_name(leaf.dtype)
        if tuple(arr.shape) != tuple(leaf.shape) or name != want:
            raise ValueError(
                f"checkpoint {path}: layout mismatch for leaf {key!r} — "
                f"saved {name}{tuple(arr.shape)}, "
                f"expected {want}{tuple(leaf.shape)}")
        t = torch.from_numpy(arr.copy())
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(leaf.device)

    return _map(take, like)
