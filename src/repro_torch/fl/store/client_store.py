"""Per-client row store in sparse host files: the host side of the
K-active working set.

Counterpart of ``repro/fl/store/client_store.py``, file for file: the
resident engine holds every client's params / TA state / sparse-codec
references as one stacked tree on the device, which caps the population
at what the card holds.  :class:`ClientStore` keeps those rows on disk
instead, one sparse file per tree leaf keyed by client id,
so the engine only holds the scheduler's K sampled rows on the device
(``gather(ids)`` before the round, ``spill(ids, rows)`` after the
broadcast merge).

Layout under ``root``::

    manifest.json (+ .sha256)   # version, n_clients, per-leaf dtype/shape
    leaf_00.bin, leaf_01.bin …  # (n_clients, *leaf_shape) sparse files
    written.bin                 # (n_clients,) u8 — 1 once a row was spilled
    digests.bin                 # (n_clients, 32) u8 — per-row sha256

**Positional I/O, not a memory map.**  The reference maps each leaf
file with ``np.memmap``; the port reads and writes rows with
``os.preadv`` / ``os.pwrite`` at ``id x row bytes``, the same bytes at
the same offsets.  Some hosts populate a shared file mapping whole on
its first write (gVisor over a 9p root file system does: one row
written into a mapping of a sparse leaf file takes the whole file's
size in memory),
where a 1000-client FEMNIST store, 116.7 GB apparent, cannot be mapped;
positional writes take memory for the rows written only
(``tools/store_io_probe.py`` measures both).

Integrity is the IDX cache's verify-then-place
(:mod:`repro_torch.data.ingest.idx`): the manifest's ``.sha256`` sidecar
is checked before it is parsed, and every row carries a sha256 over its
bytes (all leaves, in flattened order) written at spill time and checked
at gather time, so a flipped byte raises
:class:`~repro_torch.data.ingest.idx.ChecksumError`.

**Leaf order.**  The manifest's leaf list and every digest follow the
reference's flatten (:func:`flatten`): named tuples by field, dicts by
*sorted* key (``jax.tree_util``'s order), tuples and lists by position.
An engine row ``{"cs": TMParams, "ref_vecs", "ref_round"}`` is therefore
``ta_state, weights, ref_round, ref_vecs``, and an MLP row
``b1, b2, w1, w2``.  With the same template and the same spills every
file is the reference's byte for byte.

The leaf files are created sparse (``truncate``, no payload write), so a
store sized for a million clients costs disk only for the rows spilled.
Rows never spilled are regenerated by ``init_fn(ids)`` (the strategy's
deterministic per-client init).  The host side is numpy; ``spill`` and
``init_fn`` may hand tensors on any device, which are copied to the host
once, and ``gather`` returns numpy rows.  ``gather`` is read-only and
thread-safe; ``io_read_bytes`` / ``io_written_bytes`` meter the host I/O
under a lock.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.ingest import idx

STORE_VERSION = 1
MANIFEST_NAME = "manifest.json"
WRITTEN_NAME = "written.bin"
DIGESTS_NAME = "digests.bin"
_DIGEST_BYTES = 32


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """``(leaves, unflatten)`` in ``jax.tree_util``'s order: named tuples
    by field, dicts by sorted key, tuples and lists by position, ``None``
    an empty subtree; anything else is a leaf.  ``unflatten(leaves)``
    rebuilds the structure around new leaves."""
    if tree is None:
        return [], lambda _: None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [flatten(v) for v in tree]
        kind = type(tree)
        build = lambda vals: kind(*vals)                        # noqa: E731
    elif isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        build = lambda vals: dict(zip(keys, vals))              # noqa: E731
    elif isinstance(tree, (tuple, list)):
        parts = [flatten(v) for v in tree]
        kind = type(tree)
        build = lambda vals: kind(vals)                         # noqa: E731
    else:
        return [tree], lambda leaves: leaves[0]
    leaves = [leaf for ls, _ in parts for leaf in ls]
    sizes = [len(ls) for ls, _ in parts]

    def unflatten(new: list) -> Any:
        out, off = [], 0
        for (_, un), n in zip(parts, sizes):
            out.append(un(new[off:off + n]))
            off += n
        return build(out)

    return leaves, unflatten


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of ``tree`` (numpy arrays or tensors)."""
    leaves, unflatten = flatten(tree)
    return unflatten([fn(a) for a in leaves])


def _ensure_file(path: pathlib.Path, nbytes: int) -> None:
    """Create ``path`` as a sparse file of ``nbytes`` (no payload write),
    or validate an existing one: a size drift means the store was
    created under another template and must fail loudly."""
    if path.exists():
        got = path.stat().st_size
        if got != nbytes:
            raise ValueError(
                f"store file {path} is {got} bytes, expected {nbytes} — "
                f"the store on disk was created under a different "
                f"template or client count; use a fresh directory")
        return
    with open(path, "wb") as f:
        if nbytes:
            f.truncate(nbytes)


def _pread_into(fd: int, buf: np.ndarray, offset: int) -> None:
    """Fill the C-contiguous ``buf`` from ``fd`` at ``offset``."""
    view = memoryview(buf).cast("B")
    done = 0
    while done < len(view):
        got = os.preadv(fd, [view[done:]], offset + done)
        if got == 0:
            raise ValueError(f"store file ends at byte {offset + done}, "
                             f"short of a row")
        done += got


def _pwrite(fd: int, buf: np.ndarray, offset: int) -> None:
    """Write the C-contiguous ``buf`` to ``fd`` at ``offset``."""
    view = memoryview(np.ascontiguousarray(buf)).cast("B")
    done = 0
    while done < len(view):
        done += os.pwrite(fd, view[done:], offset + done)


def _leaf_specs(leaves: list[np.ndarray]) -> list[dict]:
    return [{"slug": f"leaf_{i:02d}", "dtype": str(a.dtype),
             "shape": [int(s) for s in a.shape]}
            for i, a in enumerate(leaves)]


class ClientStore:
    """Host-side store of per-client rows, open-or-create.

    ``template`` is ONE client's row (a tree with no leading client axis)
    and fixes the per-leaf dtype / shape layout recorded in the
    manifest.  ``init_fn(ids) -> stacked rows`` regenerates rows never
    spilled; without it, gathering an unwritten row raises."""

    def __init__(self, root: str | pathlib.Path, n_clients: int,
                 template: Any,
                 init_fn: Callable[[np.ndarray], Any] | None = None,
                 verify: bool = True):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.n = int(n_clients)
        self.init_fn = init_fn
        self.verify = verify
        leaves, self._unflatten = flatten(template)
        self._leaves = [to_host(a) for a in leaves]
        if not self._leaves:
            raise ValueError("client-store template has no array leaves")
        self._specs = _leaf_specs(self._leaves)
        self.row_nbytes = int(sum(a.nbytes for a in self._leaves))

        man_path = self.root / MANIFEST_NAME
        if man_path.exists():
            raw = man_path.read_bytes()
            if verify:
                idx.verify_bytes(man_path, raw)   # sidecar first, then parse
            man = json.loads(raw)
            if (man.get("version") != STORE_VERSION
                    or man.get("n_clients") != self.n
                    or man.get("leaves") != self._specs):
                raise ValueError(
                    f"store manifest {man_path} does not match the "
                    f"caller's template (n_clients={self.n}, leaves="
                    f"{self._specs}) — the store on disk belongs to a "
                    f"different engine configuration; use a fresh "
                    f"directory")
        else:
            man = {"version": STORE_VERSION, "n_clients": self.n,
                   "row_nbytes": self.row_nbytes, "leaves": self._specs}
            man_path.write_text(json.dumps(man, indent=2, sort_keys=True))
            idx.write_checksum(man_path)
        self.manifest = man

        self._paths = [self.root / (spec["slug"] + ".bin")
                       for spec in self._specs]
        for path, leaf in zip(self._paths, self._leaves):
            _ensure_file(path, self.n * leaf.nbytes)
        self._written_path = self.root / WRITTEN_NAME
        self._digests_path = self.root / DIGESTS_NAME
        _ensure_file(self._written_path, self.n)
        _ensure_file(self._digests_path, self.n * _DIGEST_BYTES)
        self.io_read_bytes = 0
        self.io_written_bytes = 0
        self._io_lock = threading.Lock()

    # -- helpers ---------------------------------------------------------

    def _check_ids(self, ids) -> np.ndarray:
        ids = to_host(ids).astype(np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise ValueError(
                f"client ids out of range [0, {self.n}): "
                f"[{ids.min()}, {ids.max()}]")
        return ids

    @staticmethod
    def _row_digest(row: list[np.ndarray]) -> np.ndarray:
        h = hashlib.sha256()
        for a in row:
            h.update(np.ascontiguousarray(a).tobytes())
        return np.frombuffer(h.digest(), dtype=np.uint8)

    @contextlib.contextmanager
    def _open(self, flags: int):
        """File descriptors of the leaf files, ``written.bin`` and
        ``digests.bin``, closed on exit."""
        fds = []
        try:
            for path in (*self._paths, self._written_path,
                         self._digests_path):
                fds.append(os.open(path, flags))
            yield fds[:-2], fds[-2], fds[-1]
        finally:
            for fd in fds:
                os.close(fd)

    def _written(self) -> np.ndarray:
        """The (n,) u8 written bitmap."""
        out = np.empty((self.n,), np.uint8)
        with open(self._written_path, "rb") as f:
            _pread_into(f.fileno(), out, 0)
        return out

    def written_count(self) -> int:
        return int(self._written().astype(np.int64).sum())

    def written_mask(self, ids) -> np.ndarray:
        """Bool mask over ``ids``: True where a row was ever spilled
        (``gather`` returns personalized state, not an ``init_fn``
        regeneration).  The serving plane reports personalized and
        fallback counts from it."""
        ids = self._check_ids(ids)
        return self._written()[ids].astype(bool)

    # -- the two verbs ---------------------------------------------------

    def gather(self, ids) -> Any:
        """Stacked numpy rows for ``ids``: spilled rows are read back and
        digest-verified; never-spilled rows come from ``init_fn``."""
        ids = self._check_ids(ids)
        written = self._written()[ids].astype(bool)
        out = [np.empty((ids.size,) + a.shape, a.dtype)
               for a in self._leaves]
        miss = ids[~written]
        if miss.size:
            if self.init_fn is None:
                raise ValueError(
                    f"clients {miss[:8].tolist()}… were never spilled "
                    f"and the store has no init_fn to regenerate them")
            init_rows = flatten(self.init_fn(miss))[0]
            if len(init_rows) != len(self._leaves):
                raise ValueError(
                    f"init_fn returned {len(init_rows)} leaves, the "
                    f"store template has {len(self._leaves)}")
            where = np.nonzero(~written)[0]
            for dst, src, leaf in zip(out, init_rows, self._leaves):
                src = to_host(src)
                if src.shape != (miss.size,) + leaf.shape \
                        or src.dtype != leaf.dtype:
                    raise ValueError(
                        f"init_fn leaf {src.dtype}{src.shape} does not "
                        f"match template {leaf.dtype}"
                        f"{(miss.size,) + leaf.shape}")
                dst[where] = src
        read = 0
        with self._open(os.O_RDONLY) as (fds, _, digests_fd):
            for j in np.nonzero(written)[0]:
                i = int(ids[j])
                row = [dst[j:j + 1] for dst in out]
                for fd, a, leaf in zip(fds, row, self._leaves):
                    _pread_into(fd, a, i * leaf.nbytes)
                if self.verify:
                    got = self._row_digest(row)
                    want = np.empty((_DIGEST_BYTES,), np.uint8)
                    _pread_into(digests_fd, want, i * _DIGEST_BYTES)
                    if not np.array_equal(got, want):
                        raise idx.ChecksumError(
                            f"checksum mismatch for client {i} in "
                            f"{self.root}: stored row digest "
                            f"{bytes(want).hex()[:12]}…, file bytes hash "
                            f"to {bytes(got).hex()[:12]}… — the store is "
                            f"corrupt; delete it and re-run")
                read += self.row_nbytes
        with self._io_lock:
            self.io_read_bytes += read
        return self._unflatten(out)

    def spill(self, ids, rows: Any) -> None:
        """Write stacked ``rows`` back under ``ids`` (verify-then-place:
        the per-row digest is recorded with the bytes, so the next
        gather re-proves integrity)."""
        ids = self._check_ids(ids)
        leaves = [to_host(a) for a in flatten(rows)[0]]
        if len(leaves) != len(self._leaves):
            raise ValueError(
                f"spill got {len(leaves)} leaves, the store template "
                f"has {len(self._leaves)}")
        for a, leaf in zip(leaves, self._leaves):
            if a.shape != (ids.size,) + leaf.shape or a.dtype != leaf.dtype:
                raise ValueError(
                    f"spill leaf {a.dtype}{a.shape} does not match "
                    f"template {leaf.dtype}{(ids.size,) + leaf.shape}")
        one = np.ones((1,), np.uint8)
        with self._open(os.O_RDWR) as (fds, written_fd, digests_fd):
            for j, i in enumerate(ids):
                i = int(i)
                row = [a[j] for a in leaves]
                for fd, a, leaf in zip(fds, row, self._leaves):
                    _pwrite(fd, a, i * leaf.nbytes)
                _pwrite(digests_fd, self._row_digest(row),
                        i * _DIGEST_BYTES)
                _pwrite(written_fd, one, i)
        with self._io_lock:
            self.io_written_bytes += int(ids.size) * (
                self.row_nbytes + _DIGEST_BYTES + 1)

    def flush(self) -> None:
        """Push written rows to disk (reopen durability; checkpoints)."""
        with self._open(os.O_RDWR) as (fds, written_fd, digests_fd):
            for fd in (*fds, written_fd, digests_fd):
                os.fsync(fd)
