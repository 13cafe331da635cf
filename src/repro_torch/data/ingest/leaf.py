"""LEAF-style FEMNIST shards: per-writer JSON, both ways.

A copy of ``repro/data/ingest/leaf.py`` (numpy only), so the port reads
and writes the same bytes without importing the JAX package.

The LEAF benchmark suite (Caldas et al.) distributes FEMNIST as JSON
shards, each holding a block of writers::

    {"users":       ["f0000_14", ...],
     "num_samples": [104, ...],
     "user_data":   {"f0000_14": {"x": [[784 floats in [0,1]], ...],
                                  "y": [int, ...]}, ...}}

The *writer* is the natural client: each user's samples come from one
hand, so partitioning by user is the canonical natural non-IID split.

:func:`read_shards` concatenates every ``all_data_*.json`` shard under a
directory (sorted by name, users in shard order) into one flat pool plus
a per-sample writer id.  :func:`write_shards` is the inverse the offline
mirror uses; pixel values are written as Python ``repr`` floats, which
JSON round-trips exactly.  It also records an ``index.json`` (writer
names and sample counts per shard, in the order :func:`read_shards`
walks, plus the feature width), so :func:`read_writers` parses only the
shards a cohort's writers live in; :func:`ensure_index` rebuilds a
missing index from the shards.  ``read_shards`` never consults the
index, so a stale index cannot corrupt the pool.
"""
from __future__ import annotations

import json
import pathlib
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.data.ingest import idx

SHARD_PATTERN = "all_data_*.json"
INDEX_NAME = "index.json"
INDEX_VERSION = 1


class LeafPool(NamedTuple):
    x: np.ndarray        # (N, F) float32 — unit-scale features, flat
    y: np.ndarray        # (N,)  int32
    writers: np.ndarray  # (N,)  int32 — index into ``users``
    users: tuple         # (W,)  writer names, shard order


class LeafFormatError(ValueError):
    """Malformed LEAF shard: missing keys or inconsistent sample counts."""


def _parse_shard(path: pathlib.Path, verify: bool = True) -> dict:
    """One shard file → its dict (checksum-verified on the single read).

    Module-level on purpose: this is the one seam every shard byte
    passes through, so tests can shim it to count / forbid parses (the
    streaming-ingestion "never materializes the pool" pin)."""
    raw = path.read_bytes()
    if verify:
        idx.verify_bytes(path, raw)     # single read, no second pass
    return json.loads(raw)


def _user_arrays(path: pathlib.Path, shard: dict,
                 name: str, u: int) -> tuple[np.ndarray, np.ndarray]:
    """Validate + extract one user's (x, y) block from a parsed shard —
    shared by the pool reader and the per-writer streaming reader, so
    both reject malformed data identically."""
    user_data = shard["user_data"]
    entry = user_data.get(name)
    if entry is None:
        raise LeafFormatError(
            f"{path}: user {name!r} listed but missing from "
            f"user_data")
    x = np.asarray(entry["x"], dtype=np.float32)
    y = np.asarray(entry["y"], dtype=np.int32)
    if x.ndim != 2 or x.shape[0] != y.shape[0]:
        raise LeafFormatError(
            f"{path}: user {name!r} has x {x.shape} vs y "
            f"{y.shape}")
    num_samples = shard.get("num_samples")
    if num_samples is not None and num_samples[u] != y.shape[0]:
        raise LeafFormatError(
            f"{path}: user {name!r} declares {num_samples[u]} "
            f"samples but holds {y.shape[0]}")
    return x, y


def write_shards(root: str | pathlib.Path, users: Sequence[str],
                 xs: Sequence[np.ndarray], ys: Sequence[np.ndarray],
                 writers_per_shard: int = 10,
                 checksum: bool = True) -> list[pathlib.Path]:
    """Write per-writer data as LEAF JSON shards under ``root``.

    ``xs[i]`` is writer i's (n_i, F) feature block, ``ys[i]`` the labels.
    Returns the shard paths (``all_data_<k>.json`` + ``.sha256``
    sidecars)."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for k in range(0, len(users), writers_per_shard):
        block = slice(k, k + writers_per_shard)
        names = list(users[block])
        shard = {
            "users": names,
            "num_samples": [int(len(ys[i]))
                            for i in range(*block.indices(len(users)))],
            "user_data": {
                name: {"x": np.asarray(xs[i]).astype(float).tolist(),
                       "y": np.asarray(ys[i]).astype(int).tolist()}
                for name, i in zip(names,
                                   range(*block.indices(len(users))))},
        }
        path = root / f"all_data_{k // writers_per_shard}.json"
        path.write_text(json.dumps(shard))
        if checksum:
            idx.write_checksum(path)
        paths.append(path)
    # the streaming index rides along: per-shard writer names + counts,
    # listed in the sorted-name order read_shards walks, so a writer's
    # global id is derivable without parsing any shard payload
    entries = {p.name: e for p, e in zip(paths, (
        {"file": p.name,
         "users": list(users[k:k + writers_per_shard]),
         "num_samples": [int(len(ys[i])) for i in
                         range(k, min(k + writers_per_shard, len(users)))]}
        for k, p in zip(range(0, len(users), writers_per_shard), paths)))}
    index = {"version": INDEX_VERSION,
             "num_features": int(np.asarray(xs[0]).shape[1]) if xs else 0,
             "shards": [entries[name] for name in sorted(entries)]}
    index_path = root / INDEX_NAME
    index_path.write_text(json.dumps(index))
    if checksum:
        idx.write_checksum(index_path)
    return paths


def read_shards(root: str | pathlib.Path, verify: bool = True) -> LeafPool:
    """Parse every LEAF shard under ``root`` into one flat writer-tagged
    pool.  Shards are read in sorted name order and users in shard
    order, so the writer ids are stable across runs."""
    root = pathlib.Path(root)
    shards = sorted(root.glob(SHARD_PATTERN))
    if not shards:
        raise FileNotFoundError(
            f"no LEAF shards ({SHARD_PATTERN}) under {root}")
    xs, ys, writers, users = [], [], [], []
    for path in shards:
        shard = _parse_shard(path, verify)
        try:
            shard_users = shard["users"]
            shard["user_data"]
        except KeyError as e:
            raise LeafFormatError(f"{path}: missing key {e}") from e
        num_samples = shard.get("num_samples")
        if num_samples is not None and len(num_samples) != len(shard_users):
            raise LeafFormatError(
                f"{path}: num_samples lists {len(num_samples)} entries "
                f"for {len(shard_users)} users")
        for u, name in enumerate(shard_users):
            x, y = _user_arrays(path, shard, name, u)
            wid = len(users)
            users.append(name)
            xs.append(x)
            ys.append(y)
            writers.append(np.full((x.shape[0],), wid, np.int32))
    return LeafPool(x=np.concatenate(xs, axis=0),
                    y=np.concatenate(ys, axis=0),
                    writers=np.concatenate(writers, axis=0),
                    users=tuple(users))


# ---------------------------------------------------------------------------
# streaming: shard index + per-writer reads (no pool materialization)
# ---------------------------------------------------------------------------

def read_index(root: str | pathlib.Path, verify: bool = True) -> dict:
    """Parse ``index.json`` (checksum-verified) and validate it against
    the shard files actually present — a stale index (shards added /
    removed / renamed since it was written) fails loudly rather than
    mis-routing writer ids."""
    root = pathlib.Path(root)
    path = root / INDEX_NAME
    raw = path.read_bytes()
    if verify:
        idx.verify_bytes(path, raw)
    index = json.loads(raw)
    if index.get("version") != INDEX_VERSION:
        raise LeafFormatError(
            f"{path}: index version {index.get('version')!r}, "
            f"expected {INDEX_VERSION}")
    listed = [e["file"] for e in index.get("shards", ())]
    present = [p.name for p in sorted(root.glob(SHARD_PATTERN))]
    if listed != present:
        raise LeafFormatError(
            f"{path} is stale: it lists shards {listed} but the "
            f"directory holds {present} — delete the index (and its "
            f".sha256 sidecar) to rebuild it")
    return index


def ensure_index(root: str | pathlib.Path, verify: bool = True) -> dict:
    """``read_index``, building the index first if missing (one full
    parse over the shards — the only time streaming ever touches them
    all; real LEAF drop-ins ship without an index)."""
    root = pathlib.Path(root)
    if not (root / INDEX_NAME).exists():
        shards = sorted(root.glob(SHARD_PATTERN))
        if not shards:
            raise FileNotFoundError(
                f"no LEAF shards ({SHARD_PATTERN}) under {root}")
        entries, num_features = [], 0
        for path in shards:
            shard = _parse_shard(path, verify)
            try:
                names = list(shard["users"])
                user_data = shard["user_data"]
            except KeyError as e:
                raise LeafFormatError(f"{path}: missing key {e}") from e
            counts = []
            for u, name in enumerate(names):
                x, y = _user_arrays(path, shard, name, u)
                counts.append(int(y.shape[0]))
                num_features = int(x.shape[1])
            del user_data
            entries.append({"file": path.name, "users": names,
                            "num_samples": counts})
        index = {"version": INDEX_VERSION, "num_features": num_features,
                 "shards": entries}
        path = root / INDEX_NAME
        path.write_text(json.dumps(index))
        idx.write_checksum(path)
    return read_index(root, verify)


def read_writers(root: str | pathlib.Path, wids,
                 verify: bool = True) -> dict[int, tuple]:
    """Per-writer ``{wid: (x, y)}`` for just the requested global writer
    ids — only the shards those writers live in are parsed.  Writer ids
    are the :func:`read_shards` enumeration (sorted shard names, users
    in shard order), so a streamed writer block is bit-identical to the
    corresponding pool slice."""
    root = pathlib.Path(root)
    index = read_index(root, verify)
    # global wid → (shard file, user name, position-in-shard)
    table, wid = [], 0
    for entry in index["shards"]:
        for u, name in enumerate(entry["users"]):
            table.append((entry["file"], name, u))
            wid += 1
    wanted = sorted({int(w) for w in np.asarray(wids).reshape(-1)})
    if wanted and (wanted[0] < 0 or wanted[-1] >= len(table)):
        raise ValueError(
            f"writer ids out of range [0, {len(table)}): {wanted[:8]}")
    by_shard: dict[str, list[int]] = {}
    for w in wanted:
        by_shard.setdefault(table[w][0], []).append(w)
    out: dict[int, tuple] = {}
    for fname, ws in by_shard.items():
        path = root / fname
        shard = _parse_shard(path, verify)
        for w in ws:
            _, name, u = table[w]
            out[w] = _user_arrays(path, shard, name, u)
    return out
