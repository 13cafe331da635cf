"""`DatasetSpec` registry: one ``load(name, data_dir)`` for every flavour.

Counterpart of ``repro/data/ingest/registry.py`` and the single source
of truth for the port's dataset names (``synthetic.DATASETS`` and the
CLIs' ``--dataset`` choices derive from it).

``load`` returns a :class:`Pool`, the encoded global pool a partitioner
takes (:func:`repro_torch.data.ingest.natural.partition_pool`: the
Dirichlet split, or the writer split when the pool carries writer
identities).  Resolution, per spec kind:

* ``data_dir`` given — files under ``<data_dir>/<name>/`` are parsed
  (checksum-verified where ``.sha256`` sidecars exist).  Missing files
  are first written by the offline mirror
  (:mod:`repro_torch.data.ingest.mirror`), then parsed through the same
  readers, so the pool is always a function of the file bytes.  IDX
  kinds read the train pair (a real ``t10k`` pair beside it is folded
  in); LEAF kinds (``synthfemnist``, ``femnist``) read the writer shards
  (:mod:`repro_torch.data.ingest.leaf`), and the mirror writes
  ``n_writers`` hands only when no shard exists.
* ``data_dir=None`` — the synthetic flavours fall back to the in-memory
  generator (bit-identical to the IDX mirror's bits; ``synthfemnist``'s
  fallback carries no writers, so it takes the Dirichlet split); the
  real flavours raise the reference's ``ValueError``, since only files
  reach them.

:func:`load_stream` gives a LEAF flavour as a :class:`StreamPool`, the
writer table alone (the index, no shard payload), with an encoder
fitted without a pool, so ``quantile`` raises there as in the reference.

Raw pixel scales are normalized to [0, 1] here (u8 grayscale / 255,
LEAF floats and synthetic bits as they are) before the encoding
(:mod:`repro_torch.data.ingest.encode`).  The pool lies on ``device``,
the GPU unless the caller names another.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.data.ingest import encode, idx, leaf, mirror

SYNTH_DATASETS = ("synthmnist", "synthfashion", "synthfemnist")
REAL_DATASETS = ("mnist", "fashionmnist", "femnist")

T10K_IMAGES = "t10k-images-idx3-ubyte.gz"
T10K_LABELS = "t10k-labels-idx1-ubyte.gz"


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str              # "idx" (MNIST-family) | "leaf" (writer shards)
    n_classes: int
    flavour: str           # synthetic generator behind the offline mirror
    native_side: int | None = None   # real formats' fixed side; None:
    #                                  the caller's ``side`` (synth)

    def side_for(self, side: int | None) -> int:
        return self.native_side or side or 12


SPECS = {
    "synthmnist": DatasetSpec("synthmnist", "idx", 10, "synthmnist"),
    "synthfashion": DatasetSpec("synthfashion", "idx", 10, "synthfashion"),
    "synthfemnist": DatasetSpec("synthfemnist", "leaf", 62, "synthfemnist"),
    "mnist": DatasetSpec("mnist", "idx", 10, "synthmnist",
                         native_side=28),
    "fashionmnist": DatasetSpec("fashionmnist", "idx", 10, "synthfashion",
                                native_side=28),
    "femnist": DatasetSpec("femnist", "leaf", 62, "synthfemnist",
                           native_side=28),
}


class Pool(NamedTuple):
    """Encoded global pool and its metadata, ready for a partitioner."""

    x: torch.Tensor                # (N, F) uint8 bits (post-encoding)
    y: torch.Tensor                # (N,) int32 labels
    writers: torch.Tensor | None   # (N,) int32 writer ids, or None
    n_classes: int
    n_features: int                # F, after encoding (levels included)
    name: str


class StreamPool(NamedTuple):
    """A LEAF dataset as a writer table, nothing materialized: the shard
    root, the index's writer names and per-writer sample counts, and the
    fitted (elementwise) encoder; a cohort's rows are parsed and encoded
    on demand (``leaf.read_writers``), never the pool."""

    root: pathlib.Path             # shard directory (index.json present)
    users: tuple                   # (W,) writer names, index order
    writer_sizes: tuple            # (W,) per-writer sample counts
    n_classes: int
    n_features: int                # F, after encoding (levels included)
    encoder: object                # fitted encoder (elementwise)
    name: str
    verify: bool = True


def sha256(pool) -> str:
    """sha256 of a pool's arrays (x, y and the writer ids where there are
    any), hashed as :func:`repro_torch.data.partition.sha256` hashes a
    ClientData; the reference's pools hash the same way."""
    from repro_torch.data import partition
    return partition.sha256(pool, ("x", "y", "writers"))


def names() -> tuple:
    """Every registered dataset name (argparse ``choices`` derive here)."""
    return tuple(SPECS)


def get(name: str) -> DatasetSpec:
    spec = SPECS.get(name)
    if spec is None:
        raise ValueError(
            f"unknown dataset {name!r}; choose from {names()}")
    return spec


def _find(root: pathlib.Path, gz_name: str) -> pathlib.Path | None:
    """The .gz cache name or an uncompressed drop-in, never both (a real
    file shadowed by a stale mirror ``.gz`` fails loudly)."""
    gz, plain = root / gz_name, root / gz_name[:-len(".gz")]
    if gz.exists() and plain.exists():
        raise FileExistsError(
            f"both {gz.name!r} and {plain.name!r} exist under {root} — "
            f"remove the one you don't mean (a mirror-written .gz next "
            f"to a real drop-in, usually), plus any stale .sha256 "
            f"sidecar")
    for cand in (gz, plain):
        if cand.exists():
            return cand
    return None


def _pair(root: pathlib.Path, img_name: str, lab_name: str, what: str):
    """An images/labels IDX pair; a partial pair fails loudly."""
    img, lab = _find(root, img_name), _find(root, lab_name)
    if (img is None) != (lab is None):
        raise FileNotFoundError(
            f"partial {what} IDX pair under {root}: found "
            f"{(img or lab).name!r} without its counterpart — drop in "
            f"the full pair, or remove it")
    return img, lab


def _load_idx_pool(spec: DatasetSpec, root: pathlib.Path, n_samples: int,
                   side: int, seed: int, verify: bool, device):
    images_path, labels_path = _pair(root, mirror.IMAGES_FILE,
                                     mirror.LABELS_FILE, "train")
    if images_path is None:
        if any(root.glob("t10k-*")):
            raise FileNotFoundError(
                f"{root} holds t10k files but no train pair — drop in "
                f"the real train pair too (the offline mirror refuses "
                f"to write synthetic train data next to real files)")
        mirror.write_idx_mirror(root, spec.flavour, n_samples, side, seed,
                                device=device)
        images_path = _find(root, mirror.IMAGES_FILE)
        labels_path = _find(root, mirror.LABELS_FILE)
    images = idx.read(images_path, verify=verify)
    labels = idx.read(labels_path, verify=verify)
    t_img, t_lab = _pair(root, T10K_IMAGES, T10K_LABELS, "t10k")
    if t_img is not None:
        images = np.concatenate(
            [images, idx.read(t_img, verify=verify)], axis=0)
        labels = np.concatenate(
            [labels, idx.read(t_lab, verify=verify)], axis=0)
    if images.ndim != 3 or images.shape[0] != labels.shape[0]:
        raise idx.IDXFormatError(
            f"{root}: images {images.shape} vs labels {labels.shape}")
    unit = images.reshape(images.shape[0], -1).astype(np.float32) / 255.0
    return unit, labels.astype(np.int32), None


def _load_leaf_pool(spec: DatasetSpec, root: pathlib.Path, n_samples: int,
                    side: int, seed: int, n_writers: int, verify: bool,
                    device):
    if not sorted(root.glob(leaf.SHARD_PATTERN)):
        mirror.write_leaf_mirror(root, spec.flavour, n_samples, side, seed,
                                 n_writers=n_writers, device=device)
    pool = leaf.read_shards(root, verify=verify)
    return pool.x, pool.y, pool.writers


def load(name: str, data_dir: str | pathlib.Path | None = None, *,
         encoding: str = "bool", n_samples: int = 6000,
         side: int | None = None, seed: int = 0, n_writers: int = 25,
         verify: bool = True, device=None) -> Pool:
    """One dataset flavour as an encoded global :class:`Pool` on
    ``device`` (the GPU unless the caller names another).

    ``n_samples`` / ``side`` / ``n_writers`` / ``seed`` parameterize the
    offline mirror and the in-memory synthetic fallback; existing cache
    files fully determine the pool.  ``encoding`` is an
    :func:`repro_torch.data.ingest.encode.build` spec."""
    spec = get(name)
    device = devices.resolve(device)
    if data_dir is None:
        if name not in SYNTH_DATASETS:
            raise ValueError(
                f"dataset {name!r} is file-backed: pass a data_dir (the "
                f"offline mirror will populate it; drop real IDX/LEAF "
                f"files there for absolute paper numbers)")
        from repro_torch.data import synthetic
        x, labels, _ = synthetic.make_dataset(
            name, n_samples, rnd.PRNGKey(seed, device),
            side=spec.side_for(side))
        unit, writers = x.to(torch.float32), None
    else:
        root = pathlib.Path(data_dir) / name
        if spec.kind == "idx":
            unit, labels, writers = _load_idx_pool(
                spec, root, n_samples, spec.side_for(side), seed, verify,
                device)
        else:
            unit, labels, writers = _load_leaf_pool(
                spec, root, n_samples, spec.side_for(side), seed,
                n_writers, verify, device)
        unit = torch.from_numpy(unit).to(device)
        labels = torch.from_numpy(labels).to(device)
        if writers is not None:
            writers = torch.from_numpy(writers).to(device)
    bits = encode.build(encoding, pool=unit)(unit)
    return Pool(x=bits, y=labels, writers=writers,
                n_classes=spec.n_classes, n_features=int(bits.shape[1]),
                name=name)


def load_stream(name: str, data_dir: str | pathlib.Path, *,
                encoding: str = "bool", n_samples: int = 6000,
                side: int | None = None, seed: int = 0,
                n_writers: int = 25, verify: bool = True,
                device=None) -> StreamPool:
    """A LEAF flavour as a :class:`StreamPool`, the writer table only,
    for populations too large to materialize.

    The cache resolves as in :func:`load` (the mirror writes missing
    shards, drawn on ``device``; real drop-ins win), but no shard
    payload beyond the index is read here: ``leaf.ensure_index`` builds
    a missing index (one full parse, once).  The encoder is fitted
    without a pool, so ``quantile`` raises as
    :func:`repro_torch.data.ingest.encode.build` says."""
    spec = get(name)
    if spec.kind != "leaf":
        raise ValueError(
            f"dataset {name!r} is {spec.kind!r}-backed; streaming "
            f"ingestion needs per-writer LEAF shards — choose a leaf "
            f"flavour ({[n for n, s in SPECS.items() if s.kind == 'leaf']})")
    if data_dir is None:
        raise ValueError(
            f"streaming {name!r} is file-backed by construction: pass "
            f"a data_dir (the offline mirror will populate it)")
    root = pathlib.Path(data_dir) / name
    if not sorted(root.glob(leaf.SHARD_PATTERN)):
        mirror.write_leaf_mirror(root, spec.flavour, n_samples,
                                 spec.side_for(side), seed,
                                 n_writers=n_writers, device=device)
    index = leaf.ensure_index(root, verify=verify)
    users, sizes = [], []
    for entry in index["shards"]:
        users.extend(entry["users"])
        sizes.extend(entry["num_samples"])
    enc = encode.build(encoding)       # no pool: quantile raises here
    n_features = int(
        enc(torch.zeros((1, index["num_features"]))).shape[1])
    return StreamPool(root=root, users=tuple(users),
                      writer_sizes=tuple(int(s) for s in sizes),
                      n_classes=spec.n_classes, n_features=n_features,
                      encoder=enc, name=name, verify=verify)
