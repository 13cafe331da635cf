"""`DatasetSpec` registry: one ``load(name, data_dir)`` for every flavour.

Counterpart of ``repro/data/ingest/registry.py`` and the single source
of truth for the port's dataset names (``synthetic.DATASETS`` and the
CLIs' ``--dataset`` choices derive from it).

``load`` returns a :class:`Pool`, the encoded global pool a partitioner
takes.  Resolution, per spec kind:

* ``data_dir`` given — files under ``<data_dir>/<name>/`` are parsed
  (checksum-verified where ``.sha256`` sidecars exist); a missing IDX
  train pair is first written by the offline mirror
  (:mod:`repro_torch.data.ingest.mirror`), then parsed through the same
  reader, so the pool is always a function of the file bytes.  A real
  ``t10k`` pair beside it is folded into the pool.  LEAF kinds
  (``synthfemnist``, ``femnist``) raise ``NotImplementedError``: their
  reader and mirror are ROADMAP item A7.
* ``data_dir=None`` — the synthetic flavours fall back to the in-memory
  generator (bit-identical to the IDX mirror's bits); the real flavours
  raise the reference's ``ValueError``, since only files reach them.

Raw pixel scales are normalized to [0, 1] here (u8 grayscale / 255,
synthetic bits as they are) before the encoding
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
from repro_torch.data.ingest import encode, idx, mirror

SYNTH_DATASETS = ("synthmnist", "synthfashion", "synthfemnist")

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
    return (torch.from_numpy(unit).to(device),
            torch.from_numpy(labels.astype(np.int32)).to(device))


def load(name: str, data_dir: str | pathlib.Path | None = None, *,
         encoding: str = "bool", n_samples: int = 6000,
         side: int | None = None, seed: int = 0, verify: bool = True,
         device=None) -> Pool:
    """One dataset flavour as an encoded global :class:`Pool` on
    ``device`` (the GPU unless the caller names another).

    ``n_samples`` / ``side`` / ``seed`` parameterize the offline mirror
    and the in-memory synthetic fallback; existing cache files fully
    determine the pool.  ``encoding`` is an
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
        unit = x.to(torch.float32)
    elif spec.kind == "idx":
        unit, labels = _load_idx_pool(
            spec, pathlib.Path(data_dir) / name, n_samples,
            spec.side_for(side), seed, verify, device)
    else:
        raise NotImplementedError(
            f"dataset {name!r} is a LEAF (writer-shard) kind: its reader, "
            f"mirror and writer-natural partition are not ported yet "
            f"(ROADMAP.md queue A, item A7)")
    bits = encode.build(encoding, pool=unit)(unit)
    return Pool(x=bits, y=labels, writers=None, n_classes=spec.n_classes,
                n_features=int(bits.shape[1]), name=name)
