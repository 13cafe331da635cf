"""Offline mirror: the synthetic generators written as IDX / LEAF files.

Counterpart of ``repro/data/ingest/mirror.py``.  The first time a
dataset is requested under a ``--data-dir``, the mirror writes genuine
files from the synthetic generator; from then on every load goes bytes
→ parser → encoder → partitioner, the path real files take.  Real files
dropped into the same layout are used instead (the mirror never
overwrites).  Both writers are byte-identical to the reference's mirror
for the same arguments:

* :func:`write_idx_mirror` — ``train-images-idx3-ubyte.gz`` (N, side,
  side) u8 grayscale (the synthetic bits as 0/255) and
  ``train-labels-idx1-ubyte.gz`` u1 labels, each with a ``.sha256``
  sidecar;
* :func:`write_leaf_mirror` — ``all_data_<k>.json`` LEAF shards and
  ``index.json``: ``n_writers`` synthetic hands whose sample counts come
  from a Dirichlet allocation (some hold ~10× others) and whose labels
  come from a spiked per-writer class mixture.
"""
from __future__ import annotations

import pathlib

import numpy as np

import torch

from repro_torch import random as rnd
from repro_torch import xla_f32
from repro_torch.data.ingest import idx, leaf

IMAGES_FILE = "train-images-idx3-ubyte.gz"
LABELS_FILE = "train-labels-idx1-ubyte.gz"

# fold_in tags: one disjoint stream per mirror decision
_TAG_SIZES, _TAG_MIX, _TAG_LABELS, _TAG_PIXELS = 0x1D1, 0x1D2, 0x1D3, 0x1D4

# per-writer class-mixture concentration: spiked (each hand favours a few
# glyphs) but wider than the Dirichlet partitioner's 0.05
WRITER_MIX_ALPHA = 0.3


def write_idx_mirror(root: str | pathlib.Path, flavour: str,
                     n_samples: int, side: int, seed: int,
                     device=None) -> None:
    """Write the IDX train pair under ``root`` from synthetic
    ``flavour``, drawn on ``device`` (the GPU unless the caller names
    another)."""
    from repro_torch.data import synthetic
    root = pathlib.Path(root)
    x, y, _ = synthetic.make_dataset(flavour, n_samples,
                                     rnd.PRNGKey(seed, device), side=side)
    x = x.cpu().numpy()
    images = x.reshape(n_samples, side, side) * np.uint8(255)
    idx.write(root / IMAGES_FILE, images)
    idx.write(root / LABELS_FILE, y.cpu().numpy().astype(np.uint8))


def write_leaf_mirror(root: str | pathlib.Path, flavour: str,
                      n_samples: int, side: int, seed: int,
                      n_writers: int = 25, device=None) -> None:
    """Write LEAF shards under ``root``: ``n_writers`` synthetic hands
    with heterogeneous sizes and spiked per-writer class mixtures, drawn
    on ``device`` (the GPU unless the caller names another)."""
    from repro_torch.data import synthetic
    cfg = synthetic.dataset_config(flavour, side=side)
    key = rnd.PRNGKey(seed, device)
    protos = synthetic.class_prototypes(cfg, rnd.fold_in(key, 0))
    props = rnd.dirichlet(rnd.fold_in(key, _TAG_SIZES),
                          torch.ones(n_writers, dtype=torch.float32,
                                     device=key.device))
    sizes = np.maximum(
        np.floor(props.cpu().numpy() * n_samples), 4).astype(np.int64)
    mixtures = rnd.dirichlet(
        rnd.fold_in(key, _TAG_MIX),
        torch.full((cfg.n_classes,), WRITER_MIX_ALPHA, dtype=torch.float32,
                   device=key.device), (n_writers,))
    # the reference's eager ``+ 1e-9`` is a float32 add
    eps = torch.tensor(1e-9, dtype=torch.float32, device=key.device)
    k_labels = rnd.fold_in(key, _TAG_LABELS)
    k_pixels = rnd.fold_in(key, _TAG_PIXELS)
    users, xs, ys = [], [], []
    for w in range(n_writers):
        y = rnd.categorical(rnd.fold_in(k_labels, w),
                            xla_f32.log(mixtures[w] + eps),
                            (int(sizes[w]),))
        x = synthetic.sample(cfg, protos, y, rnd.fold_in(k_pixels, w))
        users.append(f"w{w:04d}")
        # unit-scale floats, as real LEAF FEMNIST stores pixels
        xs.append(x.cpu().numpy().astype(np.float32))
        ys.append(y.cpu().numpy().astype(np.int32))
    leaf.write_shards(root, users, xs, ys)
