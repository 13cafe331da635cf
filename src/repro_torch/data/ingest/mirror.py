"""Offline mirror: the synthetic generators written as IDX files.

Counterpart of ``repro/data/ingest/mirror.py``'s IDX half.  The first
time a dataset is requested under a ``--data-dir``, the mirror writes
genuine IDX files from the synthetic generator; from then on every load
goes bytes → parser → encoder → partitioner, the path real files take.
Real MNIST-family files dropped into the same layout are used instead
(the mirror never overwrites).

:func:`write_idx_mirror` writes ``train-images-idx3-ubyte.gz`` (N, side,
side) u8 grayscale (the synthetic bits as 0/255) and
``train-labels-idx1-ubyte.gz`` u1 labels, each with a ``.sha256``
sidecar, byte-identical to the reference's mirror for the same
arguments.  The LEAF mirror is not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import pathlib

import numpy as np

from repro_torch import random as rnd
from repro_torch.data.ingest import idx

IMAGES_FILE = "train-images-idx3-ubyte.gz"
LABELS_FILE = "train-labels-idx1-ubyte.gz"


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
