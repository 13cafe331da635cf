"""Offline stand-ins for the paper's image datasets, drawn with numpy.

Counterpart of ``repro/data/synthetic.py``.  Each class gets a prototype
bitmap of a few random axis-aligned strokes; a sample is its class's
prototype with i.i.d. bit-flip noise.  ``synthmnist`` is the 12×12 pool
the repository's default scenario uses; ``mnist`` is the same generator
at MNIST's 28×28 width (784 features, 1568 literals), the paper's model
width.

The pool comes from a seeded ``numpy.random.Generator``.  It is *not*
bit-identical to the JAX package's pool, which draws with ``jax.random``
(and, for ``mnist``, through the ingest mirror); tests that compare the
two packages build one dataset with numpy and hand it to both.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DATASETS = ("synthmnist", "mnist")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    name: str = "synthmnist"
    side: int = 12
    n_classes: int = 10
    flip: float = 0.08            # bit-flip noise rate
    n_strokes: int = 4            # prototype complexity

    @property
    def n_features(self) -> int:
        return self.side * self.side


def dataset_config(name: str) -> DataConfig:
    if name == "synthmnist":
        return DataConfig(name=name, side=12)
    if name == "mnist":
        return DataConfig(name=name, side=28)
    raise ValueError(f"unknown dataset {name!r}; choose from {DATASETS}")


def _stroke(rng: np.random.Generator, side: int) -> np.ndarray:
    """One random axis-aligned bar on a (side, side) grid."""
    r0, c0 = rng.integers(0, side, size=2)
    length = rng.integers(side // 3, side)
    thick = rng.integers(1, max(side // 7, 2) + 1)
    mask = np.zeros((side, side), bool)
    if rng.random() < 0.5:
        mask[r0:r0 + thick, c0:c0 + length] = True
    else:
        mask[r0:r0 + length, c0:c0 + thick] = True
    return mask


def class_prototypes(cfg: DataConfig, rng: np.random.Generator
                     ) -> np.ndarray:
    """(n_classes, side·side) boolean prototype per class."""
    protos = np.zeros((cfg.n_classes, cfg.n_features), bool)
    for c in range(cfg.n_classes):
        for _ in range(cfg.n_strokes):
            protos[c] |= _stroke(rng, cfg.side).reshape(-1)
    return protos


def make_pool(name: str, n_samples: int, seed: int
              ) -> tuple[np.ndarray, np.ndarray, DataConfig]:
    """Balanced global pool: (x (n, o) uint8 0/1, y (n,) int32, cfg)."""
    cfg = dataset_config(name)
    rng = np.random.default_rng(seed)
    protos = class_prototypes(cfg, rng)
    y = rng.integers(0, cfg.n_classes, size=n_samples).astype(np.int32)
    noise = rng.random((n_samples, cfg.n_features)) < cfg.flip
    x = np.logical_xor(protos[y], noise).astype(np.uint8)
    return x, y, cfg
