"""Offline stand-ins for the paper's image datasets.

Counterpart of ``repro/data/synthetic.py``.  Each class gets a prototype
bitmap of a few random axis-aligned strokes; a sample is its class's
prototype with i.i.d. bit-flip noise.  ``synthmnist`` is the 12×12 pool
the repository's default scenario uses; ``mnist`` is the same generator
at MNIST's 28×28 width (784 features, 1568 literals), the paper's model
width.

The pool is drawn with :mod:`repro_torch.random` exactly as the JAX
package's ``make_dataset`` draws it (its ``vmap`` over keys written out
as a batch of keys): ``make_pool("synthmnist", n, seed)`` equals
``make_dataset("synthmnist", n, PRNGKey(seed), side=12)`` bit for bit,
and ``make_pool("mnist", n, seed)`` the same generator at ``side=28``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as rnd

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


def _stroke_masks(keys: torch.Tensor, side: int) -> torch.Tensor:
    """One random axis-aligned bar on a (side, side) grid per key:
    keys (..., 2) → (..., side, side) bool."""
    k = rnd.split(keys, 4)
    k1, k2, k3, k4 = (k[..., i, :] for i in range(4))
    r0 = rnd.randint(k1, (), 0, side)[..., None, None]
    c0 = rnd.randint(k2, (), 0, side)[..., None, None]
    length = rnd.randint(k3, (), side // 3, side)[..., None, None]
    thick = rnd.randint(k4, (), 1, max(side // 7, 2) + 1)[..., None, None]
    horiz = rnd.bernoulli(k1, 0.5)[..., None, None]     # k1 again, as there
    rr = torch.arange(side, device=keys.device)[:, None]
    cc = torch.arange(side, device=keys.device)[None, :]
    h = (rr >= r0) & (rr < r0 + thick) & (cc >= c0) & (cc < c0 + length)
    v = (cc >= c0) & (cc < c0 + thick) & (rr >= r0) & (rr < r0 + length)
    return torch.where(horiz, h, v)


def class_prototypes(cfg: DataConfig, key: torch.Tensor) -> torch.Tensor:
    """(n_classes, side·side) boolean prototype per class."""
    keys = rnd.split(rnd.split(key, cfg.n_classes), cfg.n_strokes)
    masks = _stroke_masks(keys, cfg.side)          # (C, strokes, side, side)
    return masks.any(dim=1).reshape(cfg.n_classes, -1)


def make_pool(name: str, n_samples: int, seed: int
              ) -> tuple[np.ndarray, np.ndarray, DataConfig]:
    """Balanced global pool: (x (n, o) uint8 0/1, y (n,) int32, cfg),
    drawn on the CPU from ``PRNGKey(seed)``."""
    cfg = dataset_config(name)
    kp, ky, kx = rnd.split(rnd.PRNGKey(seed, "cpu"), 3).unbind(0)
    protos = class_prototypes(cfg, kp)
    y = rnd.randint(ky, (n_samples,), 0, cfg.n_classes)
    noise = rnd.bernoulli(kx, cfg.flip, (n_samples, cfg.n_features))
    x = torch.logical_xor(protos[y.long()], noise).to(torch.uint8)
    return x.numpy(), y.numpy(), cfg
