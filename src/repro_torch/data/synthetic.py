"""Offline synthetic stand-ins for the paper's datasets.

Counterpart of ``repro/data/synthetic.py``: class-structured boolean
images with MNIST's shape contract (``side × side`` bits, 10 or 62
classes).  Each class gets a prototype bitmap of a few random
axis-aligned strokes (digit-like for ``synthmnist``, denser textures for
``synthfashion``, 62 thin glyphs for ``synthfemnist``); a sample is its
class's prototype with i.i.d. bit-flip noise.

The pool is drawn with :mod:`repro_torch.random` exactly as the
reference draws it (its ``vmap`` over keys written out as a batch of
keys): ``make_dataset(name, n, key, side)`` equals the reference's
``make_dataset`` bit for bit, on the device that holds ``key``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as rnd
# the ingest registry is the single source of truth for dataset names
from repro_torch.data.ingest.registry import SYNTH_DATASETS as DATASETS


@dataclasses.dataclass(frozen=True)
class DataConfig:
    name: str = "synthmnist"
    side: int = 28               # image side
    n_classes: int = 10
    flip: float = 0.08           # bit-flip noise rate
    n_strokes: int = 4           # prototype complexity

    @property
    def n_features(self) -> int:
        return self.side * self.side


def dataset_config(name: str, side: int = 28) -> DataConfig:
    if name == "synthmnist":
        return DataConfig(name=name, side=side, n_classes=10, flip=0.08,
                          n_strokes=4)
    if name == "synthfashion":
        # denser, noisier textures: harder, as FMNIST is than MNIST
        return DataConfig(name=name, side=side, n_classes=10, flip=0.12,
                          n_strokes=7)
    if name == "synthfemnist":
        # 62 classes (digits and letters), thin glyphs: the hardest
        return DataConfig(name=name, side=side, n_classes=62, flip=0.10,
                          n_strokes=3)
    raise ValueError(f"unknown dataset {name!r}; choose from {DATASETS}")


def _stroke_masks(keys: torch.Tensor, side: int, thin: bool
                  ) -> torch.Tensor:
    """One random axis-aligned bar on a (side, side) grid per key:
    keys (..., 2) → (..., side, side) bool."""
    k = rnd.split(keys, 4)
    k1, k2, k3, k4 = (k[..., i, :] for i in range(4))
    r0 = rnd.randint(k1, (), 0, side)[..., None, None]
    c0 = rnd.randint(k2, (), 0, side)[..., None, None]
    max_thick = 2 if thin else max(side // 7, 2)
    length = rnd.randint(k3, (), side // 3, side)[..., None, None]
    thick = rnd.randint(k4, (), 1, max_thick + 1)[..., None, None]
    horiz = rnd.bernoulli(k1, 0.5)[..., None, None]     # k1 again, as there
    rr = torch.arange(side, device=keys.device)[:, None]
    cc = torch.arange(side, device=keys.device)[None, :]
    h = (rr >= r0) & (rr < r0 + thick) & (cc >= c0) & (cc < c0 + length)
    v = (cc >= c0) & (cc < c0 + thick) & (rr >= r0) & (rr < r0 + length)
    return torch.where(horiz, h, v)


def class_prototypes(cfg: DataConfig, key: torch.Tensor) -> torch.Tensor:
    """(n_classes, side·side) boolean prototype per class."""
    keys = rnd.split(rnd.split(key, cfg.n_classes), cfg.n_strokes)
    masks = _stroke_masks(keys, cfg.side, cfg.name == "synthfemnist")
    return masks.any(dim=1).reshape(cfg.n_classes, -1)


def sample(cfg: DataConfig, protos: torch.Tensor, y: torch.Tensor,
           key: torch.Tensor) -> torch.Tensor:
    """Boolean samples (uint8 0/1) for labels ``y``: the prototypes with
    bit-flip noise."""
    noise = rnd.bernoulli(key, cfg.flip, (y.shape[0], cfg.n_features))
    return torch.logical_xor(protos[y.long()], noise).to(torch.uint8)


def make_dataset(name: str, n_samples: int, key: torch.Tensor,
                 side: int = 28):
    """Balanced global pool on ``key``'s device: (x (N, o) uint8 0/1,
    y (N,) int32, cfg)."""
    cfg = dataset_config(name, side=side)
    kp, ky, kx = rnd.split(key, 3).unbind(0)
    protos = class_prototypes(cfg, kp)
    y = rnd.randint(ky, (n_samples,), 0, cfg.n_classes)
    return sample(cfg, protos, y, kx), y, cfg
