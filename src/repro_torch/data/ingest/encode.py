"""Feature encodings: unit-scale pixels → TM-ready bits, on tensors.

Counterpart of ``repro/data/ingest/encode.py``.  Every encoder is a
frozen dataclass whose ``__call__`` maps a float32 tensor in [0, 1] (the
registry normalizes raw pixel scales first) to uint8 bits, feature-major
(pixel f's ``levels`` bits are contiguous, ``f·levels + k``):

* :class:`Booleanize` — one bit a pixel, ``x >= threshold``;
* :class:`Thermometer` — ``levels`` bits a pixel at the thresholds
  ``f32(k + 1) / f32(levels + 1)``;
* :class:`Quantile` — ``levels`` bits a pixel at per-feature thresholds
  fitted at the pool's empirical quantiles (:meth:`Quantile.fit`), as
  ``jnp.quantile``'s ``linear`` method computes them in float32: the
  position ``q·(n - 1)``, and ``fma(low, 1 - w, high·w)`` between the
  sorted neighbours.  A bit is ``x > threshold``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import xla_f32

ENCODINGS = ("bool", "thermometer", "quantile")


def _levels(levels: int, device) -> torch.Tensor:
    """``(arange(levels) + 1) / (levels + 1)`` in float32."""
    return (torch.arange(levels, dtype=torch.float32, device=device) + 1.0
            ) / float(levels + 1)


@dataclasses.dataclass(frozen=True)
class Booleanize:
    threshold: float = 0.5

    def out_features(self, n_in: int) -> int:
        return n_in

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x >= torch.tensor(self.threshold, dtype=torch.float32)
                ).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class Thermometer:
    levels: int = 4

    def out_features(self, n_in: int) -> int:
        return n_in * self.levels

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        bits = (x[..., :, None] >= _levels(self.levels, x.device)
                ).to(torch.uint8)
        return bits.reshape(*x.shape[:-1], x.shape[-1] * self.levels)


@dataclasses.dataclass(frozen=True, eq=False)
class Quantile:
    """Per-feature thermometer at fitted quantile thresholds,
    ``thresholds`` (n_features, levels)."""

    thresholds: torch.Tensor

    @classmethod
    def fit(cls, pool: torch.Tensor, levels: int = 4) -> "Quantile":
        a = torch.sort(pool.to(torch.float32), dim=0).values   # (n, F)
        n = a.shape[0]
        q = _levels(levels, a.device) * float(n - 1)
        low = torch.floor(q)
        high_w = q - low
        low_w = 1.0 - high_w
        lo = low.clamp(0, n - 1).long()
        hi = torch.ceil(q).clamp(0, n - 1).long()
        th = xla_f32.fma(a[lo], low_w[:, None], a[hi] * high_w[:, None])
        return cls(thresholds=th.T.contiguous())

    @property
    def levels(self) -> int:
        return int(self.thresholds.shape[1])

    def out_features(self, n_in: int) -> int:
        return n_in * self.levels

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        bits = (x[..., :, None] > self.thresholds.to(x.device)
                ).to(torch.uint8)
        return bits.reshape(*x.shape[:-1], x.shape[-1] * self.levels)


def build(spec: str, pool: torch.Tensor | None = None):
    """Parse an encoding spec: ``bool`` / ``bool:<threshold>``,
    ``thermometer:<levels>`` (default 4), ``quantile:<levels>`` (default
    4; needs ``pool``, the unit-scale global pool to fit on)."""
    name, _, arg = spec.partition(":")
    if name == "bool":
        return Booleanize(threshold=float(arg) if arg else 0.5)
    if name == "thermometer":
        return Thermometer(levels=int(arg) if arg else 4)
    if name == "quantile":
        if pool is None:
            raise ValueError("quantile encoding needs the pool to fit on")
        return Quantile.fit(pool, levels=int(arg) if arg else 4)
    raise ValueError(
        f"unknown encoding {spec!r}; choose from "
        f"bool[:threshold] | thermometer[:levels] | quantile[:levels]")
