"""Deterministic batching for both workload kinds.

Counterpart of ``repro/data/loader.py``; each draw is the reference's bit
for bit (:mod:`repro_torch.random`), on ``device`` (the GPU unless the
caller names another).

* :class:`TokenBatcher` — LM training batches (tokens/labels) from the
  modality-appropriate stub stream, seeded per step.
* :class:`FederatedSampler` — per-(client, round, epoch) minibatch order,
  shuffled without replacement.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import random as trandom
from repro_torch.models import stubs
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TokenBatcher:
    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0
    device: Any = None

    def _draw(self, step: int) -> torch.Tensor:
        key = trandom.fold_in(trandom.PRNGKey(self.seed, self.device), step)
        return stubs.tokens_for(self.cfg, key, self.batch, self.seq_len + 1)

    def __call__(self, step: int) -> dict[str, torch.Tensor]:
        toks = self._draw(step)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class FederatedSampler:
    """Per-(client, round, epoch) minibatch order, shuffled without
    replacement: a pure function of ``(seed, client, rnd, epoch)``, each
    draw keying a fresh ``fold_in`` chain off the seed."""

    n_samples: int
    batch: int
    seed: int = 0
    device: Any = None

    def epoch_order(self, client: int, rnd: int, epoch: int) -> torch.Tensor:
        key = trandom.fold_in(trandom.fold_in(trandom.fold_in(
            trandom.PRNGKey(self.seed, self.device), client), rnd), epoch)
        return trandom.permutation(key, self.n_samples)

    def batches(self, client: int, rnd: int, epoch: int) -> torch.Tensor:
        order = self.epoch_order(client, rnd, epoch)
        n = (self.n_samples // self.batch) * self.batch
        return order[:n].reshape(-1, self.batch)
