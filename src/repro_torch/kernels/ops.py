"""Dispatch for the kernels on the training round's path.

Counterpart of ``repro/kernels/ops.py``.  A CUDA tensor goes to the
hand-written kernel, which raises on what it cannot take; a CPU tensor
goes to the plain version in :mod:`repro_torch.kernels.ref`.  There is
no fallback between the two.  ``LAUNCHES`` counts each kernel's launches
(plain-version calls are not counted).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import clause_eval, ref, train_epoch
from repro_torch.kernels._build import LAUNCHES  # noqa: F401


def fused_votes_batched(include: torch.Tensor, lits: torch.Tensor,
                        wpol: torch.Tensor, predict: bool = True
                        ) -> torch.Tensor:
    """Client-batched Eq.-1 votes: (N,C,m,L) × (N,B,L) × (N,C,m) → (N,B,C)."""
    if include.is_cuda:
        return clause_eval.fused_votes_batched(include, lits, wpol, predict)
    return ref.fused_votes_batched_ref(include, lits, wpol, predict)


def train_epoch_fused(ta: torch.Tensor, w: torch.Tensor, lits: torch.Tensor,
                      cls2: torch.Tensor, u_act: torch.Tensor,
                      coin: torch.Tensor, *, n_states: int, T: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused training epoch over stacked clients; see ref.train_epoch_ref."""
    if ta.is_cuda:
        return train_epoch.train_epoch_fused(ta, w, lits, cls2, u_act, coin,
                                             n_states=n_states, T=T)
    return ref.train_epoch_ref(ta, w, lits, cls2, u_act, coin,
                               n_states=n_states, T=T)
