"""Dispatch for the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  A CUDA tensor goes to the
hand-written kernel, which raises on what it cannot take; a CPU tensor
goes to the plain version (:mod:`repro_torch.kernels.ref`; for the
fused epoch ``train_epoch.train_epoch_plain``, for the TA transition
``ta_update.ta_update_plain``).  There is
no fallback between the two.  ``LAUNCHES`` counts each kernel's launches
(plain-version calls are not counted).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import clause_eval, ref, train_epoch
from repro_torch.kernels import ta_update as _ta
from repro_torch.kernels._build import LAUNCHES  # noqa: F401


def clause_outputs(include: torch.Tensor, lits: torch.Tensor,
                   predict: bool = False) -> torch.Tensor:
    """Clause outputs: (…,CM,L) × (…,B,L) → fired (…,B,CM) int32."""
    if include.is_cuda:
        return clause_eval.clause_outputs(include, lits, predict)
    return ref.clause_outputs_ref(include, lits, predict)


def fused_votes(include: torch.Tensor, lits: torch.Tensor,
                wpol: torch.Tensor, predict: bool = True) -> torch.Tensor:
    """One model's Eq.-1 votes: (C,m,L) × (B,L) × (C,m) → (B,C)."""
    if include.is_cuda:
        return clause_eval.fused_votes(include, lits, wpol, predict)
    return ref.fused_votes_ref(include, lits, wpol, predict)


def fused_votes_batched(include: torch.Tensor, lits: torch.Tensor,
                        wpol: torch.Tensor, predict: bool = True
                        ) -> torch.Tensor:
    """Client-batched Eq.-1 votes: (N,C,m,L) × (N,B,L) × (N,C,m) → (N,B,C)."""
    if include.is_cuda:
        return clause_eval.fused_votes_batched(include, lits, wpol, predict)
    return ref.fused_votes_batched_ref(include, lits, wpol, predict)


def ta_update_(ta: torch.Tensor, lits: torch.Tensor, fired: torch.Tensor,
               votes: torch.Tensor, cls2: torch.Tensor,
               role_keys: torch.Tensor, *, T: int, p_inc: float,
               p_dec: float, n_states: int) -> torch.Tensor:
    """One sample step's Type I/II TA transitions of both roles of every
    client, in place on ta (N,C,m,L), drawn from the step's role keys; see
    ta_update.ta_update_plain."""
    args = (ta, lits, fired, votes, cls2, role_keys)
    kw = dict(T=T, p_inc=p_inc, p_dec=p_dec, n_states=n_states)
    if ta.is_cuda:
        return _ta.ta_update_(*args, **kw)
    return _ta.ta_update_plain(*args, **kw)


def train_epoch_fused(ta: torch.Tensor, w: torch.Tensor, lits: torch.Tensor,
                      cls2: torch.Tensor, role_keys: torch.Tensor, *,
                      n_states: int, T: int, p_inc: float, p_dec: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused training epoch over stacked clients under the role keys of
    draws.epoch_keys; see train_epoch.train_epoch_plain."""
    kw = dict(n_states=n_states, T=T, p_inc=p_inc, p_dec=p_dec)
    if ta.is_cuda:
        return train_epoch.train_epoch_fused(ta, w, lits, cls2, role_keys,
                                             **kw)
    return train_epoch.train_epoch_plain(ta, w, lits, cls2, role_keys, **kw)
