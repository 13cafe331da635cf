"""Multiclass weighted Tsetlin Machine on PyTorch: the TPFL client model.

Counterpart of ``repro/core/tm.py`` (paper §4.1, Fig. 1, Eq. 1), for the
client-batched entry points a federated round calls.  State is two
integer tensors with a leading client axis N:

* ``ta_state`` (N, C, m, 2o) int32 — TA states in [1, 2·n_states]; a
  literal is included in a clause iff its state exceeds ``n_states``;
* ``weights``  (N, C, m) int32 — clause vote weights.

Clause polarity is positional: even clauses vote for their class, odd
ones against it.  All randomness is keyed (:mod:`repro_torch.random`),
so with the same keys every function here is bit-identical to the JAX
package.  On CUDA tensors the clause evaluation and training run in the
hand-written kernels (:mod:`repro_torch.kernels.ops`); on CPU tensors in
their plain versions.

Not ported yet: the per-sample scan path (``_train_one_sample``,
``_feedback_one_class``) and its ``ta_update`` kernel, which the JAX
package takes for ``weighted=False`` training.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.kernels import draws, ops, ref


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """Hyperparameters, named as in the paper (Table 2)."""

    n_classes: int = 10
    n_clauses: int = 300          # m, per class
    n_features: int = 784         # o (booleanized input bits)
    n_states: int = 127           # N; TA states span [1, 2N]
    s: float = 10.0               # sensitivity (specificity)
    T: int = 1000                 # feedback / vote-clip threshold
    weighted: bool = True         # integer-weighted clauses (Eq. 1)
    boost_true_positive: bool = False

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features


class TMParams(NamedTuple):
    ta_state: torch.Tensor   # (..., C, m, 2o) int32
    weights: torch.Tensor    # (..., C, m) int32


def init_params(cfg: TMConfig, key: torch.Tensor) -> TMParams:
    """TA states start at the exclude/include boundary (N or N+1).

    ``key`` may carry leading axes (one key per client); the parameters
    then carry them too, as ``jax.vmap(init_params)`` would."""
    shape = (cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    coin = rnd.bernoulli(key, 0.5, shape)
    ta = torch.where(coin, cfg.n_states, cfg.n_states + 1).to(torch.int32)
    w = torch.ones(key.shape[:-1] + shape[:2], dtype=torch.int32,
                   device=key.device)
    return TMParams(ta_state=ta, weights=w)


def literals(x: torch.Tensor) -> torch.Tensor:
    """L = [x1..xo, ¬x1..¬xo] (paper §4.1) as int32 0/1."""
    x = x.to(torch.int32)
    return torch.cat([x, 1 - x], dim=-1)


def include_mask(params: TMParams, cfg: TMConfig) -> torch.Tensor:
    """Included literals as a bool plane (one byte per literal)."""
    return params.ta_state > cfg.n_states


def clause_polarity(cfg: TMConfig, device) -> torch.Tensor:
    """+1 for even-indexed clauses, −1 for odd-indexed (paper §4.1)."""
    j = torch.arange(cfg.n_clauses, device=device)
    return torch.where(j % 2 == 0, 1, -1).to(torch.int32)


def _feedback_probs(cfg: TMConfig) -> tuple[float, float]:
    p_inc = 1.0 if cfg.boost_true_positive else (cfg.s - 1.0) / cfg.s
    return p_inc, 1.0 / cfg.s


# ---------------------------------------------------------------------------
# Client-batched entry points (leading client axis N everywhere)
# ---------------------------------------------------------------------------

def train_batched(params: TMParams, xs: torch.Tensor, ys: torch.Tensor,
                  keys: torch.Tensor, cfg: TMConfig,
                  epochs: int = 1) -> TMParams:
    """params (N, ...); xs (N,S,o); ys (N,S); keys (N,2) → trained params.

    Each epoch draws its randomness under the reference key discipline
    (per client ``split(key, epochs)``, then :func:`draws.epoch_draws`)
    and runs one fused-epoch launch for all N clients."""
    if not cfg.weighted:
        raise NotImplementedError(
            "weighted=False trains through the per-sample scan and the "
            "ta_update kernel, which a later slice ports (ROADMAP.md)")
    p_inc, p_dec = _feedback_probs(cfg)
    n_samples = ys.shape[1]
    lits = literals(xs).contiguous()
    ys32 = ys.to(torch.int32)
    ekeys = rnd.split(keys, epochs)                     # (N, epochs, 2)
    ta, w = params.ta_state, params.weights
    for e in range(epochs):
        offs, u_act, coin = draws.epoch_draws(
            ekeys[:, e], n_samples, cfg.n_clauses, cfg.n_literals,
            cfg.n_classes, p_inc, p_dec)
        cls2 = torch.stack([ys32, (ys32 + offs) % cfg.n_classes], dim=-1)
        ta, w = ops.train_epoch_fused(ta, w, lits, cls2.contiguous(), u_act,
                                      coin, n_states=cfg.n_states, T=cfg.T)
        del coin
    return TMParams(ta_state=ta, weights=w)


def confidence_scores_batched(params: TMParams, x_conf: torch.Tensor,
                              cfg: TMConfig,
                              weighted: bool = False) -> torch.Tensor:
    """Alg. 1 step 6, stacked: params (N, ...), x_conf (N,B,o) → (N,C).

    conf[c] = Σ_x (Σ_j C⁺_j(x) − Σ_j C⁻_j(x)), the unweighted clause
    margin; ``weighted=True`` uses the Eq.-1 weighted margin."""
    pol = clause_polarity(cfg, params.weights.device)
    if weighted:
        wpol = pol * params.weights
    else:
        wpol = pol.expand(params.weights.shape)
    margin = ops.fused_votes_batched(include_mask(params, cfg),
                                     literals(x_conf), wpol, predict=True)
    return margin.sum(dim=1, dtype=torch.int32)


def predict_batched(params: TMParams, x: torch.Tensor,
                    cfg: TMConfig) -> torch.Tensor:
    """Stacked predictions: params (N, ...), x (N,B,o) → (N,B) int64.

    One fused-votes launch for all N models; votes are clipped to ±T
    before the argmax (Eq. 1), and ties go to the lowest class, as
    ``jnp.argmax`` does."""
    pol = clause_polarity(cfg, params.weights.device)
    w = params.weights if cfg.weighted else torch.ones_like(params.weights)
    votes = ops.fused_votes_batched(include_mask(params, cfg), literals(x),
                                    pol * w, predict=True)
    return torch.argmax(votes.clamp(-cfg.T, cfg.T), dim=-1)


def accuracy_batched(params: TMParams, x: torch.Tensor, y: torch.Tensor,
                     cfg: TMConfig) -> torch.Tensor:
    """Stacked accuracy: params (N, ...), x (N,B,o), y (N,B) → (N,) f32:
    the exact hit count times f32(1/B), which is what the reference's
    ``jnp.mean`` computes once compiled (see ``ref.reciprocal_f32``)."""
    hits = (predict_batched(params, x, cfg) == y).sum(-1).to(torch.float32)
    return hits * torch.full_like(hits, ref.reciprocal_f32(y.shape[-1]))
