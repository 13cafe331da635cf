"""Multiclass weighted Tsetlin Machine on PyTorch: the TPFL client model.

Counterpart of ``repro/core/tm.py`` (paper §4.1, Fig. 1, Eq. 1).  State
is two integer tensors:

* ``ta_state`` (C, m, 2o) int32 — TA states in [1, 2·n_states]; a
  literal is included in a clause iff its state exceeds ``n_states``;
* ``weights``  (C, m) int32 — clause vote weights (all of them count as
  1 when ``weighted=False``, the classic unit-weight TM).

The single-model API (``clause_outputs``, ``class_votes``, ``forward``,
``predict``, ``accuracy``, ``confidence_scores``, ``train_epoch``,
``train``) takes params without a client axis; the ``*_batched`` entry
points a federated round calls take a leading client axis N.

Clause polarity is positional: even clauses vote for their class, odd
ones against it.  All randomness is keyed (:mod:`repro_torch.random`),
so with the same keys every function here is bit-identical to the JAX
package.  On CUDA tensors the clause evaluation and training run in the
hand-written kernels (:mod:`repro_torch.kernels.ops`); on CPU tensors in
their plain versions.  The device decides: there is no ``use_kernel``.

Training takes one of two paths, as the JAX package's kernel path does:
the weighted TM trains an epoch in one fused-epoch launch for all N
clients; the unit-weight TM (``weighted=False``) trains through the
per-sample scan, in which each sample step evaluates every client's
clauses in one ``clause_outputs`` launch and updates the target and the
negative class of every client in place in one ``ta_update_`` launch,
which draws its randomness from the epoch's role keys.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.fl.obs import tracer
from repro_torch.kernels import ops, ref


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


def _wpol(params: TMParams, cfg: TMConfig) -> torch.Tensor:
    """polarity · weight (…, C, m); unit weights when ``weighted=False``."""
    pol = clause_polarity(cfg, params.weights.device)
    return pol * params.weights if cfg.weighted else pol.expand(
        params.weights.shape)


# ---------------------------------------------------------------------------
# Single-model forward pass (no client axis; a leading one is carried)
# ---------------------------------------------------------------------------

def clause_outputs(params: TMParams, lits: torch.Tensor, cfg: TMConfig,
                   predict: bool = False) -> torch.Tensor:
    """lits (…, B, L) 0/1 → clause outputs (…, B, C, m) int32, one
    ``clause_outputs`` launch.  Empty clauses fire while learning and
    stay silent in predict mode."""
    include = include_mask(params, cfg)
    fired = ops.clause_outputs(include.flatten(-3, -2), lits, predict)
    return fired.unflatten(-1, (cfg.n_classes, cfg.n_clauses))


def class_votes(params: TMParams, clauses: torch.Tensor, cfg: TMConfig,
                clip: bool = True) -> torch.Tensor:
    """Eq. 1: v[b, c] = Σ_j pol_j · w_j · clause_j, clipped to [−T, T]:
    clauses (…, B, C, m) → votes (…, B, C) int32."""
    wpol = _wpol(params, cfg).unsqueeze(-3)
    v = (clauses.to(torch.int32) * wpol).sum(-1, dtype=torch.int32)
    return v.clamp(-cfg.T, cfg.T) if clip else v


def forward(params: TMParams, x: torch.Tensor, cfg: TMConfig,
            predict: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, o) 0/1 → (clause outputs (B, C, m), clipped votes (B, C))."""
    cl = clause_outputs(params, literals(x), cfg, predict=predict)
    return cl, class_votes(params, cl, cfg)


def predict(params: TMParams, x: torch.Tensor, cfg: TMConfig
            ) -> torch.Tensor:
    """x (B, o) → predicted classes (B,) int64: one ``fused_votes``
    launch, the votes clipped to ±T before the argmax (ties go to the
    lowest class, as ``jnp.argmax`` does)."""
    votes = ops.fused_votes(include_mask(params, cfg), literals(x),
                            _wpol(params, cfg), predict=True)
    return torch.argmax(votes.clamp(-cfg.T, cfg.T), dim=-1)


def accuracy(params: TMParams, x: torch.Tensor, y: torch.Tensor,
             cfg: TMConfig) -> torch.Tensor:
    """() float32: the hit count times f32(1/B), as the reference's
    ``jnp.mean`` computes it (see ``ref.reciprocal_f32``)."""
    hits = (predict(params, x, cfg) == y).sum().to(torch.float32)
    return hits * torch.full_like(hits, ref.reciprocal_f32(y.shape[-1]))


def confidence_scores(params: TMParams, x_conf: torch.Tensor, cfg: TMConfig,
                      weighted: bool = False) -> torch.Tensor:
    """Alg. 1 step 6: conf[c] = Σ_x (Σ_j C⁺_j(x) − Σ_j C⁻_j(x)) → (C,)
    int32, from one ``clause_outputs`` launch in predict mode;
    ``weighted=True`` uses the Eq.-1 weighted margin."""
    cl = clause_outputs(params, literals(x_conf), cfg, predict=True)
    pol = clause_polarity(cfg, cl.device)
    wpol = pol * params.weights if weighted else pol
    return (cl * wpol).sum(-1, dtype=torch.int32).sum(0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Training.  The per-sample scan (weighted=False) runs all N clients of a
# round side by side, which is what the reference's vmap(train) computes.
# ---------------------------------------------------------------------------

def _train_one_sample(params: TMParams, lit: torch.Tensor,
                      cls2: torch.Tensor, role_keys: torch.Tensor,
                      cfg: TMConfig) -> None:
    """One sample step of every client, updating ``params.ta_state``
    (N, C, m, L) in place: lit (N, L), cls2 (N, 2) [target, negative],
    role_keys (N, 2, 3, 2) the step's slice of the epoch's chain.  The
    target class takes Type I feedback on its positive clauses and Type II
    on its negative ones, the negative class the mirror image; both use
    the clause outputs and votes from before either update, in one
    ``ta_update_`` launch.  Weights do not change: this path trains the
    unit-weight TM."""
    cl = clause_outputs(params, lit[:, None], cfg)           # (N, 1, C, m)
    votes = class_votes(params, cl, cfg)[:, 0]               # (N, C)
    p_inc, p_dec = _feedback_probs(cfg)
    ops.ta_update_(params.ta_state, lit, cl[:, 0], votes, cls2, role_keys,
                   T=cfg.T, p_inc=p_inc, p_dec=p_dec, n_states=cfg.n_states)


def _epoch(ta: torch.Tensor, w: torch.Tensor, xs: torch.Tensor,
           ys: torch.Tensor, key: torch.Tensor, cfg: TMConfig,
           epoch: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One local epoch of N stacked clients under epoch keys (N, 2), or
    under the clients' keys (N, 2) split into epochs at ``epoch``: one key
    chain (:func:`ops.key_chain`), then one fused-epoch launch, or the
    per-sample scan for the unit-weight TM."""
    obs = tracer.current()
    n_samples = ys.shape[1]
    # the literals go first, so their device copy overlaps the host's work
    # on the key chain
    with obs.span(tracer.TRAIN_EPOCH):
        lits = literals(xs).contiguous()                        # (N, S, L)
    with obs.span(tracer.KEY_CHAIN):
        cls2, role_keys = ops.key_chain(key, ys, cfg.n_classes, epoch)
    with obs.span(tracer.TRAIN_EPOCH):
        if not cfg.weighted:
            params = TMParams(ta.clone(), w)   # the scan updates this copy
            for s in range(n_samples):
                _train_one_sample(params, lits[:, s], cls2[:, s],
                                  role_keys[:, s], cfg)
            return params
        p_inc, p_dec = _feedback_probs(cfg)
        return ops.train_epoch_fused(ta, w, lits, cls2, role_keys,
                                     n_states=cfg.n_states, T=cfg.T,
                                     p_inc=p_inc, p_dec=p_dec)


def train_epoch(params: TMParams, xs: torch.Tensor, ys: torch.Tensor,
                key: torch.Tensor, cfg: TMConfig) -> TMParams:
    """One sample-sequential pass of one model over xs (S, o), ys (S,)."""
    ta, w = _epoch(params.ta_state[None], params.weights[None], xs[None],
                   ys[None], key[None], cfg)
    return TMParams(ta_state=ta[0], weights=w[0])


def train(params: TMParams, xs: torch.Tensor, ys: torch.Tensor,
          key: torch.Tensor, cfg: TMConfig, epochs: int = 1) -> TMParams:
    """``epochs`` local epochs of one model under ``split(key, epochs)``:
    :func:`train_batched` for one client."""
    p = train_batched(TMParams(params.ta_state[None], params.weights[None]),
                      xs[None], ys[None], key[None], cfg, epochs)
    return TMParams(ta_state=p.ta_state[0], weights=p.weights[0])


# ---------------------------------------------------------------------------
# Client-batched entry points (leading client axis N everywhere)
# ---------------------------------------------------------------------------

def train_batched(params: TMParams, xs: torch.Tensor, ys: torch.Tensor,
                  keys: torch.Tensor, cfg: TMConfig,
                  epochs: int = 1) -> TMParams:
    """params (N, ...); xs (N,S,o); ys (N,S); keys (N,2) → trained params.

    Per client ``split(key, epochs)`` gives the epoch keys, as
    ``vmap(train)`` does in the reference.  Each epoch's key chain
    (:func:`ops.key_chain`, one launch on the card) takes the clients'
    keys and the epoch index, splits out the epoch key and gives the role
    keys; the weighted TM runs one fused-epoch launch for all N clients,
    which draws the randomness from them; the unit-weight TM runs the
    per-sample scan from the same keys (see :func:`_train_one_sample`)."""
    ta, w = params.ta_state, params.weights
    for e in range(epochs):
        ta, w = _epoch(ta, w, xs, ys, keys, cfg, epoch=e)
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
    votes = ops.fused_votes_batched(include_mask(params, cfg), literals(x),
                                    _wpol(params, cfg), predict=True)
    return torch.argmax(votes.clamp(-cfg.T, cfg.T), dim=-1)


def accuracy_batched(params: TMParams, x: torch.Tensor, y: torch.Tensor,
                     cfg: TMConfig) -> torch.Tensor:
    """Stacked accuracy: params (N, ...), x (N,B,o), y (N,B) → (N,) f32:
    the exact hit count times f32(1/B), which is what the reference's
    ``jnp.mean`` computes once compiled (see ``ref.reciprocal_f32``)."""
    hits = (predict_batched(params, x, cfg) == y).sum(-1).to(torch.float32)
    return hits * torch.full_like(hits, ref.reciprocal_f32(y.shape[-1]))
