"""The one-hidden-layer MLP of the DL baselines (FedAvg, FedProx, IFCA,
FLIS) and of TPFL-for-NN.

Counterpart of ``repro/core/mlp.py``.  ``Params`` is a dict ``{w1, b1,
w2, b2}``, so checkpoints carry the reference's leaf keys.  Every
function takes parameters with any leading axes (a stacked client
cohort, IFCA's slot models) that broadcast against the data's: the
reference vmaps one client at a time, the port runs the whole cohort
as one batched product (``torch.matmul`` on 3-D and higher operands is
``torch.bmm``).

:func:`init` draws the reference's bits.  The rest is float math, held
to the reference within a stated tolerance (tests/test_torch_mlp.py).
Products run in full float32 (:func:`full_fp32`): TF32 would move the
results by about 1e-3, not 1e-8.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch import random as rnd
from repro_torch.kernels.ref import reciprocal_f32

Params = dict[str, torch.Tensor]


@contextlib.contextmanager
def full_fp32():
    """Float32 matmuls at full precision (no TF32) inside the block; the
    caller's setting comes back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _fp32(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_fp32():
            return fn(*args, **kwargs)
    return wrapper


def init(key: torch.Tensor, n_features: int, n_hidden: int,
         n_classes: int) -> Params:
    """He-normal weights and zero biases; keys (..., 2) give parameters
    with the keys' leading axes, each the reference's ``init`` of its
    key."""
    ks = rnd.split(key)
    lead = tuple(key.shape[:-1])
    s1 = (2.0 / n_features) ** 0.5
    s2 = (2.0 / n_hidden) ** 0.5
    f32 = dict(dtype=torch.float32, device=key.device)
    return {
        "w1": rnd.normal(ks[..., 0, :], (n_features, n_hidden)) * s1,
        "b1": torch.zeros(lead + (n_hidden,), **f32),
        "w2": rnd.normal(ks[..., 1, :], (n_hidden, n_classes)) * s2,
        "b2": torch.zeros(lead + (n_classes,), **f32),
    }


@_fp32
def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits (..., B, C) of samples x (..., B, F)."""
    h = torch.relu(torch.matmul(x.to(torch.float32), params["w1"])
                   + params["b1"][..., None, :])
    return torch.matmul(h, params["w2"]) + params["b2"][..., None, :]


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor,
            prox_mu: float = 0.0, prox_ref: Params | None = None
            ) -> torch.Tensor:
    """Mean cross-entropy over the samples, one loss per leading index;
    with ``prox_ref``, FedProx's ``(µ/2)·Σ‖θ − θ_ref‖²`` added."""
    logits = apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    idx = y.long().expand(logits.shape[:-1])[..., None]
    ce = -logp.gather(-1, idx)[..., 0].mean(-1)
    if prox_ref is not None:
        lead = logits.ndim - 2
        sq = sum((params[k] - prox_ref[k]).pow(2).flatten(lead).sum(-1)
                 for k in params)
        ce = ce + 0.5 * prox_mu * sq
    return ce


def n_bytes(params: Params) -> int:
    """float32 bytes of one model (no leading axes)."""
    return sum(int(v.numel()) * 4 for v in params.values())


@_fp32
def local_train(params: Params, x: torch.Tensor, y: torch.Tensor,
                keys: torch.Tensor, *, epochs: int, batch: int, lr: float,
                prox_mu: float = 0.0, prox_ref: Params | None = None
                ) -> Params:
    """Minibatch SGD over ``epochs`` passes for a stacked cohort: params
    (N, ...), x (N, n, F), y (N, n), keys (N, 2).  Client i draws the
    reference's ``split(keys[i], epochs)`` and, each epoch, its
    ``permutation(k, n)``; its minibatches are ``x[perm][:steps*batch]``.
    One autograd graph covers the cohort: the gradient of the sum of the
    clients' mean losses holds each client's own gradient in its block."""
    n = x.shape[1]
    steps = max(n // batch, 1)
    if steps * batch > n:
        raise ValueError(f"local_train: {n} samples a client do not fill "
                         f"a batch of {batch}")
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    ekeys = rnd.split(keys, epochs)                          # (N, E, 2)
    p = {k: v.detach() for k, v in params.items()}
    ref = (None if prox_ref is None
           else {k: v.detach() for k, v in prox_ref.items()})
    for e in range(epochs):
        perm = rnd.permutation(ekeys[:, e], n).long()[:, :steps * batch]
        xb = x[rows, perm].reshape(x.shape[0], steps, batch, -1)
        yb = y[rows, perm].reshape(x.shape[0], steps, batch)
        for s in range(steps):
            with torch.enable_grad():
                leaf = {k: v.requires_grad_() for k, v in p.items()}
                loss = loss_fn(leaf, xb[:, s], yb[:, s], prox_mu, ref).sum()
                grads = torch.autograd.grad(loss, list(leaf.values()))
            p = {k: (v - lr * g).detach()
                 for (k, v), g in zip(leaf.items(), grads)}
    return p


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Share of samples whose logit argmax is the label, one per leading
    index; ``count · f32(1/B)``, as compiled ``jnp.mean`` computes it."""
    hits = (apply(params, x).argmax(-1) == y).sum(-1).to(torch.float32)
    return hits * reciprocal_f32(y.shape[-1])


def stack(params: Params, n: int) -> Params:
    """``n`` copies of one model along a new leading axis."""
    return {k: v.expand((n,) + v.shape).clone() for k, v in params.items()}


def tree_mean(stacked: Params) -> Params:
    """Average a client-stacked model along axis 0 (FedAvg)."""
    return {k: v.mean(dim=0) for k, v in stacked.items()}
