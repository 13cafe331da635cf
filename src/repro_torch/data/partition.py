"""Dirichlet client partitioning and the paper's five experiments.

Counterpart of ``repro/data/partition.py``.  Paper §6.3: α = 10000 makes
a client IID, α = 0.05 non-IID; experiment e ∈ {1..5} makes
``(e-1)·25 %`` of the clients non-IID (§6.1, Fig. 3).  Each client draws
a class mixture p_i ~ Dir(α) and then samples its local splits label
first from the global pool (Hsu et al., arXiv:1909.06335).  Fixed
per-client sample counts keep every split rectangular.

The draws use a seeded ``numpy.random.Generator`` and are not
bit-identical to the JAX package, which draws with
``jax.random.dirichlet`` and ``categorical``.  On the same pool (which
``synthetic.make_pool`` draws exactly as the reference does) the first
field that differs is ``mixtures``, the Dirichlet draw that every split
is drawn from (``tests/test_torch_data.py``); so tests that compare the
two packages build one ``ClientData`` and hand it to both.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as devices

IID_ALPHA = 10000.0
NONIID_ALPHA = 0.05


class ClientData(NamedTuple):
    """Rectangular per-client splits (leading axis = clients)."""

    x_train: torch.Tensor   # (n_clients, n_train, o) uint8 0/1
    y_train: torch.Tensor   # (n_clients, n_train) int32
    x_test: torch.Tensor    # (n_clients, n_test, o)
    y_test: torch.Tensor
    x_conf: torch.Tensor    # (n_clients, n_conf, o) — D_conf (Alg. 1)
    y_conf: torch.Tensor
    mixtures: torch.Tensor  # (n_clients, C) f32 class mixtures
    sizes: torch.Tensor | None = None   # (n_clients,) int32 pool shares


def client_mixtures(n_clients: int, n_classes: int, frac_noniid: float,
                    rng: np.random.Generator) -> np.ndarray:
    """The last ``round(frac·n)`` clients non-IID, the rest IID."""
    p_iid = rng.dirichlet(np.full(n_classes, IID_ALPHA), n_clients)
    p_non = rng.dirichlet(np.full(n_classes, NONIID_ALPHA), n_clients)
    n_noniid = int(round(frac_noniid * n_clients))
    is_non = np.arange(n_clients) >= n_clients - n_noniid
    mix = np.where(is_non[:, None], p_non, p_iid)
    mix = np.nan_to_num(mix)
    empty = mix.sum(-1) <= 0
    mix[empty] = 1.0
    return (mix / mix.sum(-1, keepdims=True)).astype(np.float32)


def partition(x: np.ndarray, y: np.ndarray, n_classes: int, *,
              n_clients: int, experiment: int, seed: int, n_train: int,
              n_test: int, n_conf: int, device=None) -> ClientData:
    """The paper's per-client train / test / confidence splits, as
    tensors on ``device`` (the GPU unless the caller names another);
    ``experiment`` ∈ {1..5}."""
    if not 1 <= experiment <= 5:
        raise ValueError("experiment must be in 1..5")
    device = devices.resolve(device)
    rng = np.random.default_rng(seed)
    mixtures = client_mixtures(n_clients, n_classes,
                               (experiment - 1) / 4.0, rng)
    props = rng.dirichlet(np.ones(n_clients))    # pool shares, α = 1
    sizes = np.maximum(np.floor(props * y.shape[0]), 1).astype(np.int32)
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    n_total = n_train + n_test + n_conf
    xs = np.empty((n_clients, n_total, x.shape[1]), np.uint8)
    ys = np.empty((n_clients, n_total), np.int32)
    for i in range(n_clients):
        present = np.array([len(ix) > 0 for ix in by_class])
        p = mixtures[i] * present
        labels = rng.choice(n_classes, size=n_total, p=p / p.sum())
        for k, c in enumerate(labels):
            xs[i, k] = x[rng.choice(by_class[c])]
        ys[i] = labels
    a, b = n_train, n_train + n_test

    def t(v):
        return torch.as_tensor(v, device=device)

    return ClientData(
        x_train=t(xs[:, :a]), y_train=t(ys[:, :a]),
        x_test=t(xs[:, a:b]), y_test=t(ys[:, a:b]),
        x_conf=t(xs[:, b:]), y_conf=t(ys[:, b:]),
        mixtures=t(mixtures), sizes=t(sizes))
