"""Dirichlet client partitioning and the paper's five experiments.

Counterpart of ``repro/data/partition.py``, bit for bit.  Paper §6.3:
α = 10000 makes a client IID, α = 0.05 non-IID; experiment e ∈ {1..5}
makes ``(e-1)·25 %`` of the clients non-IID (§6.1, Fig. 3).  Each client
draws a class mixture p_i ~ Dir(α) and then samples its local splits
label first from the global pool (Hsu et al., arXiv:1909.06335): a label
from ``categorical(log(p_i + 1e-9))``, then the pool row that maximizes
``log(match + 1e-30) + gumbel``.  Fixed per-client sample counts keep
every split rectangular; ``sizes`` is each client's Dirichlet share of
the pool (α = 1 by default), which drives ``weighted`` sampling.

Every draw is :mod:`repro_torch.random`'s, on the device that holds
``key``.  The row pick hashes only the Gumbel noise of the rows that
hold the drawn label: ``log(1e-30) + gumbel ≤ -69.08 + 16.64`` while a
matching row scores ``gumbel ≥ -4.47``, so no other row can win unless
the label has no row in the pool, and then the whole row is drawn.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import xla_f32

IID_ALPHA = 10000.0
NONIID_ALPHA = 0.05
# fold_in tag for the size allocation: a stream disjoint from the
# mixture and draw keys
_TAG_SIZES = 0x517E5


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


def sha256(data) -> str:
    """sha256 of a ClientData, field by field in order: the name, numpy
    dtype, shape and little-endian bytes of each (tensors or arrays, so
    the reference's ClientData hashes the same way)."""
    h = hashlib.sha256()
    for name, a in zip(data._fields, data):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def client_mixtures(n_clients: int, n_classes: int, frac_noniid: float,
                    key: torch.Tensor) -> torch.Tensor:
    """The last ``round(frac·n)`` clients non-IID, the rest IID."""
    k_iid, k_non = rnd.split(key).unbind(0)
    p_iid = rnd.dirichlet(k_iid, _f32(IID_ALPHA, key).expand(n_classes),
                          (n_clients,))
    p_non = rnd.dirichlet(k_non, _f32(NONIID_ALPHA, key).expand(n_classes),
                          (n_clients,))
    n_noniid = int(round(frac_noniid * n_clients))
    is_non = torch.arange(n_clients, device=key.device) \
        >= n_clients - n_noniid
    return torch.where(is_non[:, None], p_non, p_iid)


def _pick_rows(y: torch.Tensor, labels: torch.Tensor, keys: torch.Tensor
               ) -> torch.Tensor:
    """Per (client, draw), ``argmax(log(match + 1e-30) + gumbel(key,
    (n, N)))`` over the pool's N rows, ties to the lower row."""
    n_pool = y.shape[0]
    unmatched = xla_f32.log(_f32(1e-30, y))
    idx = torch.empty(labels.shape, dtype=torch.int64, device=y.device)
    for c in torch.unique(labels).tolist():
        client, draw = (labels == c).nonzero(as_tuple=True)
        rows = (y == c).nonzero()[:, 0]
        empty = rows.numel() == 0
        if empty:                         # no row holds the label
            rows = torch.arange(n_pool, device=y.device)
        g = rnd.gumbel_at(keys[client], draw[:, None] * n_pool + rows)
        if empty:
            g = unmatched + g
        idx[client, draw] = rows[torch.argmax(g, dim=-1)]
    return idx


def _draw_clients(x: torch.Tensor, y: torch.Tensor, mixtures: torch.Tensor,
                  n: int, keys: torch.Tensor):
    """Each client's n (x, y) pairs, label first, from its key."""
    k_lab, k_pick = rnd.split(keys).unbind(-2)
    logits = xla_f32.log(mixtures + _f32(1e-9, mixtures))
    labels = rnd.categorical(k_lab, logits, (n,))
    return x[_pick_rows(y, labels, k_pick)], labels


def client_sizes(n_clients: int, pool: int, key: torch.Tensor,
                 size_alpha: float = 1.0) -> torch.Tensor:
    """Dirichlet allocation of the global pool across clients; every
    client keeps at least one sample."""
    props = rnd.dirichlet(key, _f32(size_alpha, key).expand(n_clients))
    return torch.clamp_min(torch.floor(props * _f32(pool, key)), 1.0
                           ).to(torch.int32)


def partition(x, y, n_classes: int, *, n_clients: int, experiment: int,
              key: torch.Tensor, n_train: int, n_test: int, n_conf: int,
              size_alpha: float = 1.0) -> ClientData:
    """The paper's per-client train / test / confidence splits, drawn
    from ``key`` on its device (``x``, ``y`` are moved there);
    ``experiment`` ∈ {1..5}."""
    if not 1 <= experiment <= 5:
        raise ValueError("experiment must be in 1..5")
    x = torch.as_tensor(x, device=key.device)
    y = torch.as_tensor(y, device=key.device)
    frac = (experiment - 1) / 4.0
    k_mix, k_draw = rnd.split(key).unbind(0)
    mixtures = client_mixtures(n_clients, n_classes, frac, k_mix)
    sizes = client_sizes(n_clients, int(y.shape[0]),
                         rnd.fold_in(key, _TAG_SIZES), size_alpha)
    a, b = n_train, n_train + n_test
    xs, ys = _draw_clients(x, y, mixtures, b + n_conf,
                           rnd.split(k_draw, n_clients))
    splits = [t[:, s].contiguous() for s in (slice(a), slice(a, b),
                                              slice(b, None))
              for t in (xs, ys)]
    return ClientData(*splits, mixtures=mixtures, sizes=sizes)


# registry-facing name: the simulated split (the writer-identity split
# is ROADMAP A7)
dirichlet_clients = partition
