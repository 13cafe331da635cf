"""The one Pool → ClientData dispatch every entry point shares.

Counterpart of ``repro/data/ingest/natural.py``'s ``partition_pool``:
writer-tagged pools take the natural writer split, the rest the paper's
Dirichlet split (:func:`repro_torch.data.partition.dirichlet_clients`).
The writer split (``partition_writers``) is not ported yet (ROADMAP
A7); the registry makes no writer-tagged pool until it is.
"""
from __future__ import annotations

import torch

from repro_torch.data import partition as _partition


def partition_pool(pool, *, n_clients: int, n_train: int, n_test: int,
                   n_conf: int, key: torch.Tensor,
                   experiment: int = 5) -> _partition.ClientData:
    """``pool``'s clients, drawn from ``key`` on its device."""
    if pool.writers is not None:
        raise NotImplementedError(
            f"pool {pool.name!r} carries writer identities: the natural "
            f"writer split is not ported yet (ROADMAP.md queue A, item A7)")
    return _partition.dirichlet_clients(
        pool.x, pool.y, pool.n_classes, n_clients=n_clients,
        experiment=experiment, key=key, n_train=n_train, n_test=n_test,
        n_conf=n_conf)
