"""Natural (writer-identity) partitioning for LEAF-style pools.

Counterpart of ``repro/data/ingest/natural.py``, bit for bit.
FEMNIST's canonical non-IID split assigns each *writer* to a client:
the heterogeneity is real handwriting style and genuinely unequal sample
counts, not a simulated Dirichlet draw.  :func:`partition_writers` maps
a writer-tagged :class:`~repro_torch.data.ingest.registry.Pool` onto the
rectangular :class:`~repro_torch.data.partition.ClientData`:

* writers are grouped onto ``n_clients`` clients in contiguous
  writer-id blocks (``np.array_split``);
* the per-client budget (``n_train + n_test + n_conf`` rows) is met by
  subsampling a client's rows in the order of one
  ``permutation(fold_in(fold_in(key, 0xFE31), i), n)`` per client, and
  by wraparound padding when it holds fewer, with the held-out rows
  (test + conf) taken *before* the training rows, so a padded client
  never evaluates on samples it trained on;
* ``sizes`` records each client's real pre-budget sample count, which
  drives the scheduler's ``weighted`` sampling;
* ``mixtures`` is the client's label histogram over its full writer
  data (float64 in numpy, float32 at the end).

:func:`partition_pool` is the one Pool → ClientData dispatch every entry
point shares: writer-tagged pools take the writer split, the rest the
paper's Dirichlet split (:func:`repro_torch.data.partition.dirichlet_clients`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.data import partition as _partition
from repro_torch.data.partition import ClientData

# fold_in tag for the per-client budget draw: disjoint from every other
# stream, so adding clients never perturbs earlier ones
_TAG_BUDGET = 0xFE31


def partition_pool(pool, *, n_clients: int, n_train: int, n_test: int,
                   n_conf: int, key: torch.Tensor,
                   experiment: int = 5) -> ClientData:
    """``pool``'s clients, drawn from ``key`` on its device: the writer
    split for a writer-tagged pool (``experiment`` does not apply), the
    Dirichlet split otherwise."""
    if pool.writers is not None:
        return partition_writers(pool, n_clients=n_clients,
                                 n_train=n_train, n_test=n_test,
                                 n_conf=n_conf, key=key)
    return _partition.dirichlet_clients(
        pool.x, pool.y, pool.n_classes, n_clients=n_clients,
        experiment=experiment, key=key, n_train=n_train, n_test=n_test,
        n_conf=n_conf)


def partition_writers(pool, *, n_clients: int, n_train: int, n_test: int,
                      n_conf: int, key: torch.Tensor) -> ClientData:
    """Writer-natural :class:`ClientData` from a writer-tagged pool, on
    ``key``'s device."""
    if pool.writers is None:
        raise ValueError(
            f"pool {pool.name!r} carries no writer identities — use the "
            f"Dirichlet partitioner (repro_torch.data.partition) instead")
    writers = pool.writers.cpu().numpy()
    writer_ids = np.unique(writers)
    if len(writer_ids) < n_clients:
        raise ValueError(
            f"{len(writer_ids)} writers cannot fill {n_clients} clients; "
            f"lower --clients, or — for a mirror-written cache — clear "
            f"the dataset's cache directory and rerun with --writers ≥ "
            f"the client count so the mirror regenerates larger")
    y = pool.y.cpu().numpy()
    groups = np.array_split(writer_ids, n_clients)
    k_budget = rnd.fold_in(key, _TAG_BUDGET)

    eval_need = n_test + n_conf
    picks, sizes, mixtures = [], [], []
    for i, group in enumerate(groups):
        rows = np.nonzero(np.isin(writers, group))[0]
        sizes.append(len(rows))
        counts = np.bincount(y[rows], minlength=pool.n_classes)
        mixtures.append(counts / counts.sum())
        order = rows[rnd.permutation(rnd.fold_in(k_budget, i),
                                     len(rows)).cpu().numpy()]
        # held-out rows first: padding must never leak a training row
        # into test/conf (but for the single-sample client, which has
        # no choice)
        if len(order) > eval_need:
            eval_pool, train_pool = order[:eval_need], order[eval_need:]
        elif len(order) > 1:
            eval_pool, train_pool = order[:-1], order[-1:]
        else:
            eval_pool = train_pool = order
        picks.append(np.concatenate([
            train_pool[np.arange(n_train) % len(train_pool)],
            eval_pool[np.arange(n_test) % len(eval_pool)],
            eval_pool[(n_test + np.arange(n_conf)) % len(eval_pool)]]))

    dev = key.device
    picked = torch.from_numpy(np.stack(picks)).to(dev)
    xs = pool.x.to(dev)[picked]
    ys = pool.y.to(dev)[picked].to(torch.int32)
    a, b = n_train, n_train + n_test
    return ClientData(
        x_train=xs[:, :a].contiguous(), y_train=ys[:, :a].contiguous(),
        x_test=xs[:, a:b].contiguous(), y_test=ys[:, a:b].contiguous(),
        x_conf=xs[:, b:].contiguous(), y_conf=ys[:, b:].contiguous(),
        mixtures=torch.from_numpy(
            np.stack(mixtures).astype(np.float32)).to(dev),
        sizes=torch.from_numpy(
            np.asarray(sizes).astype(np.int32)).to(dev),
    )
