"""Streaming per-client data over LEAF shards: ingestion's side of the
K-active working set.

Counterpart of ``repro/fl/store/streaming.py``.  ``registry.load``
materializes the whole encoded pool before partitioning, so the
population is capped by pool memory.  :class:`StreamingClientData` holds
only the writer table (names and per-writer sample counts from the shard
index, :func:`repro_torch.data.ingest.registry.load_stream`) and builds
rectangular :class:`~repro_torch.data.partition.ClientData` blocks on
demand for the ids the scheduler sampled: ``gather_clients(ids)`` parses
only the shards those clients' writers live in
(:func:`repro_torch.data.ingest.leaf.read_writers`), never the pool.

For ``n_clients ≤ n_writers`` the gathered rows are bit for bit the rows
:func:`repro_torch.data.ingest.natural.partition_writers` draws from the
materialized pool: the same contiguous writer groups
(``np.array_split``), the same per-client key chain
(``fold_in(fold_in(key, 0xFE31), i)``), the same eval-first subsample and
wraparound, and the encoding applied per gathered row (booleanize and
thermometer are elementwise; ``quantile`` needs the pool and is refused
by ``load_stream``).  Beyond the writer count clients map cyclically
onto writers (client ``i`` → writer ``i % W``), which has no
materialized counterpart.

``sizes`` is the host-resident per-client size table (int64, 8 bytes a
client, the only O(N) state); it drives ``weighted`` sampling.  The
blocks land on ``device``, the GPU unless the caller names another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.data.ingest import leaf, natural
from repro_torch.data.partition import ClientData


class StreamingClientData:
    """Writer-table view of a LEAF dataset; per-cohort gather on demand.

    ``pool`` is a :class:`repro_torch.data.ingest.registry.StreamPool`.
    The constructor touches no shard payloads, only the index's writer
    table."""

    def __init__(self, pool, *, n_clients: int, n_train: int, n_test: int,
                 n_conf: int, key: torch.Tensor, device=None):
        self.pool = pool
        self.n_clients = int(n_clients)
        self.n_train, self.n_test, self.n_conf = n_train, n_test, n_conf
        self.device = devices.resolve(device)
        self._key = key
        w_sizes = np.asarray(pool.writer_sizes, np.int64)
        self._n_writers = w_sizes.size
        if self._n_writers == 0:
            raise ValueError(f"stream pool {pool.name!r} has no writers")
        # cum[w] = global row offset of writer w in the (virtual) pool:
        # the pool concatenates writers in index order
        self._cum = np.concatenate([[0], np.cumsum(w_sizes)])
        if self.n_clients <= self._n_writers:
            # the materialized partitioner's contiguous writer blocks
            groups = np.array_split(np.arange(self._n_writers),
                                    self.n_clients)
            self._g_start = np.asarray([g[0] for g in groups], np.int64)
            self._g_stop = np.asarray([g[-1] + 1 for g in groups], np.int64)
            sizes = self._cum[self._g_stop] - self._cum[self._g_start]
        else:
            # simulated scale: cyclic writer reuse
            self._g_start = self._g_stop = None
            sizes = w_sizes[np.arange(self.n_clients) % self._n_writers]
        self.sizes = sizes.astype(np.int64)

    def _writers_of(self, i: int) -> range:
        if self._g_start is not None:
            return range(int(self._g_start[i]), int(self._g_stop[i]))
        w = i % self._n_writers
        return range(w, w + 1)

    def gather_clients(self, ids) -> ClientData:
        """Rectangular :class:`ClientData` for ``ids`` on ``device``: the
        cohort block the engine trains on; only these clients' shards
        are parsed."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_clients):
            raise ValueError(
                f"client ids out of range [0, {self.n_clients})")
        wids = sorted({w for i in ids for w in self._writers_of(int(i))})
        data = leaf.read_writers(self.pool.root, wids,
                                 verify=self.pool.verify)
        k_budget = rnd.fold_in(self._key, natural._TAG_BUDGET)
        eval_need = self.n_test + self.n_conf
        xs, ys, sizes, mixtures = [], [], [], []
        for i in ids:
            i = int(i)
            ws = self._writers_of(i)
            start, stop = int(self._cum[ws.start]), int(self._cum[ws.stop])
            rows = np.arange(start, stop, dtype=np.int64)
            y_all = np.concatenate([data[w][1] for w in ws])
            counts = np.bincount(y_all, minlength=self.pool.n_classes)
            mixtures.append(counts / counts.sum())
            sizes.append(len(rows))
            # partition_writers' budget draw: the same key chain,
            # permutation, eval-first split and wraparound
            order = rows[rnd.permutation(rnd.fold_in(k_budget, i),
                                         len(rows)).cpu().numpy()]
            if len(order) > eval_need:
                eval_pool, train_pool = order[:eval_need], order[eval_need:]
            elif len(order) > 1:
                eval_pool, train_pool = order[:-1], order[-1:]
            else:
                eval_pool = train_pool = order
            picked = np.concatenate([
                train_pool[np.arange(self.n_train) % len(train_pool)],
                eval_pool[np.arange(self.n_test) % len(eval_pool)],
                eval_pool[(self.n_test + np.arange(self.n_conf))
                          % len(eval_pool)]])
            # global row → (writer, local row) through the offset table
            w_of = np.searchsorted(self._cum, picked, side="right") - 1
            local = picked - self._cum[w_of]
            xs.append(np.stack([data[int(w)][0][int(li)]
                                for w, li in zip(w_of, local)]))
            ys.append(np.asarray([data[int(w)][1][int(li)]
                                  for w, li in zip(w_of, local)],
                                 np.int32))
        dev = self.device
        unit = torch.as_tensor(np.stack(xs), dtype=torch.float32,
                               device=dev)                   # (k, B, F) raw
        bits = self.pool.encoder(unit.reshape(-1, unit.shape[-1])).reshape(
            unit.shape[0], unit.shape[1], -1)
        ys = torch.as_tensor(np.stack(ys), device=dev)
        a, b = self.n_train, self.n_train + self.n_test
        return ClientData(
            x_train=bits[:, :a].contiguous(), y_train=ys[:, :a].contiguous(),
            x_test=bits[:, a:b].contiguous(), y_test=ys[:, a:b].contiguous(),
            x_conf=bits[:, b:].contiguous(), y_conf=ys[:, b:].contiguous(),
            mixtures=torch.as_tensor(
                np.stack(mixtures).astype(np.float32), device=dev),
            sizes=torch.as_tensor(np.asarray(sizes).astype(np.int32),
                                  device=dev),
        )
