"""The federated round engine, sync path on one device.

Counterpart of ``repro/fl/runtime/engine.py`` for the configuration this
slice of the port supports: sync barrier, the dense float32 wire, the
resident client population and the in-process executor, under any
scheduler setting (partial participation; uniform, weighted or
round-robin sampling; dropout; stragglers).  :class:`RuntimeConfig`
therefore holds the number of rounds, the scheduler and the checkpoint
cadence; the reference's other runtime settings (async aggregation, the
shard-mapped backend, the mmap client store, transports, other codecs)
come with later slices (ROADMAP.md, queue A).

Round anatomy (``run_round``), as in the reference's staged sync path:

1. ``scheduler.sample``: K sampled ids, dropout survival, staleness; an
   upload arrives when its client survived and is on time (a missed
   sync barrier counts as a drop);
2. the sampled clients' state and data are gathered (not under uniform
   full participation, where the cohort is the population in order),
   with per-client keys ``split(round_key, N)[idx]``;
3. the strategy's ``fused_client_step`` on the cohort: local training
   (one fused-epoch kernel launch per local epoch), for TPFL confidence
   (one fused-votes launch) and the top-class pick;
4. the uplink: every upload of a surviving client (stragglers too) is
   encoded to a real float32 frame, metered (4-byte slot id + payload)
   and decoded;
5. the masked per-slot mean over the arrived uploads and the Alg. 2
   server update (empty slots keep their row);
6. the downlink: slot rows are encoded, metered and decoded, then
   applied to the arrived clients that shared them (Phase D); the
   others keep their state from before the round;
7. the cohort is scattered back and every client of the population is
   evaluated (one fused-votes launch).

The key chain matches the reference: ``k_init, k_rounds = split(key)``,
round r runs under ``fold_in(k_rounds, r)``.  With the same data and key
every report field and the final state are bit-identical to the JAX
engine, except ``mean_accuracy``, a float32 mean whose summation order
may differ in the last place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.data.partition import ClientData
from repro_torch.fl.runtime import checkpointing
from repro_torch.fl.runtime.codec import decode, encode
from repro_torch.fl.runtime.executors import InProcessExecutor, applied_slots
from repro_torch.fl.runtime.scheduler import (Participation, Scheduler,
                                              SchedulerConfig)
from repro_torch.fl.runtime.strategy import (ServerState,
                                             default_server_update)

_LATER = "ROADMAP.md, queue A"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    rounds: int = 10
    scheduler: SchedulerConfig = SchedulerConfig()
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0         # 0 = never


class EngineState(NamedTuple):
    round_idx: torch.Tensor     # () int32 — next round to run
    client_state: Any           # strategy state, leading axis = clients
    server: ServerState         # (n_slots, d) slot matrix


class RoundReport(NamedTuple):
    round_idx: int
    mean_accuracy: torch.Tensor
    per_client_accuracy: torch.Tensor   # (n,)
    assignment: torch.Tensor            # (n, j) int32, −1 = not applied
    cluster_counts: torch.Tensor        # (n_slots,) f32
    participation: Participation
    upload_bytes: int                   # Σ len(frame) actually sent up
    download_bytes_broadcast: int       # one frame per populated slot
    download_bytes_per_client: int      # Σ over receiving participants
    aggregated_uploads: int             # uploads folded into the server


class Engine:
    """Round orchestrator for one strategy over one client population."""

    def __init__(self, strategy, data: ClientData, cfg: RuntimeConfig):
        if not hasattr(strategy, "fused_client_step"):
            raise NotImplementedError(
                f"{type(strategy).__name__}: the port runs TPFL and FedTM "
                f"only; the other strategies come with a later slice "
                f"({_LATER})")
        self.strategy = strategy
        self.data = data
        self.cfg = cfg
        self.n = int(data.x_train.shape[0])
        self.device = data.x_train.device
        # weighted sampling weighs clients by the partitioner's pool
        # shares: clients holding more data are sampled more often
        self.scheduler = Scheduler(cfg.scheduler, self.n, data.sizes)
        self.executor = InProcessExecutor()

    def init(self, key: torch.Tensor) -> EngineState:
        cs, server = self.strategy.init(key.to(self.device), self.n)
        return EngineState(
            round_idx=torch.zeros((), dtype=torch.int32, device=self.device),
            client_state=cs, server=server)

    def run(self, key: torch.Tensor, state: EngineState | None = None,
            rounds: int | None = None
            ) -> tuple[EngineState, list[RoundReport]]:
        """Run ``cfg.rounds`` rounds (or ``rounds``), continuing from
        ``state`` if given.  With a checkpoint directory, the state after
        round r is saved when ``(r + 1) % checkpoint_every == 0``."""
        k_init, k_rounds = rnd.split(key.to(self.device)).unbind(0)
        if state is None:
            state = self.init(k_init)
        reports = []
        start = int(state.round_idx)
        n_rounds = self.cfg.rounds if rounds is None else rounds
        for r in range(start, start + n_rounds):
            state, rep = self.run_round(state, rnd.fold_in(k_rounds, r))
            reports.append(rep)
            every = self.cfg.checkpoint_every
            if self.cfg.checkpoint_dir and every and (r + 1) % every == 0:
                checkpointing.save(self.cfg.checkpoint_dir, state)
        return state, reports

    def run_round(self, state: EngineState, round_key: torch.Tensor
                  ) -> tuple[EngineState, RoundReport]:
        r = int(state.round_idx)
        part = self.scheduler.sample(r, round_key)
        arrive = part.active & (part.staleness == 0)
        keys = rnd.split(round_key, self.n)
        # the cohort is the population in order: nothing is gathered
        in_order = self.scheduler.full_in_order
        if in_order:
            sub_cs, sub_data = state.client_state, self.data
        else:
            idx = part.idx.long()
            keys = keys[idx]
            sub_cs = type(state.client_state)(
                *(a[idx] for a in state.client_state))
            sub_data = type(self.data)(
                *(None if a is None else a[idx] for a in self.data))
        new_sub, vecs, slots = self.executor.train(
            self.strategy, sub_cs, state.server.slots, sub_data, keys)
        dec, up_bytes = self._wire_uplink(vecs, slots, part.active)
        agg, counts = self.executor.masked_mean(self.strategy, dec, slots,
                                                arrive)
        server = default_server_update(state.server, agg, counts)
        applied = applied_slots(slots, counts, arrive)
        rx_server, down_bc, down_pc = self._wire_downlink(server.slots,
                                                          counts, applied)
        merged = self.executor.apply_merge(
            self.strategy, new_sub, applied, rx_server, sub_cs,
            None if self.scheduler.all_arrive else arrive)
        if in_order:
            cs, assignment = merged, applied
        else:
            cs = type(merged)(*(a.index_put((idx,), m) for a, m in
                                zip(state.client_state, merged)))
            assignment = torch.full((self.n, applied.shape[1]), -1,
                                    dtype=torch.int32, device=self.device
                                    ).index_put((idx,), applied)
        acc = self.executor.evaluate(self.strategy, cs, self.data.x_test,
                                     self.data.y_test)
        rep = RoundReport(
            round_idx=r, mean_accuracy=acc.mean(), per_client_accuracy=acc,
            assignment=assignment, cluster_counts=counts,
            participation=part, upload_bytes=up_bytes,
            download_bytes_broadcast=down_bc,
            download_bytes_per_client=down_pc,
            aggregated_uploads=int((slots[arrive] >= 0).sum()))
        new_state = EngineState(round_idx=state.round_idx + 1,
                                client_state=cs, server=server)
        return new_state, rep

    # -- the wire ----------------------------------------------------------

    def _wire_uplink(self, vecs, slots, active):
        """Encode every upload of a surviving client to a real frame,
        meter it (slot id <i4 + payload) and decode what the aggregator
        sees.  A straggler's frame was sent, so it is metered; a dropped
        client and slot −1 send none."""
        np_vecs = vecs.detach().cpu().numpy().astype(np.float32)
        np_slots = slots.cpu().numpy()
        np_active = active.cpu().numpy()
        dec = np.zeros_like(np_vecs)
        total = 0
        for c in range(np_vecs.shape[0]):
            if not np_active[c]:
                continue
            for j in range(np_vecs.shape[1]):
                if np_slots[c, j] < 0:
                    continue
                frame = encode(np_vecs[c, j])
                total += 4 + len(frame)
                dec[c, j] = decode(frame, np_vecs.shape[2])
        return torch.as_tensor(dec, device=vecs.device), total

    def _wire_downlink(self, server, counts, applied):
        """Encode, meter and decode every slot row; clients apply the
        decoded rows.  ``down_bc`` is one frame per populated slot,
        ``down_pc`` the frames receiving clients apply."""
        np_server = server.cpu().numpy()
        rx = np.zeros_like(np_server)
        frame_len = []
        for s in range(np_server.shape[0]):
            frame = encode(np_server[s])
            frame_len.append(len(frame))
            rx[s] = decode(frame, np_server.shape[1])
        np_counts = counts.cpu().numpy()
        down_bc = sum(n for n, c in zip(frame_len, np_counts) if c > 0)
        down_pc = sum(frame_len[s] for s in applied.cpu().numpy().ravel()
                      if s >= 0)
        return torch.as_tensor(rx, device=server.device), down_bc, down_pc
