"""The federated round engine, sync path on one device.

Counterpart of ``repro/fl/runtime/engine.py`` for the configuration this
slice of the port supports: sync barrier, every strategy of the
reference (TPFL, FedTM, FedAvg / FedProx, IFCA, FLIS-DC / HC) with its
server-side ``assign`` and ``server_update`` hooks, every wire codec
(float32, int8, int4; sparse delta with ``<u2`` or varint+RLE indices;
error feedback), the resident client population and the in-process
executor, under any scheduler setting (partial participation; uniform,
weighted or round-robin sampling; dropout; stragglers).
:class:`RuntimeConfig` therefore holds the number of rounds, the
scheduler, the codec and the checkpoint cadence; the reference's other
runtime settings (async aggregation, the shard-mapped backend, the mmap
client store, transports) come with later slices (ROADMAP.md, queue A)
and are refused, as unknown fields.

Round anatomy (``run_round``), as in the reference's staged sync path,
each stage in a telemetry span of the reference's name:

1. ``schedule``: K sampled ids, dropout survival, staleness; an upload
   arrives when its client survived and is on time (a missed sync
   barrier counts as a drop);
2. ``gather``: the sampled clients' state and data (not under uniform
   full participation, where the cohort is the population in order),
   with per-client keys ``split(round_key, N)[idx]``;
3. ``broadcast_encode``: the server rows as clients hold them, each
   roundtripped through the dense codec (the identity on float32;
   computed once per server matrix, cached from the last downlink);
4. ``client_step``: the strategy's ``fused_client_step`` on the cohort
   from those rows: local training (for the TM one fused-epoch launch
   per local epoch; for the MLP one batched autograd step a minibatch),
   for TPFL confidence (one fused-votes launch) and the top-class pick,
   for IFCA the loss of every slot model;
5. ``uplink_codec``: every upload of a surviving client (stragglers
   too) is encoded to a real frame, metered (4-byte slot id + frame)
   and decoded on the host; sparse deltas run against the client's
   tracked broadcast reference, error feedback adds and advances its
   residual.  Only the K sampled reference and residual rows leave the
   device.  The float32 dense wire is the identity: metered
   arithmetically, nothing leaves the device;
6. ``assign`` (strategies with the hook, FLIS): every upload's slot is
   recomputed from the decoded uploads.  Metering and the sparse
   references above used the tags that crossed the wire, never these;
7. ``aggregate``, ``server_update``: the masked per-slot mean over the
   arrived uploads, summed in row order, folded into the server state
   by the strategy's hook (default: Alg. 2, empty slots keep their row);
8. ``downlink``: slot rows are encoded, metered and decoded;
   ``apply_merge``: the arrived clients that shared a slot apply its
   decoded row (Phase D), the others keep their state from before the
   round; ``ref_track``: the arrived clients' references advance to the
   rows they applied;
9. ``eval``: the cohort is scattered back and every client of the
   population is evaluated (one fused-votes launch for the TM).

The key chain matches the reference: ``k_init, k_rounds = split(key)``,
round r runs under ``fold_in(k_rounds, r)``.  With the same data and key
every report field and the final state (client state, server rows,
``ref_vecs`` / ``ref_round`` / ``ef_residual``) of the TM strategies are
bit-identical to the JAX engine, except ``mean_accuracy``, a float32
mean whose summation order may differ in the last place, and a lossy
aggregate where XLA's dot does not add in row order
(``core/clustering.py``).  The MLP strategies are float math, held to
the reference within a stated tolerance (tests/test_torch_baselines.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.data.partition import ClientData
from repro_torch.fl.obs.recorder import NULL as NULL_TELEMETRY
from repro_torch.fl.runtime import checkpointing
from repro_torch.fl.runtime.codec import CodecConfig, decode, ef_encode, encode
from repro_torch.fl.runtime.executors import InProcessExecutor, applied_slots
from repro_torch.fl.runtime.scheduler import (Participation, Scheduler,
                                              SchedulerConfig)
from repro_torch.fl.runtime.strategy import (DOWNLOADS, ServerState,
                                             resolve_server_update)

# the cohort hooks the engine calls on every strategy
_HOOKS = ("init", "fused_client_step", "apply_broadcast", "fused_evaluate")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    rounds: int = 10
    scheduler: SchedulerConfig = SchedulerConfig()
    codec: CodecConfig = CodecConfig()
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0         # 0 = never


class EngineState(NamedTuple):
    round_idx: torch.Tensor     # () int32 — next round to run
    client_state: Any           # strategy state, leading axis = clients
    server: ServerState         # slot matrix + the strategy's aux
    # per-client broadcast references of the sparse-delta wire: the
    # server rows each client last received (zeros = never synced) and
    # the round it received them (−1 = never); zero-size when dense
    ref_vecs: torch.Tensor      # (n, n_slots, d) float32, or (0, 0, 0)
    ref_round: torch.Tensor     # (n,) int32, or (0,)
    # error-feedback residuals: the quantization error each client's
    # last frame for each slot left behind; zero-size when EF is off
    ef_residual: torch.Tensor   # (n, n_slots, d) float32, or (0, 0, 0)


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

    def __init__(self, strategy, data: ClientData, cfg: RuntimeConfig,
                 telemetry=None):
        missing = [h for h in _HOOKS if not hasattr(strategy, h)]
        if missing:
            raise TypeError(
                f"{type(strategy).__name__} lacks the cohort hook(s) "
                f"{', '.join(missing)} that the engine calls on every "
                f"strategy (each written for the whole stacked cohort)")
        downloads = getattr(strategy, "downloads", None)
        if downloads not in DOWNLOADS:
            raise ValueError(
                f"strategy.downloads must be one of {DOWNLOADS}, got "
                f"{downloads!r} — 'assigned' broadcasts each client its "
                f"own slot row, 'all_slots' the whole matrix (IFCA)")
        self.strategy = strategy
        self._downloads = downloads
        # the optional server-side hooks: assign (absent = the proposed
        # slots stand) and server_update (absent = Alg. 2 retention)
        self._assign = getattr(strategy, "assign", None)
        self._server_update = resolve_server_update(strategy)
        self.data = data
        self.cfg = cfg
        self.n = int(data.x_train.shape[0])
        self.device = data.x_train.device
        # weighted sampling weighs clients by the partitioner's pool
        # shares: clients holding more data are sampled more often
        self.scheduler = Scheduler(cfg.scheduler, self.n, data.sizes)
        self.executor = InProcessExecutor()
        # spans, fences and the per-round event sink; read-only, so
        # telemetry on and off give the same bits
        self.obs = telemetry if telemetry is not None else NULL_TELEMETRY
        # (server, roundtripped rows) of the latest broadcast, reused by
        # _wire_tx_server so a lossy codec roundtrips each server once
        self._tx_cache = None

    def init(self, key: torch.Tensor) -> EngineState:
        # FLIS draws its probe set from the clients' confidence split
        cs, server = self.strategy.init(key.to(self.device), self.n,
                                        self.data)
        shape = (self.n, self.strategy.n_slots, self.strategy.vec_dim)
        f32 = dict(dtype=torch.float32, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        codec = self.cfg.codec
        return EngineState(
            round_idx=torch.zeros((), **i32), client_state=cs, server=server,
            ref_vecs=torch.zeros(shape if codec.sparse else (0, 0, 0), **f32),
            ref_round=(torch.full((self.n,), -1, **i32) if codec.sparse
                       else torch.zeros((0,), **i32)),
            ef_residual=torch.zeros(
                shape if codec.error_feedback else (0, 0, 0), **f32))

    def run(self, key: torch.Tensor, state: EngineState | None = None,
            rounds: int | None = None
            ) -> tuple[EngineState, list[RoundReport]]:
        """Run ``cfg.rounds`` rounds (or ``rounds``), continuing from
        ``state`` if given.  With a checkpoint directory, the state after
        round r is saved when ``(r + 1) % checkpoint_every == 0``, with
        the telemetry manifest beside it when there is one."""
        k_init, k_rounds = rnd.split(key.to(self.device)).unbind(0)
        if state is None:
            state = self.init(k_init)
        reports = []
        start = int(state.round_idx)
        n_rounds = self.cfg.rounds if rounds is None else rounds
        for r in range(start, start + n_rounds):
            with self.obs.span("round"):
                state, rep = self.run_round(state, rnd.fold_in(k_rounds, r))
                self.obs.fence(state)
            self.obs.on_round(rep)
            reports.append(rep)
            every = self.cfg.checkpoint_every
            if self.cfg.checkpoint_dir and every and (r + 1) % every == 0:
                checkpointing.save(self.cfg.checkpoint_dir, state,
                                   manifest=self.obs.manifest)
        return state, reports

    def run_round(self, state: EngineState, round_key: torch.Tensor
                  ) -> tuple[EngineState, RoundReport]:
        obs = self.obs            # telemetry spans/fences — no-ops when off
        r = int(state.round_idx)
        with obs.span("schedule"):
            part = self.scheduler.sample(r, round_key)
            arrive = part.active & (part.staleness == 0)
        # the cohort is the population in order: nothing is gathered
        in_order = self.scheduler.full_in_order
        with obs.span("gather"):
            keys = rnd.split(round_key, self.n)
            if in_order:
                sub_cs, sub_data = state.client_state, self.data
            else:
                idx = part.idx.long()
                keys = keys[idx]
                sub_cs = tree.map(lambda a: a[idx], state.client_state)
                sub_data = tree.map(lambda a: a[idx], self.data)
            obs.fence(keys)
        # local work starts from the rows a client holds after the
        # (possibly lossy) broadcast, not the server's own precision
        with obs.span("broadcast_encode"):
            tx_server = self._wire_tx_server(state.server.slots)
            obs.fence(tx_server)
        with obs.span("client_step"):
            new_sub, vecs, slots = self.executor.train(
                self.strategy, sub_cs, tx_server, sub_data, keys)
            obs.fence(new_sub, vecs, slots)
        with obs.span("uplink_codec"):
            dec, up_bytes, ef = self._wire_uplink(state, vecs, slots, part)
            obs.fence(dec)
        if self._assign is not None:
            # metering and the sparse references used the tags that
            # crossed the wire; aggregation and the broadcast use these
            with obs.span("assign"):
                slots = self.executor.assign(self.strategy, state.server,
                                             dec, slots, arrive)
                obs.fence(slots)
        with obs.span("aggregate"):
            agg, counts = self.executor.masked_mean(self.strategy, dec,
                                                    slots, arrive)
            obs.fence(agg, counts)
        with obs.span("server_update"):
            server = self._server_update(state.server, agg, counts)
            obs.fence(server)
        with obs.span("downlink"):
            applied = applied_slots(slots, counts, arrive)
            rx_server, down_bc, down_pc = self._wire_downlink(
                server.slots, counts, arrive, applied)
            obs.fence(rx_server)
        with obs.span("apply_merge"):
            merged = self.executor.apply_merge(
                self.strategy, new_sub, applied, rx_server, sub_cs,
                None if self.scheduler.all_arrive else arrive)
            obs.fence(merged)
        with obs.span("ref_track"):
            refs = self._update_refs(state, part, arrive, applied,
                                     rx_server, r)
            obs.fence(refs)
        n_agg = int((slots[arrive] >= 0).sum())
        with obs.span("eval"):
            if in_order:
                cs, assignment = merged, applied
            else:
                cs = tree.map(lambda a, m: a.index_put((idx,), m),
                              state.client_state, merged)
                assignment = torch.full(
                    (self.n, applied.shape[1]), -1, dtype=torch.int32,
                    device=self.device).index_put((idx,), applied)
            acc = self.executor.evaluate(self.strategy, cs,
                                         self.data.x_test, self.data.y_test)
            obs.fence(acc)
        rep = RoundReport(
            round_idx=r, mean_accuracy=acc.mean(), per_client_accuracy=acc,
            assignment=assignment, cluster_counts=counts,
            participation=part, upload_bytes=up_bytes,
            download_bytes_broadcast=down_bc,
            download_bytes_per_client=down_pc, aggregated_uploads=n_agg)
        new_state = EngineState(
            round_idx=state.round_idx + 1, client_state=cs, server=server,
            ref_vecs=refs[0], ref_round=refs[1], ef_residual=ef)
        return new_state, rep

    # -- the wire ----------------------------------------------------------

    def _wire_is_identity(self) -> bool:
        """Dense float32 encode→decode is a bit-exact identity (pinned by
        the codec tests): the round needs no host codec boundary."""
        return self.cfg.codec.name == "float32" and not self.cfg.codec.sparse

    def _wire_uplink(self, state: EngineState, vecs, slots,
                     part: Participation):
        """Encode every upload of a surviving client to a real frame,
        meter it (slot id <i4 + frame) and decode what the aggregator
        sees; returns ``(decoded, bytes, ef_residual)``.  A dropped
        client and slot −1 send nothing; a straggler's frame was sent,
        so it is metered and its residual advances.  Sparse deltas are
        encoded against the client's tracked reference row; only the K
        sampled reference and residual rows leave the device."""
        cfg = self.cfg.codec
        np_slots = slots.cpu().numpy()
        active = part.active.cpu().numpy()
        if self._wire_is_identity():
            d = self.strategy.vec_dim
            return (vecs, int((np_slots[active] >= 0).sum()) * (4 + 4 * d),
                    state.ef_residual)
        idx = part.idx.long()
        np_vecs = np.asarray(vecs.detach().cpu().numpy(), np.float32)
        np_refs = (state.ref_vecs[idx].cpu().numpy() if cfg.sparse
                   else None)
        sub_ef = (np.array(state.ef_residual[idx].cpu().numpy())
                  if cfg.error_feedback else None)
        dec = np.zeros_like(np_vecs)
        total = 0
        for c in range(np_vecs.shape[0]):
            if not active[c]:
                continue                    # lost mid-round: nothing sent
            for j in range(np_vecs.shape[1]):
                s = int(np_slots[c, j])
                if s < 0:
                    continue                # nothing shared in this slot
                ref = np_refs[c, s] if cfg.sparse else None
                if sub_ef is not None:
                    frame, sub_ef[c, s] = ef_encode(
                        np_vecs[c, j], cfg, sub_ef[c, s], ref=ref)
                else:
                    frame = encode(np_vecs[c, j], cfg, ref=ref)
                total += 4 + len(frame)
                dec[c, j] = decode(frame, np_vecs.shape[2], cfg, ref=ref)
        ef = state.ef_residual
        if sub_ef is not None:
            ef = ef.index_put((idx,), torch.as_tensor(sub_ef,
                                                      device=ef.device))
        return torch.as_tensor(dec, device=vecs.device), total, ef

    def _update_refs(self, state: EngineState, part: Participation, arrive,
                     applied, rx_server, r: int):
        """Advance the per-client broadcast references: every arrived
        participant now holds the decoded rows it was just sent (its
        applied slots, or the whole matrix under ``all_slots``).  Only
        the K sampled rows cross to the host and back."""
        if not self.cfg.codec.sparse:
            return state.ref_vecs, state.ref_round
        idx = part.idx.long()
        sub = state.ref_vecs[idx].cpu().numpy()
        sub_rounds = state.ref_round[idx].cpu().numpy()
        self._advance_ref_rows(
            sub, sub_rounds, arrive.cpu().numpy(), applied.cpu().numpy(),
            rx_server.cpu().numpy(), r,
            self._downloads)
        dev = state.ref_vecs.device
        return (state.ref_vecs.index_put((idx,),
                                         torch.as_tensor(sub, device=dev)),
                state.ref_round.index_put(
                    (idx,), torch.as_tensor(sub_rounds, device=dev)))

    @staticmethod
    def _advance_ref_rows(sub, sub_rounds, arrive, applied, rx, r,
                          downloads):
        """Advance K sampled reference rows in place (numpy)."""
        for c in range(sub.shape[0]):
            if not arrive[c]:
                continue
            if downloads == "all_slots":
                sub[c] = rx
                sub_rounds[c] = r
            else:
                got = False
                for j in range(applied.shape[1]):
                    s = int(applied[c, j])
                    if s >= 0:
                        sub[c, s] = rx[s]
                        got = True
                if got:
                    sub_rounds[c] = r
        return sub, sub_rounds

    def _roundtrip_rows(self, server):
        """Encode→decode every server row through the *dense* codec
        (delta coding is upload-only): what any receiver of a broadcast
        holds.  Returns ``(rx_rows, frame_lengths)``; float32 is the
        identity, metered arithmetically (4·d bytes a frame)."""
        dense = CodecConfig(self.cfg.codec.name, sparse=False)
        if dense.name == "float32":
            return server, [4 * int(server.shape[1])] * int(server.shape[0])
        np_server = server.cpu().numpy()
        rx = np.zeros_like(np_server)
        frame_len = []
        for s in range(np_server.shape[0]):
            frame = encode(np_server[s], dense)
            frame_len.append(len(frame))
            rx[s] = decode(frame, np_server.shape[1], dense)
        return torch.as_tensor(rx, device=server.device), frame_len

    def _wire_tx_server(self, server):
        """The server matrix as the clients hold it: every row
        roundtripped through the dense codec.  ``state.server.slots``
        entering round r+1 is the very tensor the downlink of round r
        roundtripped, so that result is cached by identity; after a
        restore the cache misses and the same rows are recomputed."""
        if self._wire_is_identity():
            return server
        cached = self._tx_cache
        if cached is not None and cached[0] is server:
            return cached[1]
        rx, _ = self._roundtrip_rows(server)
        self._tx_cache = (server, rx)
        return rx

    def _wire_downlink(self, server, counts, arrive, applied):
        """Encode, meter and decode every slot row; clients apply the
        decoded rows.  ``down_bc`` is one frame per populated slot,
        ``down_pc`` the frames receiving clients apply (every frame to
        each arrived client under ``all_slots``)."""
        rx, frame_len = self._roundtrip_rows(server)
        if not self._wire_is_identity():
            self._tx_cache = (server, rx)      # next round trains from it
        np_counts = counts.cpu().numpy()
        down_bc = sum(n for n, c in zip(frame_len, np_counts) if c > 0)
        if self._downloads == "all_slots":
            down_pc = int(arrive.sum()) * sum(frame_len)
        else:
            down_pc = sum(frame_len[s] for s in applied.cpu().numpy().ravel()
                          if s >= 0)
        return rx, down_bc, down_pc
