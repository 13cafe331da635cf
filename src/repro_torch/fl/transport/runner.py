"""TransportEngine: the server side of the real-transport runtime.

Counterpart of ``repro/fl/transport/runner.py``.  Runs the same staged
federated round as :class:`repro_torch.fl.runtime.engine.Engine` —
schedule → broadcast → client step → uplink codec → (assign) →
aggregate → server_update → downlink → eval — with every client-side
stage executed by worker peers behind a wire: the broadcast rows go out
as encoded frames inside WORK messages, the uplink comes back as the
workers' actual codec frames inside UPLOAD messages, and the block
evaluations return as EVAL messages.  The server keeps the
server-owned halves (scheduler, assignment, aggregation, server state,
sparse-reference tracking for decode) on the engine's device and reuses
the engine's own helpers for them, so the two cannot drift.

Conformance: with ``transport="loopback"`` a run equals the in-process
engine's bit for bit — every report field but the wire gauges, the
codec-metered byte totals and the final state — on every wire, sync,
for the TM strategies (``tests/test_torch_transport_loopback.py``);
and the port's loopback equals the JAX package's loopback bit for bit,
the wire gauges and the async path included.  The wire gauges
(``wire_tx_bytes`` / ``wire_rx_bytes``) count the framed bytes that
crossed the transport, which the in-process engine has none of.

Async mode is arrival-driven: workers hold straggling uploads and flush
them in later rounds tagged with their source round; the server
buffers whatever arrives, mature at once, weighted by the observed lag
(``discount ** (arrival − source)``), and records the observed
staleness summary in each round's report and event.  Arrivals go in in
worker rank order, so an async transport run is the same federation as
the in-process engine's, not its bits.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.fl.runtime import executors
from repro_torch.fl.runtime.codec import CodecConfig, decode, encode
from repro_torch.fl.runtime.engine import Engine, EngineState, RoundReport
from repro_torch.fl.runtime.scheduler import arrival_participation
from repro_torch.fl.transport import framing
from repro_torch.fl.transport.faults import FaultPlan, RetryPolicy
from repro_torch.fl.transport.loopback import LoopbackTransport
from repro_torch.fl.transport.messages import (DownClient, Downlink, Eval,
                                               MsgKind, Upload, Work,
                                               WorkClient)
from repro_torch.fl.transport.socket_transport import SocketTransport
from repro_torch.fl.transport.worker import (ClientWorker, block_range,
                                             runtime_config_to_dict)


class TransportEngine:
    """Round orchestrator over a real transport (loopback or socket)."""

    def __init__(self, strategy, data, cfg, telemetry=None,
                 faults: FaultPlan | None = None,
                 retry: RetryPolicy | None = None,
                 spec: dict | None = None):
        if cfg.transport not in ("loopback", "socket"):
            raise ValueError(
                f"TransportEngine runs transport='loopback' | 'socket'; "
                f"transport={cfg.transport!r} is the in-process Engine")
        if cfg.transport == "socket" and spec is None:
            raise ValueError(
                "transport='socket' needs a worker spec dict (scenario "
                "kwargs for repro_torch.launch.fed_train.build_scenario, "
                "with its device) so worker subprocesses can rebuild the "
                "identical scenario")
        self.eng = Engine(strategy, data, cfg, telemetry=telemetry)
        self.cfg = cfg
        self.obs = self.eng.obs
        self.faults = faults or FaultPlan()
        self.retry = retry or RetryPolicy()
        self.spec = spec
        self._dense = CodecConfig(cfg.codec.name, sparse=False)

    # -- lifecycle -----------------------------------------------------------

    def run(self, key: torch.Tensor, rounds: int | None = None
            ) -> tuple[EngineState | None, list[RoundReport]]:
        """Run the configured rounds over the transport.

        Returns ``(final_state, reports)``.  Loopback assembles the
        final :class:`EngineState` from the server lanes plus the
        workers' block state; a socket run returns ``state=None`` — the
        population lives in worker processes that have already exited.
        """
        eng = self.eng
        key = key.to(eng.device)
        k_init, k_rounds = rnd.split(key).unbind(0)
        state = eng.init(k_init)
        transport, workers = self._open(state, key)
        try:
            reports: list[RoundReport] = []
            n_rounds = self.cfg.rounds if rounds is None else rounds
            for r in range(n_rounds):
                with self.obs.span("round"):
                    state, rep = self._round(
                        transport, state, rnd.fold_in(k_rounds, r), r)
                    self.obs.fence(state)
                self.obs.on_round(rep)
                reports.append(rep)
            self._shutdown(transport)
            if workers is not None:
                state = self._assemble_state(state, workers)
            else:
                state = None
        finally:
            transport.close()
        return state, reports

    def _open(self, state: EngineState, key: torch.Tensor):
        cfg, eng = self.cfg, self.eng
        if cfg.transport == "socket":
            spec = dict(self.spec)
            spec["runtime"] = runtime_config_to_dict(cfg)
            spec["key"] = [int(w) for w in key.cpu().tolist()]
            if self.faults.delay or self.faults.drop:
                spec["faults"] = {"delay": list(self.faults.delay),
                                  "drop": list(self.faults.drop)}
            device = torch.device(spec["scenario"].get("device") or "cuda")
            if device.type == "cuda":
                # the workers load the kernel libraries; build them once
                # here rather than once in each worker
                from repro_torch.kernels import _build
                _build.build()
            return SocketTransport.launch(spec, cfg.workers,
                                          connect_timeout=
                                          self.retry.timeout * 10), None
        workers = []
        for rank in range(cfg.workers):
            lo, hi = block_range(eng.n, cfg.workers, rank)

            def block(a, lo=lo, hi=hi):
                return a[lo:hi]

            workers.append(ClientWorker(
                rank, lo, hi, eng.strategy, cfg,
                block_cs=tree.map(block, state.client_state),
                block_data=tree.map(block, eng.data),
                ref_vecs=(block(state.ref_vecs) if cfg.codec.sparse
                          else None),
                ref_round=(block(state.ref_round) if cfg.codec.sparse
                           else None),
                ef=(block(state.ef_residual) if cfg.codec.error_feedback
                    else None),
                faults=self.faults))
        return LoopbackTransport(workers, faults=self.faults), workers

    def _shutdown(self, transport) -> None:
        for rank in transport.ranks:
            transport.send(rank, MsgKind.SHUTDOWN, b"")
        for rank in transport.ranks:
            self._recv(transport, rank, MsgKind.BYE)

    def _assemble_state(self, state: EngineState, workers) -> EngineState:
        """Loopback final state: server lanes from the server, client
        rows (and error-feedback residuals — client-side wire state)
        re-assembled from the worker blocks in rank order."""
        cs = tree.map(lambda *blocks: torch.cat(blocks, 0),
                      *[w.block_cs for w in workers])
        ef = state.ef_residual
        if self.cfg.codec.error_feedback:
            ef = torch.from_numpy(np.concatenate(
                [w.ef for w in workers], axis=0)).to(ef.device)
        return state._replace(client_state=cs, ef_residual=ef)

    # -- wire helpers --------------------------------------------------------

    def _recv(self, transport, rank: int, want: int):
        """One expected message, under the retry policy: disconnects and
        timeouts back off exponentially and retry; attempts exhausted →
        the last error propagates."""
        last = None
        for attempt in range(self.retry.attempts):
            if attempt:
                time.sleep(self.retry.backoff * 2 ** (attempt - 1))
                transport.reconnect(rank)
            try:
                kind, payload, nbytes = transport.recv(
                    rank, timeout=self.retry.timeout)
            except (framing.DisconnectError, TimeoutError) as e:
                last = e
                continue
            if kind != want:
                raise framing.WireError(
                    f"expected message kind {want} from worker {rank}, "
                    f"got {kind}")
            return kind, payload, nbytes
        raise last

    def _row_frames(self, server: torch.Tensor) -> list[bytes]:
        """The server matrix as dense codec frames — what WORK and
        DOWNLINK carry.  Deterministic encode: the bytes equal the
        engine's roundtrip encode of the same matrix."""
        np_server = np.asarray(server.detach().cpu().numpy(), np.float32)
        if self.eng._wire_is_identity():
            return [np_server[s].tobytes()
                    for s in range(np_server.shape[0])]
        return [encode(np_server[s], self._dense)
                for s in range(np_server.shape[0])]

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.eng.device)

    # -- one round -----------------------------------------------------------

    def _round(self, transport, state: EngineState, round_key, r: int
               ) -> tuple[EngineState, RoundReport]:
        eng, cfg, obs = self.eng, self.cfg, self.obs
        strategy = eng.strategy
        sync = cfg.aggregation == "sync"
        wire_tx = wire_rx = 0

        with obs.span("schedule"):
            part = eng.scheduler.sample(r, round_key)
            np_idx = part.idx.cpu().numpy()
            active = part.active.cpu().numpy()
            sched_stale = part.staleness.cpu().numpy()

        # the engine's exact per-client key stream: split over the full
        # population, then the cohort's rows, as uint32 words
        keys = rnd.split(round_key, eng.n)[part.idx.long()].cpu().numpy()

        with obs.span("broadcast_encode"):
            rows = self._row_frames(state.server.slots)
            d = strategy.vec_dim

        # cohort → worker blocks (position k in cohort order per rank)
        n_workers = len(transport.ranks)
        rank_of = np.empty((eng.n,), np.int32)
        for rank in transport.ranks:
            lo, hi = block_range(eng.n, n_workers, rank)
            rank_of[lo:hi] = rank
        by_rank: dict[int, list[int]] = {rank: [] for rank in
                                         transport.ranks}
        for k, g in enumerate(np_idx):
            by_rank[int(rank_of[g])].append(k)

        with obs.span("wire_tx"):
            for rank in transport.ranks:
                clients = tuple(
                    WorkClient(gidx=int(np_idx[k]),
                               key=(int(keys[k, 0]), int(keys[k, 1])),
                               active=bool(active[k]),
                               staleness=int(sched_stale[k]))
                    for k in by_rank[rank])
                wire_tx += transport.send(
                    rank, MsgKind.WORK,
                    Work(round_idx=r, dim=d, rows=tuple(rows),
                         clients=clients).pack())

        # collect the round's real uplink frames
        K, j = eng.scheduler.k, strategy.j_slots
        dec = np.zeros((K, j, d), np.float32)
        slots = np.full((K, j), -1, np.int32)
        received = np.zeros((K,), bool)
        recv_stale = np.zeros((K,), np.int32)
        arrivals: list[tuple[int, int, np.ndarray, int]] = []
        pos_of = {int(g): k for k, g in enumerate(np_idx)}
        sparse = cfg.codec.sparse
        refs_np = state.ref_vecs.cpu().numpy() if sparse else None
        up_bytes = 0
        with obs.span("wire_rx"):
            uploads = []
            for rank in transport.ranks:
                _, payload, nbytes = self._recv(transport, rank,
                                                MsgKind.UPLOAD)
                wire_rx += nbytes
                uploads.append(Upload.unpack(payload))
        with obs.span("uplink_codec"):
            for up in uploads:
                for e in up.entries:
                    for j_idx, s, frame in e.frames:
                        up_bytes += 4 + len(frame)
                        ref = refs_np[e.gidx, s] if sparse else None
                        vec = decode(frame, d, cfg.codec, ref=ref)
                        if sync:
                            k = pos_of[e.gidx]
                            dec[k, j_idx] = vec
                            slots[k, j_idx] = s
                        else:
                            arrivals.append(
                                (e.gidx, s, vec, r - e.src_round))
                            if e.src_round == r:
                                # on-time sender in this round's cohort:
                                # the server knows its proposed tags, so
                                # applied_slots can route rows back to it
                                slots[pos_of[e.gidx], j_idx] = s
                    if sync:
                        k = pos_of[e.gidx]
                        received[k] = True
                        recv_stale[k] = e.staleness

        observed_summary = None
        if sync:
            # the sync barrier: an upload counts only if it arrived in
            # its own round (without faults this equals the scheduled
            # active & staleness == 0 mask)
            arrive = received & (recv_stale == 0)
            dec_t, slots_t = self._on_device(dec), self._on_device(slots)
            arrive_t = self._on_device(arrive)
            if eng._assign is not None:
                with obs.span("assign"):
                    slots_t = eng.executor.assign(
                        strategy, state.server, dec_t, slots_t, arrive_t)
                    obs.fence(slots_t)
            with obs.span("aggregate"):
                agg, counts = eng.executor.masked_mean(
                    strategy, dec_t, slots_t, arrive_t)
                obs.fence(agg, counts)
            with obs.span("server_update"):
                server = eng._server_update(state.server, agg, counts)
                obs.fence(server)
            n_agg = int((slots_t.cpu().numpy()[arrive] >= 0).sum())
            buf = eng._buf_of(state)
            n_buf = n_evict = 0
            recv_mask = arrive
        else:
            with obs.span("aggregate"):
                server, counts, n_agg, n_buf, n_evict, buf = \
                    self._buffer_arrivals(state, arrivals, r)
                obs.fence(server, counts)
            slots_t = self._on_device(slots)
            # every active client trained and applies the broadcast,
            # matching the engine's async recv = active
            recv_mask = active
            observed_summary = arrival_participation(
                [g for g, _, _, _ in arrivals],
                [lag for _, _, _, lag in arrivals],
                device=eng.device).summary()

        recv = self._on_device(recv_mask)
        with obs.span("downlink"):
            applied = executors.applied_slots(slots_t, counts, recv)
            rx_server, down_bc, down_pc = eng._wire_downlink(
                server.slots, counts, recv, applied)
            obs.fence(rx_server)
            down_rows = self._row_frames(server.slots)
        with obs.span("ref_track"):
            refs = eng._update_refs(state, part, recv, applied, rx_server,
                                    r)
            obs.fence(refs)

        np_applied = applied.cpu().numpy()
        with obs.span("wire_tx"):
            for rank in transport.ranks:
                clients = tuple(
                    DownClient(gidx=int(np_idx[k]),
                               arrive=bool(recv_mask[k]),
                               applied=tuple(int(s)
                                             for s in np_applied[k]))
                    for k in by_rank[rank])
                wire_tx += transport.send(
                    rank, MsgKind.DOWNLINK,
                    Downlink(round_idx=r, dim=d, rows=tuple(down_rows),
                             clients=clients).pack())

        with obs.span("eval"):
            accs = []
            with obs.span("wire_rx"):
                for rank in transport.ranks:
                    _, payload, nbytes = self._recv(transport, rank,
                                                    MsgKind.EVAL)
                    wire_rx += nbytes
                    accs.append(np.asarray(Eval.unpack(payload).acc))
            acc = self._on_device(np.concatenate(accs))
            obs.fence(acc)

        if eng.scheduler.full_in_order:
            assignment = applied
        else:
            assignment = eng._scatter_assignment(part.idx.long(), applied)

        new_state = EngineState(
            state.round_idx + 1,
            state.client_state,                 # worker-owned; see run()
            server, *buf, ref_vecs=refs[0], ref_round=refs[1],
            ef_residual=state.ef_residual)
        rep = RoundReport(
            round_idx=r, mean_accuracy=acc.mean(),
            per_client_accuracy=acc, assignment=assignment,
            cluster_counts=counts, participation=part,
            upload_bytes=up_bytes, download_bytes_broadcast=down_bc,
            download_bytes_per_client=down_pc, aggregated_uploads=n_agg,
            buffered_uploads=n_buf, evicted_uploads=n_evict,
            wire_tx_bytes=wire_tx, wire_rx_bytes=wire_rx,
            observed_staleness=observed_summary)
        return new_state, rep

    def _buffer_arrivals(self, state: EngineState, arrivals, r: int):
        """Arrival-driven async aggregation: insert whatever landed this
        round into the host buffer — mature at once, weighted by the
        observed lag — then run the engine's shared fold (maturity gate,
        assign at aggregation, server_update)."""
        cfg = self.eng.cfg
        vecs, bslots, ready, weight, valid, seq = (
            a.cpu().numpy().copy() for a in self.eng._buf_of(state))
        evicted = 0
        next_seq = int(seq[valid].max()) + 1 if valid.any() else 0
        for _, slot, vec, lag in arrivals:
            free = np.nonzero(~valid)[0]
            if free.size:
                i = free[0]
            else:            # overflow: evict the oldest insertion
                occupied = np.where(valid, seq, np.iinfo(np.int32).max)
                i = int(np.argmin(occupied))
                evicted += 1
            vecs[i] = vec
            bslots[i] = slot
            ready[i] = r                       # it arrived: mature now
            weight[i] = cfg.staleness_discount ** int(lag)
            valid[i] = True
            seq[i] = next_seq
            next_seq += 1
        server, counts, n_agg, n_buf, buf = self.eng._fold_host_buffer(
            state, vecs, bslots, ready, weight, valid, seq, r)
        return server, counts, n_agg, n_buf, evicted, buf
