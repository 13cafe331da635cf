"""The federated round engine, sync or async, on one device or a mesh.

Counterpart of ``repro/fl/runtime/engine.py``: sync barrier or async
buffered aggregation, every strategy of the reference (TPFL, FedTM,
FedAvg / FedProx, IFCA, FLIS-DC / HC) with its server-side ``assign``
and ``server_update`` hooks, every wire codec (float32, int8, int4;
sparse delta with ``<u2`` or varint+RLE indices; error feedback), under
any scheduler setting (partial participation; uniform, weighted or
round-robin sampling; dropout; stragglers), over a resident population
or the mmap client store, in process or shard-mapped over a clients
mesh.
:class:`RuntimeConfig` therefore holds the number of rounds, the
scheduler, the codec, the async settings, the backend (``backend``,
``mesh_axis``, ``mesh_collective``), the TM route's name, the
checkpoint cadence, the client store's settings and the transport
(``transport``, ``workers``: the same round with the client half run by
worker peers over framed messages, in process behind queues or as
socket subprocesses, :mod:`repro_torch.fl.transport`, whose
``TransportEngine`` drives this engine's server half).
``tm_backend`` takes the reference's two names, ``"ref"`` and
``"pallas"``, which the reference pins bit-identical; both name the
port's one route (the kernels on the GPU, their plain versions on the
CPU), so the setting changes nothing here.

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
   arrived uploads, summed in XLA's order for the shape
   (``core/clustering.py``), folded into the server state
   by the strategy's hook (default: Alg. 2, empty slots keep their row);
8. ``downlink``: slot rows are encoded, metered and decoded;
   ``apply_merge``: the arrived clients that shared a slot apply its
   decoded row (Phase D), the others keep their state from before the
   round; ``ref_track``: the arrived clients' references advance to the
   rows they applied;
9. ``eval``: the cohort is scattered back and every client of the
   population is evaluated (one fused-votes launch for the TM).

The mmap client store (``client_store="mmap"``, :mod:`repro_torch.fl.
store`): the population's rows (client state and, on the sparse wire,
the broadcast references) live in sparse files on the host, and the
engine state carries zero-row placeholders for them.  ``gather`` reads
the K sampled rows (digest-verified; a never-spilled row is regenerated
by the strategy's ``init_cohort``, bit for bit its row of the full
init) onto the engine's device; the round runs on them as on a resident
cohort, never through the in-order shortcut; a ``spill`` span after
``ref_track`` writes the merged rows and advanced references back; and
``eval`` re-gathers the population in ``store_eval_chunk`` blocks
(``store_eval="full"``, the resident report bit for bit) or evaluates
the cohort alone (``"sampled"``: the report's accuracy and assignment
then cover the K clients).  A :class:`~repro_torch.fl.store.
StreamingClientData` population (``fed_train --n-clients``) streams
each cohort's data from its LEAF shards; it needs the store.

Async buffered mode (``aggregation="async"``): no barrier.  Every
upload of a surviving client arrives, stragglers too, and lands in a
fixed-capacity buffer, six lanes of :class:`EngineState` (so
checkpoints carry it): payload, slot id, the round it matures
(``r + staleness``), its weight ``discount ** staleness``, validity and
insertion order.  On overflow the oldest insertion is evicted.  Once
``async_min_uploads`` entries have matured they are folded into the
server as the staleness-weighted mean per slot, and consumed; below
that nothing is folded and nothing is broadcast.  The round has no
``assign`` stage; the ``aggregate`` span holds the whole update.  Two
routes, bit for bit the same:

* ``async_buffer="device"``: insert, gate and mean as tensor ops on the
  engine's device (``executors.async_update``), nothing read back
  between them; the report's three counts are read once at the end;
* ``async_buffer="host"``: the reference's numpy insert loop, the
  executable reference the device route is pinned to, and the route of
  every strategy with server-side hooks (FLIS): its ``assign`` runs
  over the matured buffer rows when they are folded in, not when they
  were sent (:meth:`Engine._fold_host_buffer`).

The shard-mapped backend (``backend="shardmap"``, ``Engine(...,
mesh=...)`` with a :class:`~repro_torch.launch.mesh.ClientsMesh`): the
same engine runs on every rank of a ``torch.distributed`` clients group
from the same seed (SPMD), so the schedule, the codec, the ``assign``
hook and the async insert are replicated and every rank holds the same
server state, buffer lanes and population; the
:class:`~repro_torch.fl.runtime.executors.ShardMapExecutor` computes each
rank's block of the cohort and makes the outputs whole by collectives,
the aggregation one masked collective (``mesh_collective``: ``gather``,
bit for bit the in-process engine; ``psum``, the (C, m) accumulator,
exact on integer uploads).  On the identity wire under a sync barrier,
with the population in order and no ``assign`` hook, the whole round is
one executor call in a ``fused_round`` span (then the spans are
``schedule``, ``gather``, ``fused_round``, ``downlink``, ``eval``, as
in the reference).  Only rank 0 writes checkpoints; over the mmap store
only rank 0 holds the store and the rows reach the others by broadcast
(:class:`~repro_torch.fl.runtime.executors.RankZeroStore`).  The
caller gives telemetry to rank 0 alone.

The key chain matches the reference: ``k_init, k_rounds = split(key)``,
round r runs under ``fold_in(k_rounds, r)``.  With the same data and key
every report field and the final state (client state, server rows,
the buffer's lanes, ``ref_vecs`` / ``ref_round`` / ``ef_residual``) of
the TM strategies are bit-identical to the JAX engine, except
``mean_accuracy``, a float32 mean whose summation order may differ in
the last place, and a lossy sync aggregate at the shapes where XLA's
dot adds in an order the port does not emulate (``core/clustering.py``,
ROADMAP queue C item 4).  The MLP strategies are float
math, held to the reference within a stated tolerance
(tests/test_torch_baselines.py, tests/test_torch_async.py).
"""
from __future__ import annotations

import dataclasses
import math
import tempfile
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.data.partition import ClientData
from repro_torch.fl import masked_collectives
from repro_torch.fl.obs.recorder import NULL as NULL_TELEMETRY
from repro_torch.fl.runtime import checkpointing
from repro_torch.fl.runtime.codec import CodecConfig, decode, ef_encode, encode
from repro_torch.fl.runtime import executors
from repro_torch.fl.runtime.executors import (COLLECTIVES,
                                              InProcessExecutor,
                                              RankZeroStore,
                                              ShardMapExecutor,
                                              applied_slots)
from repro_torch.fl.runtime.scheduler import (Participation, Scheduler,
                                              SchedulerConfig)
from repro_torch.fl.runtime.strategy import (DOWNLOADS, ServerState,
                                             ensure_server_state,
                                             resolve_server_update)
from repro_torch.fl.store import client_store
from repro_torch.fl.store.client_store import ClientStore

BACKENDS = ("inprocess", "shardmap")
# the reference's TM route names; the port runs one route for both
TM_BACKENDS = ("ref", "pallas")
CLIENT_STORES = ("resident", "mmap")
TRANSPORTS = ("inprocess", "loopback", "socket")
STORE_EVALS = ("full", "sampled")

# the cohort hooks the engine calls on every strategy
_HOOKS = ("init", "fused_client_step", "apply_broadcast", "fused_evaluate")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    rounds: int = 10
    scheduler: SchedulerConfig = SchedulerConfig()
    codec: CodecConfig = CodecConfig()
    aggregation: str = "sync"         # sync | async
    async_min_uploads: int = 4        # B: aggregate once B uploads matured
    buffer_capacity: int = 64         # fixed-capacity async upload buffer
    staleness_discount: float = 0.5   # matured weight = discount**staleness
    async_buffer: str = "device"      # device (tensor ops) | host (reference)
    backend: str = "inprocess"        # inprocess | shardmap
    mesh_axis: str = "clients"        # the mesh's axis: "clients" only
    mesh_collective: str = "gather"   # gather (bit-exact) | psum (C·m bytes)
    tm_backend: str = "ref"           # the reference's names, one route here
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0         # 0 = never
    # the K-active working set: "mmap" keeps the client rows (params, TA
    # state, sparse-codec references) in a host ClientStore (the
    # reference's memory-mapped store, its files byte for byte) and only
    # the scheduler's K sampled rows ever reach the device
    client_store: str = "resident"    # resident | mmap
    store_dir: str | None = None      # mmap store root (None = fresh temp)
    store_eval: str = "full"          # full (chunked population) | sampled
    store_eval_chunk: int = 256       # clients per chunked-eval gather
    # where the round's client half runs (repro_torch.fl.transport):
    # "inprocess" is this engine's function calls; "loopback" runs the
    # same round protocol through in-memory length-prefixed frames to
    # worker peers in this process; "socket" runs M worker subprocesses
    # over local TCP, where staleness and dropout are observed arrivals
    transport: str = "inprocess"      # inprocess | loopback | socket
    workers: int = 0                  # worker peers (>= 1 under a transport)

    def __post_init__(self):
        if self.aggregation not in ("sync", "async"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r}; choose from "
                f"{TRANSPORTS} (see docs/transport.md)")
        if self.transport != "inprocess" and self.workers < 1:
            raise ValueError(
                f"transport={self.transport!r} partitions the client "
                "population over worker peers — set workers >= 1 "
                f"(got workers={self.workers})")
        if self.transport == "inprocess" and self.workers != 0:
            raise ValueError(
                f"workers={self.workers} is a transport knob; "
                "transport='inprocess' runs no workers (leave workers=0)")
        if self.transport != "inprocess" and self.aggregation == "async" \
                and self.codec.sparse:
            raise ValueError(
                "sparse delta coding needs encoder and decoder to agree "
                "on the reference rows at decode time; the arrival-"
                "driven async transport decodes uploads rounds after "
                "they were encoded, so run sparse=True with "
                "aggregation='sync' or transport='inprocess'")
        if self.transport != "inprocess" and self.backend != "inprocess":
            raise ValueError(
                f"transport={self.transport!r} distributes clients over "
                "worker processes — it composes with backend='inprocess' "
                f"only, not backend={self.backend!r} (shard_map is "
                "single-process mesh parallelism)")
        if self.transport != "inprocess" and self.client_store != "resident":
            raise ValueError(
                f"transport={self.transport!r} requires "
                "client_store='resident': worker processes own their "
                "client rows, which contradicts the single-process mmap "
                "store")
        if self.codec.error_feedback and self.client_store != "resident":
            raise ValueError(
                "codec.error_feedback keeps per-(client, slot) residual "
                "memory in EngineState — available with "
                "client_store='resident' only (the mmap store does not "
                "carry the residual lane)")
        if self.client_store not in CLIENT_STORES:
            raise ValueError(f"unknown client_store {self.client_store!r}")
        if self.store_eval not in STORE_EVALS:
            raise ValueError(f"unknown store_eval {self.store_eval!r}")
        if self.store_eval_chunk < 1:
            raise ValueError("store_eval_chunk must be >= 1")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.tm_backend not in TM_BACKENDS:
            raise ValueError(f"unknown tm_backend {self.tm_backend!r}")
        if self.mesh_collective not in COLLECTIVES:
            raise ValueError(
                f"unknown mesh_collective {self.mesh_collective!r}")
        if self.mesh_axis != "clients":
            # the port's mesh (launch.mesh.ClientsMesh) has this one axis
            raise ValueError(f"mesh has no {self.mesh_axis!r} axis: the "
                             f"clients mesh's one axis is 'clients'")
        if self.async_buffer not in ("device", "host"):
            raise ValueError(f"unknown async_buffer {self.async_buffer!r}")
        if self.backend == "shardmap" and self.aggregation == "async" \
                and self.async_buffer == "host":
            raise ValueError(
                "the host-buffered async reference is in-process only — "
                "the shard-mapped backend runs async_buffer='device'")


class EngineState(NamedTuple):
    round_idx: torch.Tensor     # () int32 — next round to run
    client_state: Any           # strategy state, leading axis = clients
    server: ServerState         # slot matrix + the strategy's aux
    # the async upload buffer, carried (and checkpointed) in every mode
    buf_vecs: torch.Tensor      # (cap, d) float32   payloads
    buf_slots: torch.Tensor     # (cap,) int32       slot id (−1 = empty)
    buf_ready: torch.Tensor     # (cap,) int32       round the entry matures
    buf_weight: torch.Tensor    # (cap,) float32     staleness discount
    buf_valid: torch.Tensor     # (cap,) bool        masked validity
    buf_seq: torch.Tensor       # (cap,) int32       insertion order
    # per-client broadcast references of the sparse-delta wire: the
    # server rows each client last received (zeros = never synced) and
    # the round it received them (−1 = never); zero-size when dense and
    # under the mmap store (which holds them; client_state is a zero-row
    # placeholder there too)
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
    buffered_uploads: int               # async: still waiting in the buffer
    evicted_uploads: int                # async: lost to buffer overflow
    store_read_bytes: int = 0           # mmap store host reads this round
    store_written_bytes: int = 0        # mmap store host writes this round
    # the real transport's gauges: framed bytes the server put on and
    # took off the wire this round, envelopes and headers included (0 in
    # process, where nothing crosses a wire)
    wire_tx_bytes: int = 0              # server → clients, framed
    wire_rx_bytes: int = 0              # clients → server, framed
    # the async transport's observed staleness summary of the uploads
    # that arrived this round (None in process, where it is a schedule)
    observed_staleness: Any = None


class Engine:
    """Round orchestrator for one strategy over one client population."""

    def __init__(self, strategy, data: ClientData, cfg: RuntimeConfig,
                 telemetry=None, mesh=None):
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
        # async strategies with server-side hooks fold on the host
        # buffer route, which re-runs ``assign`` at aggregation time
        self._async_hooks = cfg.aggregation == "async" and (
            self._assign is not None
            or getattr(strategy, "server_update", None) is not None)
        if self._async_hooks and cfg.backend == "shardmap":
            raise ValueError(
                "async + server-side assign/server_update hooks "
                "aggregate on the in-process host buffer path — run "
                "this strategy with backend='inprocess' (the shard-"
                "mapped async program hard-codes the hook-less fold)")
        self.data = data
        self.cfg = cfg
        # a streaming population knows its size and device without
        # materializing anything; ClientData carries both in its arrays
        self._streaming = hasattr(data, "gather_clients")
        self._mmap = cfg.client_store == "mmap"
        self.store: ClientStore | None = None
        if self._streaming and not self._mmap:
            raise ValueError(
                "streaming client data has no materialized population "
                "for the resident engine to index — run it with "
                "RuntimeConfig(client_store='mmap')")
        self.n = int(data.n_clients if self._streaming
                     else data.x_train.shape[0])
        self.device = data.device if self._streaming else data.x_train.device
        # weighted sampling weighs clients by the partitioner's pool
        # shares: clients holding more data are sampled more often
        self.scheduler = Scheduler(cfg.scheduler, self.n, data.sizes)
        # the clients mesh this rank belongs to (None in process)
        self.mesh = mesh if cfg.backend == "shardmap" else None
        if cfg.backend == "shardmap":
            self.executor = ShardMapExecutor(
                self.mesh, collective=cfg.mesh_collective)
            if self.mesh.device != self.device:
                raise ValueError(
                    f"the data lie on {self.device}, this rank of the "
                    f"mesh computes on {self.mesh.device}")
        else:
            self.executor = InProcessExecutor()
        # rank 0 alone writes checkpoints and the store
        self._rank0 = self.mesh is None or self.mesh.rank == 0
        # discount**staleness by staleness: Python's double pow cast once
        # to float32, as each host insert does
        self._discount = torch.as_tensor(np.asarray(
            [cfg.staleness_discount ** s
             for s in range(cfg.scheduler.max_staleness + 1)], np.float32),
            device=self.device)
        # a discount of 0 or a power of two weighs every buffered upload
        # by 0 or a power of two: the weighted mean's products are exact
        d = cfg.staleness_discount
        self._exact_products = d == 0 or math.frexp(d)[0] == 0.5
        # spans, fences and the per-round event sink; read-only, so
        # telemetry on and off give the same bits
        self.obs = telemetry if telemetry is not None else NULL_TELEMETRY
        # (server, roundtripped rows) of the latest broadcast, reused by
        # _wire_tx_server so a lossy codec roundtrips each server once
        self._tx_cache = None

    def init(self, key: torch.Tensor) -> EngineState:
        key = key.to(self.device)
        if self._mmap:
            cs, server = self._init_mmap(key)
        else:
            # FLIS draws its probe set from the clients' confidence split
            cs, server = self.strategy.init(key, self.n, self.data)
            server = ensure_server_state(server)
        shape = (self.n, self.strategy.n_slots, self.strategy.vec_dim)
        f32 = dict(dtype=torch.float32, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        codec = self.cfg.codec
        sparse = codec.sparse and not self._mmap   # else in the store
        cap, d = self.cfg.buffer_capacity, self.strategy.vec_dim
        return EngineState(
            round_idx=torch.zeros((), **i32), client_state=cs, server=server,
            buf_vecs=torch.zeros((cap, d), **f32),
            buf_slots=torch.full((cap,), -1, **i32),
            buf_ready=torch.zeros((cap,), **i32),
            buf_weight=torch.zeros((cap,), **f32),
            buf_valid=torch.zeros((cap,), dtype=torch.bool,
                                  device=self.device),
            buf_seq=torch.zeros((cap,), **i32),
            ref_vecs=torch.zeros(shape if sparse else (0, 0, 0), **f32),
            ref_round=(torch.full((self.n,), -1, **i32) if sparse
                       else torch.zeros((0,), **i32)),
            ef_residual=torch.zeros(
                shape if codec.error_feedback else (0, 0, 0), **f32))

    def _init_mmap(self, key: torch.Tensor):
        """Open the client store under ``cfg.store_dir`` (a fresh
        temporary directory without one) and return the O(K) state's
        client part, zero-row placeholders, and the server.

        Strategies with the O(K) init hooks (``init_cohort(key, ids, n)
        == init(key, n)[0][ids]`` bit for bit, and ``init_server``)
        never draw the population: the store regenerates each cohort's
        unwritten rows on the device and copies them to the host.  The
        others fall back to one full ``init`` whose rows are served by
        index from host memory: O(N) host memory once, still O(K) on the
        device."""
        strat = self.strategy
        cohort = getattr(strat, "init_cohort", None)
        init_server = getattr(strat, "init_server", None)
        if cohort is not None and init_server is not None:
            server = ensure_server_state(init_server(key, self.n))

            def cs_init(ids):
                return cohort(key, ids, self.n)
        else:
            cs, server = strat.init(key, self.n, self.data)
            server = ensure_server_state(server)
            rows = client_store.tree_map(client_store.to_host, cs)

            def cs_init(ids):
                return client_store.tree_map(lambda a: a[ids], rows)

        row = client_store.tree_map(lambda a: client_store.to_host(a)[0],
                                    cs_init(np.zeros((1,), np.int64)))
        n_slots, d = strat.n_slots, strat.vec_dim
        sparse = self.cfg.codec.sparse
        template = {"cs": row}
        if sparse:
            # a never-synced client's reference: zeros, round −1, as in
            # the resident init
            template["ref_vecs"] = np.zeros((n_slots, d), np.float32)
            template["ref_round"] = np.asarray(-1, np.int32)

        def init_fn(ids):
            out = {"cs": cs_init(ids)}
            if sparse:
                out["ref_vecs"] = np.zeros((ids.size, n_slots, d),
                                           np.float32)
                out["ref_round"] = np.full((ids.size,), -1, np.int32)
            return out

        store = None
        if self._rank0:
            root = self.cfg.store_dir or tempfile.mkdtemp(
                prefix="client_store_")
            store = ClientStore(root, self.n, template, init_fn=init_fn)
        self.store = (store if self.mesh is None
                      else RankZeroStore(self.mesh, store, template))
        placeholder = client_store.tree_map(
            lambda a: self._on_device(np.zeros((0,) + a.shape, a.dtype)),
            row)
        return placeholder, server

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        elif self._mmap:
            # resuming over an existing store: reopen it keyed by THIS
            # run's k_init, so rows never sampled before the checkpoint
            # fault in as the uninterrupted run would have drawn them
            # (the state a caller built to restore into may have used
            # another key)
            self.init(k_init)
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
            if self.cfg.checkpoint_dir and every and (r + 1) % every == 0 \
                    and self._rank0:
                if self._mmap:
                    # the checkpoint is the replicated state only; the
                    # rows are the store, flushed beside it so the two
                    # resume together
                    self.store.flush()
                checkpointing.save(
                    self.cfg.checkpoint_dir, state,
                    manifest=self.obs.manifest,
                    store_manifest=(self.store.manifest if self._mmap
                                    else None))
        return state, reports

    def run_round(self, state: EngineState, round_key: torch.Tensor
                  ) -> tuple[EngineState, RoundReport]:
        obs = self.obs            # telemetry spans/fences — no-ops when off
        r = int(state.round_idx)
        sync = self.cfg.aggregation == "sync"
        store = self.store
        if self._mmap:
            io0 = (store.io_read_bytes, store.io_written_bytes)
        with obs.span("schedule"):
            part = self.scheduler.sample(r, round_key)
            # a sync barrier drops late uploads; async buffers them
            arrive = part.active & (part.staleness == 0) if sync \
                else part.active
        # the cohort is the population in order: nothing is gathered (the
        # mmap store always stages its rows through gather and spill)
        in_order = self.scheduler.full_in_order and not self._mmap
        sub_refs = None
        with obs.span("gather"):
            keys = rnd.split(round_key, self.n)
            if in_order:
                sub_cs, sub_data = state.client_state, self.data
            else:
                idx = part.idx.long()
                keys = keys[idx]
                if self._mmap:
                    # the K sampled rows off the host store, onto the
                    # engine's device; the same per-client keys
                    np_ids = part.idx.cpu().numpy()
                    bundle = client_store.tree_map(self._on_device,
                                                   store.gather(np_ids))
                    sub_cs = bundle["cs"]
                    if self.cfg.codec.sparse:
                        sub_refs = (bundle["ref_vecs"], bundle["ref_round"])
                else:
                    sub_cs = tree.map(lambda a: a[idx], state.client_state)
                sub_data = (self.data.gather_clients(np_ids)
                            if self._streaming
                            else tree.map(lambda a: a[idx], self.data))
            obs.fence(keys)
        fused = None
        if sync and in_order and self.mesh is not None \
                and self._wire_is_identity() and self._assign is None:
            # the whole round as one executor call: each rank trains,
            # aggregates (one collective), applies and evaluates its block
            with obs.span("fused_round"):
                fused = self.executor.fused_sync_round(
                    self.strategy, sub_cs, state.server, sub_data, keys,
                    arrive)
                obs.fence(fused)
        buf = self._buf_of(state)
        n_buf = n_evict = 0
        refs = (state.ref_vecs, state.ref_round)
        ef = state.ef_residual
        if fused is not None:
            merged, server, counts, applied, acc, slots = fused
            with obs.span("downlink"):
                up_bytes = self._identity_upload_bytes(slots, part.active)
                _, down_bc, down_pc = self._wire_downlink(
                    server.slots, counts, arrive, applied)
        else:
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
                dec, up_bytes, ef = self._wire_uplink(state, vecs, slots,
                                                      part, sub_refs)
                obs.fence(dec)
            if self._assign is not None and sync:
                # metering and the sparse references used the tags that
                # crossed the wire; aggregation and the broadcast use
                # these.  Async assigns over the buffer when it folds it in
                with obs.span("assign"):
                    slots = self.executor.assign(self.strategy,
                                                 state.server, dec, slots,
                                                 arrive)
                    obs.fence(slots)
            if sync:
                with obs.span("aggregate"):
                    agg, counts = self.executor.masked_mean(
                        self.strategy, dec, slots, arrive)
                    obs.fence(agg, counts)
                with obs.span("server_update"):
                    server = self._server_update(state.server, agg, counts)
                    obs.fence(server)
            elif self.cfg.async_buffer == "host" or self._async_hooks:
                with obs.span("aggregate"):
                    server, counts, n_agg, n_buf, n_evict, buf = \
                        self._aggregate_async_host(state, dec, slots, part,
                                                   r)
                    obs.fence(server, counts)
            else:
                with obs.span("aggregate"):
                    srv_mat, counts, n_agg, n_buf, n_evict, buf = \
                        self._aggregate_async(state, dec, slots, part)
                    server = state.server._replace(slots=srv_mat)
                    obs.fence(server, counts)
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
                if sub_refs is not None:
                    sub_refs = self._advance_ref_rows(
                        sub_refs[0].cpu().numpy().copy(),
                        sub_refs[1].cpu().numpy().copy(),
                        arrive.cpu().numpy(), applied.cpu().numpy(),
                        rx_server.cpu().numpy(), r, self._downloads)
                refs = (state.ref_vecs, state.ref_round) if self._mmap \
                    else self._update_refs(state, part, arrive, applied,
                                           rx_server, r)
                obs.fence(refs)
            if self._mmap:
                # the merged rows and their advanced references back to the
                # host store: the round keeps no per-client device state
                with obs.span("spill"):
                    bundle = {"cs": merged}
                    if sub_refs is not None:
                        bundle["ref_vecs"], bundle["ref_round"] = sub_refs
                    store.spill(np_ids, bundle)
        if sync:
            n_agg = int((slots[arrive] >= 0).sum())
        with obs.span("eval"):
            if self._mmap:
                cs = state.client_state        # the rows live in the store
                acc, assignment = self._store_eval(idx, merged, applied,
                                                   sub_data)
            else:
                if in_order:
                    cs, assignment = merged, applied
                else:
                    cs = tree.map(lambda a, m: a.index_put((idx,), m),
                                  state.client_state, merged)
                    assignment = self._scatter_assignment(idx, applied)
                if fused is None:
                    acc = self.executor.evaluate(self.strategy, cs,
                                                 self.data.x_test,
                                                 self.data.y_test)
            # on a mesh the accuracies were gathered into one tensor on
            # this rank's device, so their mean is the in-process mean
            obs.fence(acc)
        store_io = ((store.io_read_bytes - io0[0],
                     store.io_written_bytes - io0[1]) if self._mmap
                    else (0, 0))
        rep = RoundReport(
            round_idx=r, mean_accuracy=acc.mean(), per_client_accuracy=acc,
            assignment=assignment, cluster_counts=counts,
            participation=part, upload_bytes=up_bytes,
            download_bytes_broadcast=down_bc,
            download_bytes_per_client=down_pc, aggregated_uploads=n_agg,
            buffered_uploads=n_buf, evicted_uploads=n_evict,
            store_read_bytes=store_io[0], store_written_bytes=store_io[1])
        new_state = EngineState(
            state.round_idx + 1, cs, server, *buf,
            ref_vecs=refs[0], ref_round=refs[1], ef_residual=ef)
        return new_state, rep

    def _scatter_assignment(self, idx, applied):
        """The population's (N, j) assignment: the cohort's applied
        slots at its ids, −1 elsewhere."""
        return torch.full((self.n, applied.shape[1]), -1, dtype=torch.int32,
                          device=self.device).index_put((idx,), applied)

    def _store_eval(self, idx, merged, applied, sub_data):
        """The mmap counterpart of the resident eval: ``(acc,
        assignment)``.  ``store_eval="full"`` re-gathers the whole
        population in ``store_eval_chunk`` blocks (the round has spilled
        its rows already) and evaluates each, the resident report bit
        for bit; ``"sampled"`` (the simulated-scale setting) evaluates
        the K merged rows only, and the accuracy and assignment cover
        the cohort."""
        if self.cfg.store_eval == "sampled":
            acc = self.executor.evaluate(self.strategy, merged,
                                         sub_data.x_test, sub_data.y_test)
            return acc, applied

        def gather_cs(ids):
            return client_store.tree_map(self._on_device,
                                         self.store.gather(ids)["cs"])

        def gather_xy(ids):
            if self._streaming:
                d = self.data.gather_clients(ids)
                return d.x_test, d.y_test
            j = torch.as_tensor(ids, device=self.device)
            return self.data.x_test[j], self.data.y_test[j]

        acc = executors.evaluate_population(
            self.executor, self.strategy, gather_cs, gather_xy, self.n,
            self.cfg.store_eval_chunk)
        return acc, self._scatter_assignment(idx, applied)

    # -- the async buffer ----------------------------------------------------

    @staticmethod
    def _buf_of(state: EngineState):
        """The buffer's six lanes, passed through unchanged by sync."""
        return (state.buf_vecs, state.buf_slots, state.buf_ready,
                state.buf_weight, state.buf_valid, state.buf_seq)

    def _aggregate_async(self, state, dec, slots, part: Participation):
        """The device route: this round's uploads flattened into lanes
        (payload, slot id, maturity round ``r + staleness``,
        ``discount**staleness``, validity) and handed with the buffer to
        the executor's insert → gate → mean.  The three counts come back
        in one read.  Bit for bit :meth:`_aggregate_async_host`."""
        k, j = slots.shape
        stale = part.staleness.long()

        def flat(a):
            return a[:, None].expand(k, j).reshape(-1)

        up = (dec.reshape(k * j, -1).to(torch.float32),
              slots.reshape(-1).to(torch.int32),
              (state.round_idx + flat(stale)).to(torch.int32),
              self._discount[flat(stale)],
              flat(part.active) & (slots.reshape(-1) >= 0))
        server, counts, n_agg, n_buf, n_evict, buf = \
            self.executor.async_update(
                self.strategy, self._buf_of(state), up, state.round_idx,
                state.server.slots, self.cfg.async_min_uploads,
                self._exact_products)
        n_agg, n_buf, n_evict = torch.stack(
            [n_agg, n_buf, n_evict]).tolist()
        return server, counts, n_agg, n_buf, n_evict, buf

    def _aggregate_async_host(self, state, dec, slots, part: Participation,
                              r: int):
        """The host route (``async_buffer="host"``, and every async
        strategy with server-side hooks): the reference's numpy insert
        loop, then :meth:`_fold_host_buffer`.  Returns a full
        :class:`ServerState`."""
        lanes = [a.cpu().numpy().copy() for a in self._buf_of(state)]
        evicted = self._host_insert(
            *lanes, dec.detach().cpu().numpy(), slots.cpu().numpy(),
            part.active.cpu().numpy(), part.staleness.cpu().numpy(), r,
            self.cfg.staleness_discount)
        server, counts, n_agg, n_buf, buf = self._fold_host_buffer(
            state, *lanes, r)
        return server, counts, n_agg, n_buf, evicted, buf

    @staticmethod
    def _host_insert(vecs, bslots, ready, weight, valid, seq, np_dec,
                     np_slots, active, stale, r: int,
                     discount: float) -> int:
        """Insert a round's uploads into the numpy lanes in place, one at
        a time (the reference's loop): the first free lane, or on
        overflow the oldest insertion's.  Returns the evicted count."""
        evicted = 0
        next_seq = int(seq[valid].max()) + 1 if valid.any() else 0
        for c in range(np_dec.shape[0]):
            if not active[c]:
                continue
            for j in range(np_dec.shape[1]):
                if np_slots[c, j] < 0:
                    continue
                free = np.nonzero(~valid)[0]
                if free.size:
                    i = free[0]
                else:       # overflow: evict the oldest *insertion*
                    occupied = np.where(valid, seq, np.iinfo(np.int32).max)
                    i = int(np.argmin(occupied))
                    evicted += 1
                vecs[i] = np_dec[c, j]
                bslots[i] = np_slots[c, j]
                ready[i] = r + int(stale[c])
                weight[i] = discount ** int(stale[c])
                valid[i] = True
                seq[i] = next_seq
                next_seq += 1
        return evicted

    def _fold_host_buffer(self, state, vecs, bslots, ready, weight, valid,
                          seq, r: int):
        """Fold the matured host-buffer entries into the server: the same
        maturity gate, ``assign`` re-run over the matured rows (each a
        single-upload client, the contribution mask its arrival) and the
        strategy's ``server_update`` fold.  Returns ``(server, counts,
        n_agg, n_buf, buf)``, the lanes back on the engine's device."""
        n_slots = self.strategy.n_slots
        dev = self.device
        # a zero-weight entry can never move the weighted mean: consumed
        # as noise, its slot not marked populated
        mature = valid & (ready <= r)
        contrib = mature & (weight > 0.0)
        if int(mature.sum()) >= self.cfg.async_min_uploads:
            w = torch.as_tensor(np.where(contrib, weight, 0.0)
                                .astype(np.float32), device=dev)
            s = torch.as_tensor(np.where(contrib, bslots, -1)
                                .astype(np.int32), device=dev)
            t_vecs = torch.as_tensor(vecs, device=dev)
            if self._assign is not None:
                on = torch.as_tensor(contrib, device=dev)
                new_s = self.executor.assign(self.strategy, state.server,
                                             t_vecs[:, None, :],
                                             s[:, None], on)
                s = torch.where(on, new_s[:, 0], -1).to(torch.int32)
            mean = masked_collectives.clustered_weighted_mean(
                t_vecs, s, w, n_slots, self._exact_products)
            counts = (s[:, None].long() == torch.arange(
                n_slots, device=dev)).to(torch.float32).sum(0)
            server = self._server_update(state.server, mean, counts)
            valid = valid & ~mature
            n_agg = int(contrib.sum())
        else:
            server = state.server
            counts = torch.zeros((n_slots,), dtype=torch.float32,
                                 device=dev)
            n_agg = 0
        buf = tuple(torch.as_tensor(a, device=dev)
                    for a in (vecs, bslots, ready, weight, valid, seq))
        return server, counts, n_agg, int(valid.sum()), buf

    # -- the wire ----------------------------------------------------------

    def _wire_is_identity(self) -> bool:
        """Dense float32 encode→decode is a bit-exact identity (pinned by
        the codec tests): the round needs no host codec boundary."""
        return self.cfg.codec.name == "float32" and not self.cfg.codec.sparse

    def _identity_upload_bytes(self, slots, active) -> int:
        """The identity wire's meter: a 4-byte slot id and 4·d payload
        bytes for each shared slot of each surviving client (the staged
        and the fused round both meter with it)."""
        shared = (slots.cpu().numpy()[active.cpu().numpy()] >= 0).sum()
        return int(shared) * (4 + 4 * self.strategy.vec_dim)

    def collective_payload_bytes(self) -> int | None:
        """Per-rank payload of the aggregation collective on the mesh,
        the gauge the run manifest records (None in process, where the
        aggregate is a local reduction)."""
        if self.cfg.backend != "shardmap":
            return None
        return masked_collectives.collective_payload_bytes(
            self.cfg.mesh_collective,
            self.scheduler.k * self.strategy.j_slots,
            self.strategy.vec_dim, self.strategy.n_slots)

    def _wire_uplink(self, state: EngineState, vecs, slots,
                     part: Participation, sub_refs=None):
        """Encode every upload of a surviving client to a real frame,
        meter it (slot id <i4 + frame) and decode what the aggregator
        sees; returns ``(decoded, bytes, ef_residual)``.  A dropped
        client and slot −1 send nothing; a straggler's frame was sent,
        so it is metered and its residual advances.  Sparse deltas are
        encoded against the client's tracked reference row; only the K
        sampled reference and residual rows leave the device (the mmap
        engine hands its store-gathered rows in as ``sub_refs``)."""
        cfg = self.cfg.codec
        np_slots = slots.cpu().numpy()
        active = part.active.cpu().numpy()
        if self._wire_is_identity():
            return (vecs, self._identity_upload_bytes(slots, part.active),
                    state.ef_residual)
        idx = part.idx.long()
        np_vecs = np.asarray(vecs.detach().cpu().numpy(), np.float32)
        if not cfg.sparse:
            np_refs = None
        elif sub_refs is not None:
            np_refs = sub_refs[0].cpu().numpy()
        else:
            np_refs = state.ref_vecs[idx].cpu().numpy()
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
