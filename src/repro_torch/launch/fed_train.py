"""Run a federation on the port: the scenario runner's CLI.

Counterpart of ``repro/launch/fed_train.py``'s CLI for the configuration
this slice of the port supports: every strategy of the reference (TPFL,
FedTM, and the MLP baselines FedAvg, FedProx, IFCA, FLIS-DC, FLIS-HC),
sync or async, in process, over the real transport or shard-mapped
over a clients mesh, under the reference's scheduler and wire codec
flags, on the reference's data path:

  PYTHONPATH=src python -m repro_torch.launch.fed_train \\
      --dataset mnist --data-dir DATA --clauses 300 --clients 20 \\
      --rounds 2 [--encoding thermometer:2] [--writers W] \\
      [--strategy tpfl|fedtm|fedavg|fedprox|ifca|flis_dc|flis_hc \\
       --max-slots S --probe-size P] \\
      [--participation P | --active K] \\
      [--sampling uniform|weighted|round_robin] [--dropout D] \\
      [--straggler S --max-staleness M] \\
      [--codec float32|int8|int4 --sparse --index-coding u2|vrle \\
       --error-feedback] [--mode sync|async --async-min-uploads B \\
       --buffer-capacity CAP --staleness-discount D \\
       --async-buffer device|host] [--telemetry-dir RUN_DIR \\
       --profile-dir DIR] [--tm-backend ref|pallas] \\
      [--client-store resident|mmap --store-dir DIR \\
       --store-eval full|sampled] [--n-clients N] \\
      [--transport inprocess|loopback|socket --workers M] \\
      [--backend inprocess|shardmap] [--mesh clients[:N] \\
       --collective gather|psum]

runs on the GPU; ``--device cpu`` runs the kernels' plain versions.
``--tm-backend`` takes the reference's two names for its TM routes,
which it pins bit-identical: both name the port's one route (the
kernels on the GPU, their plain versions on the CPU).  A LEAF kind
(``femnist``, ``synthfemnist``) under ``--data-dir`` takes the
writer-natural split; ``--writers`` sizes the mirror when it writes the
shards (default ``max(25, clients)``).  ``--client-store mmap``
keeps the client rows in a host store of sparse files under
``--store-dir`` (a fresh temporary directory without one; reuse it with
``--ckpt-dir`` to resume) and only the K sampled rows on the device;
``--store-eval sampled`` evaluates the cohort alone.  ``--n-clients N``
streams a LEAF population of N clients from the shards under
``--data-dir`` (cyclic over the writers past their count; mirror
default 25 writers), cohort by cohort; it needs the mmap store.  It
prints the same per-round ``acc= … up= … down_bc= … down_pc= …
active=a/K`` lines (async: `` agg= buf= evict=`` after them), totals
line and, under the store, ``client store: read=… written=…`` line as
the reference CLI.  ``--transport
loopback --workers M`` runs the round's client half in M worker peers
behind in-memory framed queues (the in-process run bit for bit);
``--transport socket`` in M worker subprocesses over local TCP, each
rebuilding its block of the scenario on the run's device (every worker
on the server's card on a GPU host); the round lines then end with
``wire_tx=…B wire_rx=…B``, the framed bytes that crossed the wire.
``--mesh clients:N`` (or ``--backend shardmap``, every visible device)
runs the round over a clients mesh of N ranks, one engine a rank
(``repro_torch.launch.mesh``): on GPUs one NCCL rank per card (N at
most the cards visible), with ``--device cpu`` N ``gloo`` processes;
``--collective gather`` aggregates bit for bit as in process, ``psum``
by one all-reduce of the (C, m) accumulator.  Rank 0 prints the same
lines, records telemetry and writes the checkpoints (the in-process
run's files, byte for byte); ``--resume`` restores on every rank.
``--ckpt-dir D
--ckpt-every k`` saves the engine state every k rounds; ``--resume``
continues from the newest checkpoint in D and completes the requested
``--rounds`` in total.  ``--telemetry-dir`` records a manifest and one
event a round (render with ``python -m repro_torch.fl.obs summarize
RUN_DIR``); ``--profile-dir`` adds a ``torch.profiler`` trace.
Telemetry never changes what the run computes.
"""
from __future__ import annotations

import argparse

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core import federation, tm
from repro_torch.data.ingest import natural, registry
from repro_torch.fl import obs
from repro_torch.fl.obs.events import accuracy_deciles, worst_decile_mean
from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                    RuntimeConfig, SchedulerConfig,
                                    build_baseline_strategy, checkpointing)
from repro_torch.fl.runtime.engine import BACKENDS, TM_BACKENDS, TRANSPORTS
from repro_torch.fl.runtime.executors import COLLECTIVES
from repro_torch.fl.runtime.codec import CODECS, INDEX_CODINGS
from repro_torch.fl.runtime.scheduler import SAMPLING
from repro_torch.fl.store import StreamingClientData
from repro_torch.launch import mesh as mesh_lib

STRATEGY_CHOICES = ("tpfl", "fedavg", "fedprox", "ifca", "flis_dc",
                    "flis_hc", "fedtm")


def _build_strategy(name: str, tm_cfg: tm.TMConfig,
                    fed_cfg: federation.FedConfig, pool,
                    max_slots: int = 8, probe_size: int = 64):
    """``pool`` is anything with ``n_features`` / ``n_classes``.  The TM
    strategies (TPFL, FedTM) take the TM config; the MLP baselines size
    themselves from the pool."""
    if name == "tpfl":
        return federation.tpfl_strategy(tm_cfg, fed_cfg)
    if name == "fedtm":
        return FedTMStrategy(tm_cfg, local_epochs=fed_cfg.local_epochs)
    return build_baseline_strategy(
        name, n_features=pool.n_features, n_classes=pool.n_classes,
        local_epochs=fed_cfg.local_epochs, max_slots=max_slots,
        probe_size=probe_size)


def build_scenario(*, dataset: str, data_dir: str | None = None,
                   encoding: str = "bool", clients: int = 20,
                   clauses: int = 48, seed: int = 0, experiment: int = 5,
                   writers: int | None = None, rounds: int = 5,
                   local_epochs: int = 2,
                   strategy: str = "tpfl", max_slots: int = 8,
                   probe_size: int = 64, device=None):
    """(partitioned client data, TM config, fed config, strategy), as the
    reference builds them: the registry's pool (``n_samples=6000``,
    ``side=12``, from ``seed``; through the mirror under ``data_dir``,
    which writes ``writers or max(25, clients)`` hands for a LEAF kind),
    split by ``partition_pool`` from ``PRNGKey(seed + 1)`` (LEAF kinds
    by writer)
    into 80 / 40 / 40 train / test / confidence samples a client, a TM
    with n_states=63, s=5, T=40, and the strategy named (FLIS capped at
    ``max_slots`` rows with a ``probe_size`` probe set).  The data lies
    on ``device``, the GPU unless the caller names another."""
    pool = registry.load(dataset, data_dir, encoding=encoding,
                         n_samples=6000, side=12, seed=seed,
                         n_writers=writers or max(25, clients),
                         device=device)
    data = natural.partition_pool(
        pool, n_clients=clients, n_train=80, n_test=40, n_conf=40,
        key=rnd.PRNGKey(seed + 1, pool.x.device), experiment=experiment)
    tm_cfg = tm.TMConfig(n_classes=pool.n_classes, n_clauses=clauses,
                         n_features=pool.n_features, n_states=63, s=5.0,
                         T=40)
    fed_cfg = federation.FedConfig(n_clients=clients, rounds=rounds,
                                   local_epochs=local_epochs)
    strat = _build_strategy(strategy, tm_cfg, fed_cfg, pool,
                            max_slots=max_slots, probe_size=probe_size)
    return data, tm_cfg, fed_cfg, strat


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Federated runtime scenario runner on PyTorch (GPU by "
                    "default)")
    ap.add_argument("--dataset", default="synthmnist",
                    choices=registry.names())
    ap.add_argument("--data-dir", default=None,
                    help="dataset cache (IDX files / LEAF shards; the "
                         "offline mirror populates it, real files are "
                         "used as they are).  Required for the real "
                         "flavours; synth* fall back to in-memory "
                         "generation without it")
    ap.add_argument("--encoding", default="bool", metavar="SPEC",
                    help="feature encoding: bool[:threshold] | "
                         "thermometer[:levels] | quantile[:levels]")
    ap.add_argument("--writers", type=int, default=None,
                    help="LEAF mirror size (writers ≥ clients; default "
                         "max(25, clients)).  Only shapes a cache being "
                         "written — existing shards win; clear the "
                         "data dir to regenerate")
    ap.add_argument("--strategy", default="tpfl", choices=STRATEGY_CHOICES)
    ap.add_argument("--max-slots", type=int, default=8,
                    help="FLIS: server slot rows — dynamic clusters are "
                         "recomputed each round and capped at this many")
    ap.add_argument("--probe-size", type=int, default=64,
                    help="FLIS: size of the server-side probe set drawn "
                         "from the confidence split")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--n-clients", type=int, default=None,
                    dest="n_clients", metavar="N",
                    help="simulated-scale population: stream per-writer "
                         "LEAF shards on demand for the sampled cohort "
                         "instead of materializing the pool (clients "
                         "map cyclically onto writers beyond the writer "
                         "count).  Requires --data-dir and --client-store "
                         "mmap.  Overrides --clients")
    ap.add_argument("--active", type=int, default=None, metavar="K",
                    help="sample K clients per round (sets "
                         "--participation K/N)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--clauses", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--experiment", type=int, default=5,
                    help="paper setup 1..5 (fraction of non-IID clients)")
    # scheduler knobs
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--sampling", default="uniform", choices=SAMPLING)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--straggler", type=float, default=0.0)
    ap.add_argument("--max-staleness", type=int, default=2)
    # wire codec
    ap.add_argument("--codec", default="float32", choices=CODECS)
    ap.add_argument("--sparse", action="store_true",
                    help="sparse delta encoding of uploads")
    ap.add_argument("--error-feedback", action="store_true",
                    dest="error_feedback",
                    help="per-client error-feedback residuals on the "
                         "lossy int8/int4 uplink (carried in the engine "
                         "state and its checkpoints)")
    ap.add_argument("--index-coding", default="u2", dest="index_coding",
                    choices=INDEX_CODINGS,
                    help="sparse-delta index stream: u2 = raw uint16 "
                         "indices, vrle = varint gap/run-length pairs "
                         "(requires --sparse)")
    # real transport (docs/transport.md)
    ap.add_argument("--transport", default="inprocess", choices=TRANSPORTS,
                    help="where the round's client half runs: inprocess = "
                         "the single-process engine, loopback = worker "
                         "peers behind in-memory framed queues (bit-"
                         "identical to inprocess), socket = worker "
                         "subprocesses over local TCP exchanging the "
                         "encoded frames as length-prefixed messages")
    ap.add_argument("--workers", type=int, default=0, metavar="M",
                    help="transport worker peers; the population is "
                         "partitioned into M contiguous blocks (required "
                         ">= 1 for --transport loopback/socket)")
    # execution backend
    ap.add_argument("--backend", default=None,
                    choices=BACKENDS,
                    help="round executor; 'shardmap' without --mesh uses "
                         "a clients mesh of all visible devices "
                         "(equivalent to --mesh clients)")
    ap.add_argument("--mesh", default=None, metavar="clients[:N]",
                    help="run the round shard-mapped over a clients mesh "
                         "of N ranks (default: one per visible GPU; with "
                         "--device cpu, N gloo processes, default 1); "
                         "composes with --mode async (device buffer)")
    ap.add_argument("--collective", default="gather", choices=COLLECTIVES,
                    help="mesh aggregation: gather is bit-exact with "
                         "in-process, psum is C*m collective bytes")
    # aggregation mode
    ap.add_argument("--mode", default="sync", choices=("sync", "async"))
    ap.add_argument("--async-min-uploads", type=int, default=4)
    ap.add_argument("--buffer-capacity", type=int, default=64)
    ap.add_argument("--staleness-discount", type=float, default=0.5)
    ap.add_argument("--async-buffer", default="device",
                    choices=("device", "host"),
                    help="async upload buffer: device = tensor ops on the "
                         "engine's device (works with --mesh), host = the "
                         "numpy reference loop")
    ap.add_argument("--tm-backend", default="ref",
                    choices=TM_BACKENDS,
                    help="the reference's TM route names (ref | pallas), "
                         "bit-identical there; both run the port's one "
                         "route: the kernels on the GPU, their plain "
                         "versions with --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain versions)")
    # host-side client store
    ap.add_argument("--client-store", default="resident",
                    dest="client_store", choices=("resident", "mmap"),
                    help="mmap keeps client rows in a host store of "
                         "sparse files and gathers / spills only the K "
                         "sampled rows a round: device memory O(K), "
                         "bit-identical to resident")
    ap.add_argument("--store-dir", default=None, metavar="DIR",
                    help="client-store root (default: a fresh temporary "
                         "directory); reuse it with --ckpt-dir to resume")
    ap.add_argument("--store-eval", default="full", dest="store_eval",
                    choices=("full", "sampled"),
                    help="mmap evaluation scope: full = the population in "
                         "chunks (the resident reports), sampled = the K "
                         "merged clients only")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--telemetry-dir", default=None, metavar="RUN_DIR",
                    help="record the run: manifest.json + one event a "
                         "round in events.jsonl; render with `python -m "
                         "repro_torch.fl.obs summarize RUN_DIR`")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="also write a torch.profiler trace of the run")
    args = ap.parse_args(argv)

    streaming = args.n_clients is not None
    if streaming:
        if args.client_store != "mmap":
            raise SystemExit(
                "--n-clients streams the population on demand — it "
                "requires --client-store mmap (there is no materialized "
                "pool for the resident engine to hold)")
        if args.data_dir is None:
            raise SystemExit("--n-clients needs --data-dir (LEAF shards "
                             "to stream; the mirror writes them)")
        if args.strategy in ("flis_dc", "flis_hc"):
            raise SystemExit(
                "flis_* draws its server probe set from materialized "
                "client data at init — not available on a streamed "
                "population; use --clients instead of --n-clients")
    n_clients = args.n_clients if streaming else args.clients
    participation = args.participation
    if args.active is not None:
        if not 0 < args.active <= n_clients:
            raise SystemExit(f"--active must be in [1, {n_clients}]")
        participation = args.active / n_clients
    n_ranks = None
    if args.mesh is None and args.backend == "shardmap":
        args.mesh = "clients"            # all visible devices
    if args.mesh is not None:
        if args.backend == "inprocess":
            raise SystemExit("--backend inprocess contradicts --mesh")
        name, _, count = args.mesh.partition(":")
        if name != "clients":
            raise SystemExit(f"--mesh must be clients[:N], got {args.mesh!r}")
        n_ranks = mesh_lib.ranks_for(int(count) if count else None,
                                     args.device)
    rt_cfg = RuntimeConfig(
        rounds=args.rounds,
        scheduler=SchedulerConfig(
            participation=participation, sampling=args.sampling,
            dropout=args.dropout, straggler=args.straggler,
            max_staleness=args.max_staleness),
        codec=CodecConfig(args.codec, sparse=args.sparse,
                          error_feedback=args.error_feedback,
                          index_coding=args.index_coding),
        aggregation=args.mode, async_min_uploads=args.async_min_uploads,
        buffer_capacity=args.buffer_capacity,
        staleness_discount=args.staleness_discount,
        async_buffer=args.async_buffer,
        backend="shardmap" if n_ranks is not None else "inprocess",
        mesh_collective=args.collective, tm_backend=args.tm_backend,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        client_store=args.client_store, store_dir=args.store_dir,
        store_eval=args.store_eval, transport=args.transport,
        workers=args.workers)
    # (a streamed population needs the mmap store, which RuntimeConfig
    # refuses under a transport)
    if args.transport != "inprocess" and args.resume:
        raise SystemExit("--resume is an in-process engine feature; "
                         "transport runs restart from round 0")
    if n_ranks is not None:
        # one engine a rank; rank 0 prints, records and checkpoints
        return mesh_lib.spawn(_run, n_ranks, args, argv, rt_cfg,
                              device=args.device)
    return _run(None, args, argv, rt_cfg)


def _run(mesh, args, argv, rt_cfg) -> dict:
    """The run after the flags are checked, in this process or, on a
    clients mesh, on each rank (``mesh``; only rank 0 prints, records
    telemetry and writes checkpoints)."""
    from repro_torch.kernels import ops

    rank0 = mesh is None or mesh.rank == 0
    out_lines = []

    def say(line: str) -> None:
        if rank0:
            print(line, flush=True)

    streaming = args.n_clients is not None
    n_clients = args.n_clients if streaming else args.clients
    launched = dict(ops.LAUNCHES)
    if mesh is not None:
        device = mesh.device
    else:
        device = (devices.default_device() if args.device == "cuda"
                  else devices.resolve(args.device))
    if streaming:
        # the reference's streaming constants: the mirror's 6000 samples
        # at side 12 over 25 writers, the data key PRNGKey(seed + 1),
        # 80 / 40 / 40 samples a client; on a mesh rank 0 fills an empty
        # --data-dir's mirror before the other ranks read it
        with mesh_lib.rank_zero_first(mesh):
            pool = registry.load_stream(
                args.dataset, args.data_dir, encoding=args.encoding,
                n_samples=6000, side=12, seed=args.seed,
                n_writers=args.writers or 25, device=device)
        data = StreamingClientData(
            pool, n_clients=n_clients, n_train=80, n_test=40, n_conf=40,
            key=rnd.PRNGKey(args.seed + 1, device), device=device)
        tm_cfg = tm.TMConfig(n_classes=pool.n_classes,
                             n_clauses=args.clauses,
                             n_features=pool.n_features, n_states=63,
                             s=5.0, T=40)
        fed_cfg = federation.FedConfig(n_clients=n_clients,
                                       rounds=args.rounds,
                                       local_epochs=args.local_epochs)
        strategy = _build_strategy(args.strategy, tm_cfg, fed_cfg, pool,
                                   max_slots=args.max_slots,
                                   probe_size=args.probe_size)
    else:
        # on a mesh rank 0 fills an empty --data-dir's mirror before the
        # other ranks read it
        with mesh_lib.rank_zero_first(mesh):
            data, tm_cfg, fed_cfg, strategy = build_scenario(
                dataset=args.dataset, data_dir=args.data_dir,
                encoding=args.encoding, clients=args.clients,
                clauses=args.clauses, seed=args.seed,
                experiment=args.experiment, writers=args.writers,
                rounds=args.rounds, local_epochs=args.local_epochs,
                strategy=args.strategy, max_slots=args.max_slots,
                probe_size=args.probe_size, device=device)
    telemetry = None
    if (args.telemetry_dir or args.profile_dir) and rank0:
        telemetry = obs.RunRecorder(run_dir=args.telemetry_dir,
                                    profile_dir=args.profile_dir)
    runner = None
    if args.transport != "inprocess":
        from repro_torch.fl.transport import TransportEngine
        spec = None
        if args.transport == "socket":
            # the worker subprocesses rebuild the identical scenario from
            # these knobs on the run's device (build_scenario is
            # deterministic in them)
            spec = {"scenario": dict(
                dataset=args.dataset, data_dir=args.data_dir,
                encoding=args.encoding, clients=args.clients,
                clauses=args.clauses, seed=args.seed,
                experiment=args.experiment, writers=args.writers,
                rounds=args.rounds, local_epochs=args.local_epochs,
                strategy=args.strategy, max_slots=args.max_slots,
                probe_size=args.probe_size, device=str(device))}
        runner = TransportEngine(strategy, data, rt_cfg,
                                 telemetry=telemetry, spec=spec)
        engine = runner.eng
    else:
        engine = Engine(strategy, data, rt_cfg, telemetry=telemetry,
                        mesh=mesh)
    if telemetry is not None:
        telemetry.start(obs.build_manifest(
            config=rt_cfg, seed=args.seed, device=device, mesh=mesh,
            extra={"strategy": args.strategy, "dataset": args.dataset,
                   "encoding": args.encoding, "n_clients": n_clients,
                   "client_store": args.client_store,
                   "rounds": args.rounds,
                   "argv": argv,
                   "collective_payload_bytes":
                       engine.collective_payload_bytes()}))
    state, remaining = None, None
    if args.resume and args.ckpt_dir:
        latest = checkpointing.latest(args.ckpt_dir)
        if latest is not None:
            state = checkpointing.restore(
                latest, engine.init(rnd.PRNGKey(args.seed, device)))
            # complete the originally requested total, don't extend it
            remaining = max(0, args.rounds - int(state.round_idx))
            say(f"resumed from {latest} "
                f"({remaining} of {args.rounds} rounds remaining)")
            if remaining == 0:
                say("nothing to do: run already complete")
                return {"final_accuracy": None, "acc_per_round": [],
                        "upload_bytes": 0,
                        "download_bytes_broadcast": 0,
                        "download_bytes_per_client": 0}
    writer_split = (registry.get(args.dataset).kind == "leaf"
                    and args.data_dir is not None)
    if streaming:
        split = f"streamed ({len(pool.users)} writers, cyclic)"
    elif writer_split:
        split = "writer-natural"
    else:
        split = f"exp{args.experiment}"
    if runner is not None:
        kind = "peers" if args.transport == "loopback" else "processes"
        where = f"{args.transport} transport, {args.workers} worker {kind}"
    elif mesh is None:
        where = "in-process"
    else:
        where = (f"shard_map over {engine.executor.n_shards}-device "
                 f"clients mesh ({args.collective})")
    say(f"{args.strategy} on {args.dataset} "
          f"[{args.encoding}, {tm_cfg.n_features}f, m={tm_cfg.n_clauses}] "
          f"{split}: {n_clients} clients, "
          f"K={engine.scheduler.k}/round, store={args.client_store}, "
          f"dropout={args.dropout}, "
          f"codec={args.codec}{'+sparse' if args.sparse else ''}, "
          f"mode={args.mode}, backend={where}, device={device}")
    if engine.scheduler.p is not None:
        p = engine.scheduler.p
        say(f"weighted sampling from partition sizes: "
            f"p in [{float(p.min()):.4f}, {float(p.max()):.4f}]")
    try:
        if runner is not None:
            state, reports = runner.run(rnd.PRNGKey(args.seed, device))
        else:
            state, reports = engine.run(rnd.PRNGKey(args.seed, device),
                                        state=state, rounds=remaining)
    finally:
        if telemetry is not None:
            telemetry.close()

    up = down_bc = down_pc = st_rd = st_wr = 0
    for rep in reports:
        up += rep.upload_bytes
        down_bc += rep.download_bytes_broadcast
        down_pc += rep.download_bytes_per_client
        st_rd += rep.store_read_bytes
        st_wr += rep.store_written_bytes
        extra = ""
        if args.mode == "async":
            extra = (f" agg={rep.aggregated_uploads}"
                     f" buf={rep.buffered_uploads}"
                     f" evict={rep.evicted_uploads}")
        if runner is not None:
            extra += (f" wire_tx={rep.wire_tx_bytes}B"
                      f" wire_rx={rep.wire_rx_bytes}B")
        out_lines.append(
            f"round {rep.round_idx:3d}: "
            f"acc={float(rep.mean_accuracy):.4f} "
            f"w10%={worst_decile_mean(rep.per_client_accuracy):.4f} "
            f"up={rep.upload_bytes}B "
            f"down_bc={rep.download_bytes_broadcast}B "
            f"down_pc={rep.download_bytes_per_client}B "
            f"active={int(rep.participation.active.sum())}"
            f"/{engine.scheduler.k}{extra}")
        say(out_lines[-1])
    say(f"totals: upload={up}B ({up/1e6:.4f}MB) "
        f"download_broadcast={down_bc}B ({down_bc/1e6:.4f}MB) "
        f"download_per_client={down_pc}B ({down_pc/1e6:.4f}MB)")
    if args.client_store == "mmap" and rank0:
        say(f"client store: read={st_rd}B written={st_wr}B "
            f"({engine.store.written_count()} of {engine.n} rows "
            f"materialized, {engine.store.row_nbytes}B/row)")
    deciles = accuracy_deciles(reports[-1].per_client_accuracy)
    say("final per-client accuracy deciles: "
        + " ".join(f"p{10 * i}={d:.3f}" for i, d in enumerate(deciles)))
    if args.telemetry_dir:
        say(f"telemetry: {args.telemetry_dir} — render with "
            f"`python -m repro_torch.fl.obs summarize "
            f"{args.telemetry_dir}`")
    ran = None
    if mesh is not None:
        # each rank's kernel launches and collective bytes of the run
        launches = {k: ops.LAUNCHES[k] - launched[k] for k in launched}
        per_rank = mesh_lib.gather_object(
            mesh, (launches, mesh.meter.snapshot(), str(mesh.device)))
        ran = {"ranks": mesh.size, "collective": args.collective,
               "backend": mesh.backend,
               "devices": [p[2] for p in per_rank],
               "launches": [p[0] for p in per_rank],
               "meter": [p[1] for p in per_rank],
               "collective_payload_bytes":
                   engine.collective_payload_bytes()}
    return {"final_accuracy": float(reports[-1].mean_accuracy),
            "acc_per_round": [float(r.mean_accuracy) for r in reports],
            "final_accuracy_deciles": deciles,
            "upload_bytes": up, "download_bytes_broadcast": down_bc,
            "download_bytes_per_client": down_pc,
            "store_read_bytes": st_rd, "store_written_bytes": st_wr,
            "reports": reports, "state": state, "round_lines": out_lines,
            "mesh": ran}


if __name__ == "__main__":
    main()
