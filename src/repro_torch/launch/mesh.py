"""The clients mesh on ``torch.distributed``: a process group whose ranks
each hold one block of a round's clients.

Counterpart of ``repro/launch/mesh.py``'s :func:`make_clients_mesh`, the
mesh ``fed_train --mesh clients:N`` and ``RuntimeConfig(backend=
"shardmap")`` run on.  Where the reference shards one program over N
devices of one process, the port runs N processes, one engine each
(SPMD: the same engine from the same seed on every rank), joined in a
``clients`` group:

* on GPUs, ``nccl``, one rank per visible card (``cuda:<rank>``); a
  request for more ranks than cards is refused, as the reference refuses
  more devices than are visible, and a missing NCCL is an error, never a
  quiet ``gloo``;
* on the CPU (``device="cpu"``), ``gloo`` over N processes, the
  counterpart of the reference's ``--xla_force_host_platform_device_count``
  virtual devices;
* ``shared_device=True`` puts every rank on ``cuda:0`` in a ``gloo``
  group (NCCL refuses two ranks on one card): several ranks on the one
  card a machine may have.  Only the tests and ``chip_smoke.py`` ask for
  it; it is no CLI flag.  PyTorch's backend table lists ``gloo``'s
  ``all_gather`` as CPU-only, so :func:`make_clients_mesh` tries each
  collective the executor runs on the card and raises, naming it, if
  the group refuses it: no collective is quietly routed through the
  host.

:func:`spawn` starts the ranks (start method ``spawn``, joined from a
``file://`` store in a temporary directory, so no TCP port is fixed),
builds the kernel libraries once before that on a GPU, runs ``fn(mesh,
*args)`` on every rank and returns rank 0's result.  A rank that fails
fails the run: ``torch.multiprocessing.spawn(..., join=True)`` raises
its error in the caller.  :func:`run_federations` runs engine jobs on
the mesh (the library path the tests and ``chip_smoke.py`` drive).

The model scaffold's meshes, :func:`make_production_mesh` and
:func:`make_host_mesh`, are shapes only (:class:`MeshShape`: axis names
and sizes, no device and no process group): the sharding rules and the
dry run (:mod:`repro_torch.launch.dryrun`) price a world of devices
from them without holding one.  The hardware constants the dry run's
roofline reads stand at the end: the H100's, and the reference's TPU
v5e ones under their own names.  The reference's
``repro/sharding/compat.py`` (shims over jax versions' mesh APIs) has no
counterpart: nothing here calls jax.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as devices
from repro_torch.fl.masked_collectives import CollectiveMeter

AXIS = "clients"
# the collectives a mesh runs, each probed on CUDA tensors under gloo:
# the clients mesh's three, and the model mesh's MAX reduction and
# bfloat16 parameter gathers and gradient sums
_OPS = ("all_gather", "all_reduce", "broadcast", "all_reduce_max",
        "all_gather_bf16", "all_reduce_bf16")


@dataclasses.dataclass
class ClientsMesh:
    """One rank's view of the ``clients`` group."""

    group: Any                  # torch.distributed process group
    rank: int                   # this rank in the group
    size: int                   # ranks (shards) in the group
    device: torch.device        # where this rank computes
    backend: str                # "nccl" | "gloo"
    src: int                    # global rank of the group's rank 0
    meter: CollectiveMeter = dataclasses.field(
        default_factory=CollectiveMeter)

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS: self.size}

    def __repr__(self):
        return (f"ClientsMesh({AXIS}={self.size}, rank {self.rank}, "
                f"{self.backend} on {self.device})")


def ranks_for(n_devices: int | None, device, shared_device: bool = False
              ) -> int:
    """The number of ranks of a mesh of ``n_devices`` (``None``: every
    visible device; the CPU counts as one) on ``device``'s kind, with
    the reference's refusal of more devices than are visible."""
    device = torch.device(device)
    if device.type != "cuda":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"requested {n_devices} mesh ranks")
        return n
    devices.default_device()            # raises without a card
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n < 1 or (n > visible and not shared_device):
        raise ValueError(
            f"requested {n_devices} mesh devices but {visible} are visible "
            f"(one rank per GPU; --device cpu runs the ranks as gloo "
            f"processes on the CPU)")
    if not shared_device and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL: a clients mesh on GPUs "
                           "needs it")
    return n


def _check_collectives(group, rank: int, size: int, src: int,
                       device: torch.device) -> None:
    """Run each collective a mesh uses on a small tensor on
    ``device`` and check its result; raise, naming the collective, where
    the group refuses the tensor or gets it wrong."""
    for op in _OPS:
        dtype = torch.bfloat16 if op.endswith("_bf16") else torch.float32
        t = torch.full((2,), float(rank + 1), device=device, dtype=dtype)
        try:
            if op.startswith("all_gather"):
                parts = [torch.empty_like(t) for _ in range(size)]
                dist.all_gather(parts, t, group=group)
                ok = all(bool((p == i + 1).all())
                         for i, p in enumerate(parts))
            elif op == "all_reduce_max":
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
                ok = bool((t == size).all())
            elif op.startswith("all_reduce"):
                dist.all_reduce(t, group=group)
                ok = bool((t == size * (size + 1) / 2).all())
            else:
                dist.broadcast(t, src=src, group=group)
                ok = bool((t == 1).all())
        except (RuntimeError, ValueError, NotImplementedError) as e:
            raise RuntimeError(
                f"the clients group's {dist.get_backend(group)} backend "
                f"does not run {op} on {device} tensors: {e}") from e
        if not ok:
            raise RuntimeError(
                f"the clients group's {dist.get_backend(group)} backend "
                f"ran {op} on {device} tensors with a wrong result")


def make_clients_mesh(n_devices: int | None = None,
                      device=None) -> ClientsMesh | None:
    """Join the ``clients`` group of the first ``n_devices`` ranks
    (``None``: all) of the initialized default group; every rank of the
    default group calls it.  Returns this rank's :class:`ClientsMesh`,
    or ``None`` on a rank outside the group.  ``device`` is where this
    rank computes (default: its card under NCCL, else the CPU)."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n < 1 or n > world:
        raise ValueError(f"requested {n_devices} mesh devices but {world} "
                         f"ranks are running")
    group = dist.new_group(list(range(n))) if n < world \
        else dist.group.WORLD
    rank = dist.get_rank()
    if rank >= n:
        return None
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    src = dist.get_global_rank(group, 0) if n < world else 0
    if backend == "gloo" and device.type == "cuda":
        _check_collectives(group, rank, n, src, device)
    return ClientsMesh(group=group, rank=rank, size=n, device=device,
                       backend=backend, src=src)


def _rank_main(rank: int, fn, args: tuple, world: int, store: str,
               out: str, device: str, shared_device: bool,
               threads: int | None) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if shared_device else rank)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and not shared_device else "gloo"
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = make_clients_mesh(world, device=dev)
        result = fn(mesh, *args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, *args, device="cuda",
          shared_device: bool = False):
    """Run ``fn(mesh, *args)`` on ``n_ranks`` new processes joined in a
    clients mesh on ``device``'s kind (see the module docstring) and
    return rank 0's result.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function); tensors in ``args`` travel through shared
    memory.  On the CPU the ranks share out this process's intra-op
    threads."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    n_ranks = ranks_for(n_ranks, device, shared_device)
    threads = None
    if device.type == "cuda":
        # every rank loads the kernel libraries: build them once, here
        from repro_torch.kernels import _build
        _build.build()
    else:
        threads = max(1, torch.get_num_threads() // n_ranks)
    with tempfile.TemporaryDirectory(prefix="clients_mesh_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.spawn(_rank_main, args=(fn, args, n_ranks,
                                   os.path.join(tmp, "store"), out,
                                   device.type, shared_device, threads),
                 nprocs=n_ranks, join=True)
        return torch.load(out, weights_only=False)


@contextlib.contextmanager
def rank_zero_first(mesh: ClientsMesh | None):
    """Rank 0 runs the block before the other ranks start it: what it
    writes (a dataset mirror it fills on first use) is whole before they
    read it.  No-op without a mesh."""
    if mesh is not None and mesh.rank != 0:
        dist.barrier(group=mesh.group)
    yield
    if mesh is not None and mesh.rank == 0:
        dist.barrier(group=mesh.group)


def gather_object(mesh: ClientsMesh, obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def run_federations(mesh: ClientsMesh, jobs: list[dict]) -> list[dict] | None:
    """Run each job on the mesh, in order, and return rank 0's results
    (``None`` on the other ranks).  A job is a dict: ``strategy``,
    ``data`` (a ``ClientData``, moved to the rank's device), ``config``
    (a ``RuntimeConfig`` with ``backend="shardmap"``) and ``seed`` (the
    run's ``PRNGKey``).  A result holds the final ``state``, the
    ``reports``, the round ``events`` rank 0 recorded (phases by span
    name), ``seconds`` (the run's wall time on rank 0, synced), each
    rank's kernel ``launches``, collective ``meter`` and ``devices`` of
    the run, the group's ``backend``, the engine's
    ``collective_payload_bytes`` and, over the mmap store, the
    ``population`` gathered back from it."""
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.fl.obs import RunRecorder
    from repro_torch.fl.runtime import Engine
    from repro_torch.kernels import ops

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    results = []
    for job in jobs:
        data = tree.map(lambda a: a.to(mesh.device), job["data"])
        rec = RunRecorder() if mesh.rank == 0 else None
        engine = Engine(job["strategy"], data, job["config"], mesh=mesh,
                        telemetry=rec)
        before = dict(ops.LAUNCHES)
        mesh.meter.reset()
        sync()
        t = time.perf_counter()
        state, reports = engine.run(rnd.PRNGKey(job["seed"], mesh.device))
        sync()
        seconds = time.perf_counter() - t
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        per_rank = gather_object(mesh, (launches, mesh.meter.snapshot(),
                                        str(mesh.device)))
        population = None
        if engine.store is not None:
            population = engine.store.gather(np.arange(engine.n))
        if mesh.rank == 0:
            results.append(dict(
                state=state, reports=reports, events=rec.history,
                seconds=seconds, launches=[p[0] for p in per_rank],
                meter=[p[1] for p in per_rank],
                devices=[p[2] for p in per_rank], backend=mesh.backend,
                collective_payload_bytes=engine.collective_payload_bytes(),
                population=population))
    return results if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# The model scaffold's meshes: shapes only
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices: what the sharding
    rules read (``axis_names``, ``shape``), as a ``ClientsMesh`` exposes
    its ``shape``."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes, dtype=np.int64))

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """Single-device mesh (same axis names)."""
    return MeshShape(("data", "model"), (1, 1))


# NVIDIA H100 SXM5 80GB constants (per card), from NVIDIA's H100 Tensor
# Core GPU datasheet at the 700 W power limit: dense bf16 tensor-core
# rate (1,979 TFLOP/s is the 2:4-sparse figure), HBM3 bandwidth.
H100_PEAK_FLOPS_BF16 = 989e12     # FLOP/s
H100_HBM_BW = 3.35e12             # B/s
# Links for the collective term, per card and direction.  NVLink 4: 18
# links, 900 GB/s both ways, among the 8 cards of one HGX/DGX H100 node.
# A 256- or 512-card world crosses nodes over InfiniBand: one 400 Gb/s
# NDR port (ConnectX-7) per GPU, as in NVIDIA's DGX H100 reference
# architecture (DGX SuperPOD).
H100_NVLINK_BW = 450e9            # B/s
H100_NDR_BW = 400e9 / 8           # B/s
H100_NODE_GPUS = 8                # cards an NVLink domain joins

# The reference's TPU v5e constants (per chip), as
# ``repro/launch/mesh.py`` states them; nothing in the port reads them.
PEAK_FLOPS_BF16 = 197e12          # FLOP/s
HBM_BW = 819e9                    # B/s
ICI_BW = 50e9                     # B/s per link
