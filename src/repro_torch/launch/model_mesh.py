"""The model mesh: the model scaffold's train, prefill and serve steps
run across ``torch.distributed`` ranks, each rank holding its block of
the parameters as the sharding rules cut them.

The reference runs its steps as one ``jax.jit`` program on a device mesh
(``compat.set_mesh`` with parameters laid out by ``rules.param_specs``),
and XLA partitions it.  The port runs one process a device and does the
partitioning by hand:

* **The grid** (:class:`ModelMesh`).  A ``(pod?, data, model)`` grid over
  the ranks :func:`repro_torch.launch.mesh.spawn` starts, rank ``r`` at
  the row-major coordinates of ``r`` (a jax ``Mesh`` over devices
  reshaped the same way).  :func:`make_model_mesh` creates one process
  group a line of every non-empty set of axes, every rank creating every
  group in the same order; a collective over a set of axes runs on this
  rank's line of that set, its ranks in row-major order, the order the
  reference's blocks take on a dimension a tuple of axes cuts.  It
  answers ``axis_names`` and ``shape`` as ``MeshShape`` does, so
  :mod:`repro_torch.sharding.rules` reads it unchanged.
* **Devices.** On one card every rank computes on ``cuda:0`` in a
  ``gloo`` group (``shared_device=True``: NCCL refuses two ranks on one
  card); with several cards NCCL, one rank a card; on the CPU ``gloo``.
  The mesh uses ``all_gather``, ``all_reduce`` (sum and max) and
  ``broadcast``, nothing else: ``gloo``'s backend table lists
  ``reduce_scatter`` and ``all_to_all`` as CPU-only, so a reduce-scatter
  is an ``all_reduce`` cut to the block, and the expert-parallel
  dispatch needs no all-to-all (its tokens are replicated over
  ``model``, :mod:`repro_torch.models.moe`).  A ``gloo`` group on CUDA
  tensors is probed for each of them, in float32 and bfloat16, when the
  mesh is built (``mesh._check_collectives``), and a refusal raises,
  naming the collective: nothing is quietly routed through the host but
  what ``gloo`` itself stages there.
* **Parameters held as their shards.** :func:`shard_params` cuts each
  leaf to this rank's block of ``rules.param_specs`` (the arithmetic of
  ``steps.AbstractArray.shard_shape``: one rank's bytes are the dry
  run's ``argument_bytes``), :func:`gather_params` rebuilds whole trees.
  Not gathered on ``model`` when a layer runs: the LM head's vocab
  columns, the tied embedding's vocab rows and, under
  ``REPRO_SHARD_MOE=1`` with ``"ep"``, the expert banks
  (``transformer._kept_on_model``).
* **Decode caches held as their blocks.** The decode job allocates this
  rank's blocks of ``rules.cache_specs`` and nothing more
  (:func:`repro_torch.launch.steps.cache_blocks`: one rank's bytes are
  the dry run's): the batch over the FSDP axes, the KV, int8-KV and MLA
  caches' sequence and the Mamba and xLSTM state's features over
  ``model`` where it divides them.  The model code decodes on those
  blocks (context parallelism: the attention's softmax split over the
  sequence's blocks, the recurrent contractions over a cut axis summed).
* **What the model code reads** (the current mesh, the collectives, a
  layer's blocks gathered on use, the vocab-parallel cross entropy, the
  context-parallel softmax) is :mod:`repro_torch.sharding.mesh_ops`,
  below the model code.

:func:`run_steps` runs jobs on a world (the library path the tests and
``chip_smoke.py`` drive, as ``mesh.run_federations`` is); there is no
CLI flag, as the reference's ``launch/train.py`` and ``serve.py`` have
no mesh flag.  Each collective is metered into the mesh's
``CollectiveMeter`` under a label: ``param_gather``, ``grad_reduce``,
``vocab`` (the CE's and the argmax's reductions over ``model``),
``batch`` (loss and router statistics over the batch axes), ``experts``
(the expert-parallel outputs), ``norm`` (the clipping norm),
``context`` (decode over caches cut over ``model``: the softmax's max
and sums, the recurrent state's partial products, gathered blocks).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.fl.masked_collectives import CollectiveMeter
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.sharding import mesh_ops, rules

AXES = ("pod", "data", "model")


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelMesh:
    """One rank's view of a ``(pod?, data, model)`` grid of ranks."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int                   # this rank's row-major index in the grid
    device: torch.device        # where this rank computes
    backend: str                # "nccl" | "gloo"
    groups: dict                # axes (mesh order) -> this rank's line
    meter: CollectiveMeter = dataclasses.field(
        default_factory=CollectiveMeter)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank,
                                                          self.sizes))))

    def axes(self, entry) -> tuple[str, ...]:
        """A spec entry's axes of size > 1, in mesh order."""
        if entry is None:
            return ()
        names = entry if isinstance(entry, tuple) else (entry,)
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def block(self, axes: tuple[str, ...]) -> tuple[int, int]:
        """(number of blocks, this rank's block) of a dimension cut over
        ``axes``, row-major over them (a tuple entry's order)."""
        n, i, c = 1, 0, self.coords
        for a in axes:
            n, i = n * self.shape[a], i * self.shape[a] + c[a]
        return n, i

    def group(self, axes: tuple[str, ...]):
        return self.groups[tuple(a for a in self.axis_names if a in axes)]

    def __repr__(self):
        grid = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return (f"ModelMesh({grid}, rank {self.rank}, {self.backend} on "
                f"{self.device})")


def make_model_mesh(axis_names, sizes, device=None) -> ModelMesh | None:
    """Join a grid of ``prod(sizes)`` ranks, the first ones of the
    initialized default group; every rank of the default group calls it
    (it creates the process groups).  Returns this rank's
    :class:`ModelMesh`, ``None`` on a rank outside the grid.  ``device``
    is where this rank computes (default: its card under NCCL, else the
    CPU)."""
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    if len(axis_names) != len(sizes) or any(
            a not in AXES for a in axis_names) or "model" not in axis_names:
        raise ValueError(f"a model mesh is (pod?, data, model), not "
                         f"{axis_names}")
    n, world, me = math.prod(sizes), dist.get_world_size(), dist.get_rank()
    if n < 1 or n > world:
        raise ValueError(f"a {sizes} grid needs {n} ranks, {world} run")
    coords = [np.unravel_index(r, sizes) for r in range(n)]
    groups = {}
    for k in range(1, len(axis_names) + 1):
        for subset in itertools.combinations(range(len(axis_names)), k):
            rest = [i for i in range(len(axis_names)) if i not in subset]
            for fixed in itertools.product(*(range(sizes[i])
                                              for i in rest)):
                ranks = [r for r in range(n)
                         if all(coords[r][i] == f
                                for i, f in zip(rest, fixed))]
                g = dist.group.WORLD if len(ranks) == world \
                    else dist.new_group(ranks)
                if me in ranks:
                    groups[tuple(axis_names[i] for i in subset)] = g
    if me >= n:
        return None
    whole = groups[axis_names]
    backend = dist.get_backend(whole)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if backend == "gloo" and device.type == "cuda":
        src = dist.get_global_rank(whole, 0) if n < world else 0
        mesh_lib._check_collectives(whole, dist.get_rank(whole), n, src,
                                    device)
    return ModelMesh(axis_names=axis_names, sizes=sizes, rank=me,
                     device=device, backend=backend, groups=groups)


# ---------------------------------------------------------------------------
# Parameters held as their shards
# ---------------------------------------------------------------------------

def shard_params(params: Any, mesh: ModelMesh,
                 moe_sharding: str = "ep") -> Any:
    """This rank's block of every parameter under
    ``rules.param_specs``."""
    return mesh_ops.cut_tree(
        params, rules.param_specs(params, mesh, moe_sharding), mesh)


def gather_params(shards: Any, cfg, mesh: ModelMesh) -> Any:
    """Whole parameters (or a tree like them: gradients, moments) from
    every rank's blocks, on every rank."""
    return mesh_ops.gather_tree(shards, transformer.param_specs(cfg, mesh),
                                mesh)


# ---------------------------------------------------------------------------
# Jobs on a world of ranks
# ---------------------------------------------------------------------------

def _nbytes(t: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@contextlib.contextmanager
def _environ(env: dict):
    """``env``'s variables set for the block (``None`` unsets one)."""
    prev = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _job(mesh: ModelMesh, job: dict) -> tuple[dict, dict]:
    """One job on ``mesh``: (the whole results, every rank holds them;
    this rank's figures)."""
    cfg, dev = job["cfg"], mesh.device
    opt_cfg = job.get("opt", adamw.AdamWConfig())
    shape = mesh_lib.MeshShape(mesh.axis_names, mesh.sizes)
    out, mine = {}, {"device": str(dev), "meter": {}}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def phase(name, t0):
        mine["meter"][name] = mesh.meter.snapshot()
        mesh.meter.reset()
        mine[f"{name}_s"] = _sync(dev) - t0
        if dev.type == "cuda":
            mine.setdefault("peak_by_phase", {})[name] = \
                torch.cuda.max_memory_allocated(dev)

    def cast(t):
        if job.get("dtype") is None:
            return t
        return tree.map(lambda a: a.to(job["dtype"])
                        if a.is_floating_point() else a, t)

    t0 = _sync(dev)
    # cut, then cast: each rank casts only its blocks
    params = cast(shard_params(job["params"], mesh,
                               cfg.moe.sharding if cfg.moe else "ep"))
    phase("shard", t0)
    mine["shard_shapes"] = [tuple(x.shape) for x in tree.leaves(params)]

    if "grads" in job:
        tok, lab = job["grads"]["tokens"], job["grads"]["labels"]
        with steps.on_mesh(mesh, tok.shape[0]):
            loss, _, grads = steps.value_and_grad(
                lambda p: transformer.lm_loss(
                    p, cfg, steps.cut_batch(mesh, tok.to(dev)),
                    steps.cut_batch(mesh, lab.to(dev))), params)
        out["grad_loss"] = float(loss)
        out["grads"] = gather_params(grads, cfg, mesh)
        del grads

    if "prefill" in job:
        tok = job["prefill"].to(dev)
        t0 = _sync(dev)
        blk = steps.make_prefill_step(cfg, mesh=mesh)(params, {"tokens": tok})
        phase("prefill", t0)
        out["prefill"] = _whole_logits(mesh, cfg, blk, tok.shape[0])

    if "decode" in job:
        dec = job["decode"]
        prompt, n = dec["prompt"].to(dev), dec["steps"]
        window = dec.get("window", 0)
        B, P = prompt.shape
        slots = dec.get("max_len", P + n)
        caches, specs = steps.cache_blocks(cfg, mesh, B, slots, window)
        caches = cast(caches)
        cache_abs = tree.leaves(steps.abstract_cache(cfg, shape, B, slots,
                                                     window),
                                is_leaf=steps.is_abstract)
        logits, toks, mine["decode_s"] = [], [], []
        fed = prompt[:, :1]
        for t in range(P + n):
            if dev.type == "cuda":      # a step's own peak, and the job's
                mine["peak"] = max(mine.get("peak", 0),
                                   torch.cuda.max_memory_allocated(dev))
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = _sync(dev)
            with torch.no_grad():
                lg, nxt, caches = steps.serve_logits(
                    cfg, params, fed, caches, window, mesh, specs)
            mine["decode_s"].append(_sync(dev) - t0)
            if dev.type == "cuda":
                mine.setdefault("decode_memory", []).append(
                    (torch.cuda.memory_allocated(dev),
                     torch.cuda.max_memory_allocated(dev)))
            logits.append(_whole_logits(mesh, cfg, lg[:, 0], B))
            if t + 1 < P:
                fed = prompt[:, t + 1:t + 2]
            else:
                fed = nxt.to(prompt.dtype)
                toks.append(nxt)
        # what the last step left, against the dry run's blocks at the
        # held dtypes (the dry run's own bytes where those are the init's)
        mine["cache_bytes"] = {
            "held": _nbytes(caches),
            "dryrun": sum(math.prod(a.shard_shape) * h.element_size()
                          for a, h in zip(cache_abs, tree.leaves(caches),
                                          strict=True))}
        mine["cache_shapes"] = [tuple(h.shape) for h in tree.leaves(caches)]
        out["decode_logits"] = torch.stack(logits, 1)
        out["tokens"] = torch.cat(toks, 1)
        mine["meter"]["decode"] = mesh.meter.snapshot()
        mesh.meter.reset()
        if dec.get("gather_caches"):
            out["caches"] = mesh_ops.gather_tree(caches, specs, mesh,
                                                 "result")
        del caches
    if "train" in job:
        tr = job["train"]
        batch = {k: tr[k].to(dev) for k in ("tokens", "labels")}
        opt = adamw.init(params, opt_cfg)
        ins = steps.input_specs(
            cfg, steps.ShapeSpec("mesh", batch["tokens"].shape[1],
                                 batch["tokens"].shape[0], "train"),
            shape, opt_cfg)
        local = {k: steps.cut_batch(mesh, v) for k, v in batch.items()}
        mine["bytes"] = {"params": _nbytes(params), "opt": _nbytes(opt),
                         "batch": _nbytes(local),
                         "dryrun": dryrun.argument_bytes(ins, "train")}
        mine["analytic_collectives"] = dryrun.fsdp_collectives(
            ins["params"], shape, "train")
        step = steps.make_train_step(cfg, opt_cfg, mesh=mesh)
        out["metrics"], mine["step_s"], out["params"] = [], [], []
        for _ in range(tr.get("steps", 1)):
            t0 = _sync(dev)
            params, opt, metrics = step(params, opt, batch)
            mine["step_s"].append(_sync(dev) - t0)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            mine["meter"][f"step{len(mine['step_s'])}"] = \
                mesh.meter.snapshot()
            mesh.meter.reset()
            if job.get("gather_params"):
                out["params"].append(gather_params(params, cfg, mesh))
        del opt

    if dev.type == "cuda":
        mine["peak"] = max(mine.get("peak", 0),
                           torch.cuda.max_memory_allocated(dev))
    return out, mine


def _whole_logits(mesh: ModelMesh, cfg, blk: torch.Tensor,
                  batch: int) -> torch.Tensor:
    """Whole (B, V) logits from every rank's (batch, vocab) block."""
    with mesh_ops.use_mesh(mesh, rules.batch_spec(mesh, batch)[0]):
        if transformer._constrain_logits(cfg):
            blk = mesh_ops.gather_plain(blk, blk.ndim - 1, ("model",),
                                        "result")
        return mesh_ops.gather_plain(blk, 0, mesh_ops.batch_axes(),
                                     "result")


def run_steps(world, jobs: list[dict]) -> list[dict] | None:
    """Run each job on a grid of the world's ranks, in order, and return
    rank 0's results (``None`` on the other ranks).  ``world`` is the
    clients mesh :func:`repro_torch.launch.mesh.spawn` hands each rank.

    A job is a dict: ``mesh`` (axis names and sizes; the first ranks of
    the world form the grid, the rest skip the job), ``cfg`` (a
    ``ModelConfig``), ``params`` (the whole parameters on any device:
    each rank cuts its blocks), and optionally ``dtype`` (floating leaves
    cast to it first), ``env`` (environment variables set for the job:
    ``REPRO_SHARDED_CE``, ``REPRO_SHARD_MOE``), ``opt`` (an
    ``AdamWConfig``), ``grads`` (whole ``tokens`` and ``labels``: the
    loss and gradients at the initial parameters), ``train``
    (``tokens``, ``labels``, ``steps``: train steps from fresh
    moments), ``gather_params`` (the parameters after
    each, whole), ``prefill`` (whole tokens: the last position's
    logits) and ``decode`` (``prompt`` (B, P) fed a token a step, then
    ``steps`` greedy steps, on caches of ``max_len`` slots (default
    P + steps) held as this rank's blocks of ``rules.cache_specs``,
    optionally with a ``window`` and ``gather_caches``: every step's
    logits, the tokens, and the last caches whole).  A result holds those whole
    (``grad_loss``, ``grads``, ``metrics``, ``params``, ``prefill``,
    ``decode_logits``, ``tokens``, ``caches``) and ``ranks``: each
    rank's device, shard shapes, bytes held beside the dry run's
    ``argument_bytes``, the cache blocks' shapes and bytes after the last
    decode step beside the dry run's, the dry run's analytic collective
    bytes, peak device memory (on the card also ``memory_allocated`` and
    the peak of each decode step), seconds of each phase and step, and
    collective bytes by label a phase and step."""
    meshes: dict = {}
    results = []
    for job in jobs:
        names, sizes = job["mesh"]
        key = (tuple(names), tuple(sizes))
        if key not in meshes:
            meshes[key] = make_model_mesh(names, sizes, world.device)
        mesh = meshes[key]
        if mesh is None:
            continue
        with _environ(job.get("env", {})):
            out, mine = _job(mesh, job)
        every = [None] * mesh.size
        dist.all_gather_object(every, mine, group=mesh.group(
            tuple(mesh.axis_names)))
        if mesh.rank == 0:
            out["ranks"] = every
            results.append(out)
    return results if world.rank == 0 else None
