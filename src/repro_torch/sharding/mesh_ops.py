"""What the model code reads of a model mesh: the current mesh, the
collectives it runs over a mesh's axes (each one a
``torch.autograd.Function`` where a gradient crosses it), a layer's
blocks gathered on use, and the cross entropy and argmax over
vocab-sharded logits.

A mesh here is a :class:`repro_torch.launch.model_mesh.ModelMesh` (one
rank's view of a ``(pod?, data, model)`` grid of ranks), read through
``axis_names``, ``shape``, ``coords``, ``axes``, ``block``, ``group``
and ``meter``; it is built, and the steps run on it, in
:mod:`repro_torch.launch.model_mesh`.

* **The current mesh.** :func:`use_mesh` installs a mesh (and the axes
  the batch is cut over) for the model code, :func:`current_mesh` reads
  it (the counterpart of ``compat.set_mesh`` / ``get_abstract_mesh``);
  ``None`` outside, and then every mesh branch of the model code falls
  through to the one-process code.  An axis of size 1 cuts nothing: a
  branch over it is the one-process code too, so a 1 × 1 mesh computes
  the one-process port's numbers.
* **Parameters gathered on use.**  The model code gathers a layer's
  leaves over the axes in their specs just before the layer runs
  (:func:`gathered`, inside the layer's checkpoint, so a recompute
  gathers again) and drops them after it; the gradient of a gathered
  leaf is summed over the batch axes and cut back to the block
  (:class:`_Leaves`: one collective a dtype a layer each way, every leaf
  of the layer packed into it).
* **Activations.** Every activation is this rank's batch block,
  replicated over ``model``, the layout of the reference's
  ``_constrain_batch_only``.  Where ranks along ``model`` compute
  different parts of one value (vocab columns, experts) the Megatron
  pair joins them: :func:`copy_in` (identity, backward summed over the
  axes) before the split, :func:`reduce_sum` (summed, backward identity)
  or :func:`gather_out` (gathered, backward cut) after it.
  :func:`vocab_ce` is the cross entropy on vocab-sharded logits, with
  its own backward.

Only ``all_gather`` and ``all_reduce`` (sum and max) run here: ``gloo``
lists ``reduce_scatter`` and ``all_to_all`` as CPU-only, so a
reduce-scatter is an ``all_reduce`` cut to the block.  Each collective
is metered into the mesh's ``CollectiveMeter`` under a label.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.sharding import rules


# ---------------------------------------------------------------------------
# The current mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Active:
    mesh: Any
    batch_entry: Any            # the batch's spec entry (None: not cut)


# the mesh the model code runs on: process-wide, not a context variable,
# because a checkpointed layer's recompute runs in autograd's device
# thread on the card, and must see the mesh its forward saw
_ACTIVE: list = [None]


@contextlib.contextmanager
def use_mesh(mesh: Any, batch_entry: Any = "fsdp"):
    """Run the model code on ``mesh`` (``None``: one process).
    ``batch_entry`` is the entry of ``rules.batch_spec`` the batch was
    cut by (``None``: every rank holds the whole batch); the default
    assumes the FSDP axes."""
    if mesh is not None and batch_entry == "fsdp":
        f = rules.fsdp_axes(mesh)
        batch_entry = (f if len(f) > 1 else f[0]) if f else None
    prev = _ACTIVE[0]
    _ACTIVE[0] = None if mesh is None else _Active(mesh, batch_entry)
    try:
        yield mesh
    finally:
        _ACTIVE[0] = prev


def current_mesh() -> Any:
    """The mesh the model code runs on, ``None`` in one process (the
    counterpart of ``compat.get_abstract_mesh``)."""
    act = _ACTIVE[0]
    return None if act is None else act.mesh


def batch_entry() -> Any:
    """The spec entry the current batch is cut by (``None``: whole)."""
    act = _ACTIVE[0]
    return None if act is None else act.batch_entry


def batch_axes() -> tuple[str, ...]:
    """The axes of size > 1 the current batch is cut over."""
    act = _ACTIVE[0]
    return () if act is None else act.mesh.axes(act.batch_entry)


def model_split() -> tuple[int, int]:
    """(ranks along ``model``, this rank's index) of the current mesh;
    (1, 0) without one."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1, 0
    return mesh.shape["model"], mesh.coords["model"]


def is_spec(x: Any) -> bool:
    """A spec: a tuple of entries (``None``, an axis, a tuple of axes)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


# ---------------------------------------------------------------------------
# Collectives, metered
# ---------------------------------------------------------------------------

def _now(t: torch.Tensor) -> float:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def gather_dim(mesh: Any, t: torch.Tensor, dim: int,
               axes: tuple[str, ...], label: str) -> torch.Tensor:
    """The blocks of ``t`` over ``axes``, concatenated along ``dim`` in
    the axes' row-major order."""
    n, _ = mesh.block(axes)
    t0 = _now(t)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim)
    mesh.meter.add(label, out.numel() * out.element_size(),
                   seconds=_now(out) - t0)
    return out


def all_reduce(mesh: Any, t: torch.Tensor, axes: tuple[str, ...],
               label: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axes`` (a new tensor)."""
    t0 = _now(t)
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.group(axes))
    mesh.meter.add(label, out.numel() * out.element_size(),
                   seconds=_now(out) - t0)
    return out


def cut(mesh: Any, t: torch.Tensor, dims) -> torch.Tensor:
    """This rank's block of a whole ``t`` cut along ``dims`` ((dim,
    axes) pairs)."""
    for dim, axes in dims:
        n, i = mesh.block(axes)
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t


def _assemble(mesh: Any, blocks: torch.Tensor, shape, union: tuple,
              mine: dict, todo: tuple, fixed: dict) -> torch.Tensor:
    """One leaf from ``blocks`` (its block from every rank of ``union``,
    a row each in their row-major order): the blocks concatenated along
    the ``todo`` (dim, axes) pairs, along the other axes this rank's own
    coordinates ``mine`` (a module-level function: a recursive closure
    would be a reference cycle holding the gathered buffer until the
    garbage collector runs)."""
    if not todo:
        k = int(np.ravel_multi_index(
            [fixed.get(a, mine[a]) for a in union],
            [mesh.shape[a] for a in union]))
        return blocks[k].view(shape)
    (dim, axes), rest = todo[0], todo[1:]
    parts = []
    for b in range(math.prod(mesh.shape[a] for a in axes)):
        c = np.unravel_index(b, [mesh.shape[a] for a in axes])
        parts.append(_assemble(mesh, blocks, shape, union, mine, rest,
                               {**fixed, **dict(zip(axes, map(int, c)))}))
    return torch.cat(parts, dim=dim)


def _gather_leaves(mesh: Any, shards: list, plans: tuple,
                   label: str) -> list:
    """Each block in ``shards`` gathered along its plan's (dim, axes)
    pairs: one ``all_gather`` a dtype over the union of the axes, every
    rank's blocks packed flat, each leaf reassembled from the blocks of
    the ranks its axes name, along the other axes this rank's own (a
    block kept on ``model`` is this rank's; a replica is any)."""
    out, mine = [None] * len(shards), mesh.coords
    groups: dict = {}
    for i, (s, plan) in enumerate(zip(shards, plans)):
        if plan:
            groups.setdefault(s.dtype, []).append(i)
        else:
            out[i] = s.view_as(s)
    for idx in groups.values():
        union = tuple(a for a in mesh.axis_names
                      if any(a in axes for i in idx for _, axes in plans[i]))
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        every = gather_dim(mesh, flat[None], 0, union, label)
        off = 0
        for i in idx:
            n = shards[i].numel()
            out[i] = _assemble(mesh, every[:, off:off + n], shards[i].shape,
                               union, mine, plans[i], {})
            off += n
    return out


class _Leaves(torch.autograd.Function):
    """A layer's parameter blocks → the tensors it computes with, each
    gathered along its plan's (dim, axes) pairs (:func:`_gather_leaves`:
    one collective a dtype); the backward sums the gradients over the
    batch axes (one ``all_reduce`` a dtype) and cuts each back to its
    block."""

    @staticmethod
    def forward(ctx, mesh, plans, batch, *shards):
        ctx.mesh, ctx.plans, ctx.batch = mesh, plans, batch
        outs = _gather_leaves(mesh, list(shards), plans, "param_gather")
        ctx.whole = [(o.shape, o.dtype, o.device) for o in outs]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=dev) if g is None
                 else g for g, (shape, dtype, dev) in zip(grads, ctx.whole)]
        if ctx.batch:
            groups: dict = {}
            for i, g in enumerate(grads):
                groups.setdefault(g.dtype, []).append(i)
            for idx in groups.values():
                flat = all_reduce(ctx.mesh, torch.cat(
                    [grads[i].reshape(-1) for i in idx]), ctx.batch,
                    "grad_reduce")
                off = 0
                for i in idx:
                    n = grads[i].numel()
                    grads[i] = flat[off:off + n].view(grads[i].shape)
                    off += n
        return (None, None, None, *(
            cut(ctx.mesh, g, plan).contiguous()
            for g, plan in zip(grads, ctx.plans)))


class _ReduceSum(torch.autograd.Function):
    """Partial values summed over ``axes``; the backward is the identity
    (every rank's consumer computes the same gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, label):
        return all_reduce(mesh, t, axes, label)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyIn(torch.autograd.Function):
    """A value replicated over ``axes`` entering rank-distinct work: the
    identity, its backward the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, t, mesh, axes, label):
        ctx.mesh, ctx.axes, ctx.label = mesh, axes, label
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(ctx.mesh, g, ctx.axes, ctx.label), None, None,
                None)


class _GatherOut(torch.autograd.Function):
    """Rank-distinct blocks gathered along ``dim`` over ``axes`` for a
    replicated consumer; the backward cuts this rank's block."""

    @staticmethod
    def forward(ctx, t, mesh, dim, axes, label):
        ctx.mesh, ctx.dims = mesh, ((dim, axes),)
        return gather_dim(mesh, t, dim, axes, label)

    @staticmethod
    def backward(ctx, g):
        return (cut(ctx.mesh, g, ctx.dims).contiguous(), None, None, None,
                None)


def reduce_sum(t: torch.Tensor, axes: tuple[str, ...],
               label: str) -> torch.Tensor:
    """:class:`_ReduceSum` on the current mesh (identity over no axes)."""
    mesh = current_mesh()
    if mesh is None or not axes:
        return t
    return _ReduceSum.apply(t, mesh, axes, label)


def copy_in(t: torch.Tensor, axes: tuple[str, ...],
            label: str) -> torch.Tensor:
    """:class:`_CopyIn` on the current mesh (identity over no axes)."""
    mesh = current_mesh()
    if mesh is None or not axes:
        return t
    return _CopyIn.apply(t, mesh, axes, label)


def gather_out(t: torch.Tensor, dim: int, axes: tuple[str, ...],
               label: str) -> torch.Tensor:
    """:class:`_GatherOut` on the current mesh (identity over no
    axes)."""
    mesh = current_mesh()
    if mesh is None or not axes:
        return t
    return _GatherOut.apply(t, mesh, dim, axes, label)


def reduce_plain(t: torch.Tensor, axes: tuple[str, ...], label: str,
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axes`` with no gradient (counts, maxima)."""
    mesh = current_mesh()
    if mesh is None or not axes:
        return t
    return all_reduce(mesh, t.detach(), axes, label, op)


def gather_plain(t: torch.Tensor, dim: int, axes: tuple[str, ...],
                 label: str) -> torch.Tensor:
    """Every rank's ``t`` over ``axes``, concatenated along ``dim``, with
    no gradient."""
    mesh = current_mesh()
    if mesh is None or not axes:
        return t
    return gather_dim(mesh, t.detach(), dim, axes, label)


def gathered(shards: Any, specs: Any, kept_on_model) -> Any:
    """On the current mesh, each leaf of ``shards`` (blocks, their
    ``specs`` beside them) as the tensor a layer computes with: gathered
    over the axes of its spec, but over ``model`` where
    ``kept_on_model(path, leaf)`` says the model code takes the block.
    Without a mesh, ``shards`` itself."""
    act = _ACTIVE[0]
    if act is None:
        return shards
    mesh, batch = act.mesh, act.mesh.axes(act.batch_entry)
    leaves, plans = [], []

    def plan(path, shard, spec):
        dims = []
        for d, entry in enumerate(spec):
            axes = mesh.axes(entry)
            if "model" in axes and kept_on_model(path, shard):
                axes = tuple(a for a in axes if a != "model")
            if axes:
                dims.append((d, axes))
        leaves.append(shard)
        plans.append(tuple(dims))

    tree.map_with_path(plan, shards, specs)
    it = iter(_Leaves.apply(mesh, tuple(plans), batch, *leaves))
    return tree.map(lambda _: next(it), shards)


# ---------------------------------------------------------------------------
# Trees cut to their specs' blocks
# ---------------------------------------------------------------------------

def _dims(mesh: Any, spec: tuple, ndim: int) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple((d, mesh.axes(e)) for d, e in enumerate(spec)
                 if mesh.axes(e))


def cut_tree(t: Any, specs: Any, mesh: Any) -> Any:
    """Each leaf of ``t`` cut to this rank's block of its spec, a new
    contiguous tensor on the mesh's device.  Every sharded dimension
    must divide its axes (the rules guarantee it for parameters)."""
    def one(x, spec):
        dims = _dims(mesh, spec, x.ndim)
        for dim, axes in dims:
            n, _ = mesh.block(axes)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} "
                                 f"does not divide {axes} ({n})")
        return cut(mesh, x, dims).to(mesh.device, copy=True).contiguous()
    return tree.map(one, t, specs)


def gather_tree(t: Any, specs: Any, mesh: Any,
                label: str = "gather_params") -> Any:
    """The inverse of :func:`cut_tree`: every leaf whole on every rank,
    a new tensor (an uncut leaf too)."""
    def one(x, spec):
        dims = _dims(mesh, spec, x.ndim)
        for dim, axes in dims:
            x = gather_dim(mesh, x, dim, axes, label)
        return x if dims else x.clone()
    return tree.map(one, t, specs)


# ---------------------------------------------------------------------------
# Decode caches cut over ``model``
# ---------------------------------------------------------------------------

def cache_cut(entry: Any) -> tuple[tuple[str, ...], int, int]:
    """How the current mesh cuts one dimension of a decode cache whose
    spec entry under ``rules.cache_specs`` is ``entry``: (the axes of
    size > 1, the number of blocks, this rank's block).  ``((), 1, 0)``
    without a mesh or where the entry cuts nothing: the one-process
    code."""
    mesh = current_mesh()
    if mesh is None or entry is None or not mesh.axes(entry):
        return (), 1, 0
    axes = mesh.axes(entry)
    return (axes, *mesh.block(axes))


def context_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    axes: tuple[str, ...]) -> torch.Tensor:
    """A softmax-weighted sum over a sequence cut over ``axes``, from each
    rank's part over its slots: ``m`` the max of its scores, ``l`` the sum
    of ``exp(s − m)``, ``o`` the unnormalized ``Σ exp(s − m)·v`` (one more
    trailing dimension).  One ``all_reduce`` MAX of the maxima, then one
    ``all_reduce`` SUM of ``l`` and ``o`` rescaled by ``exp(m − max)``,
    packed into one buffer, both metered as ``"context"``; returns
    ``o / l`` whole.  A block whose slots are all masked has ``m`` at the
    mask value, and its rescale ``exp(m − max)`` is 0: its ``S_loc``
    ones in ``l`` drop out."""
    mesh = current_mesh()
    g = all_reduce(mesh, m, axes, "context", dist.ReduceOp.MAX)
    r = torch.exp(m - g)
    lr, orr = l * r, o * r[..., None]
    buf = all_reduce(mesh, torch.cat([lr.reshape(-1), orr.reshape(-1)]),
                     axes, "context")
    l, o = buf[:lr.numel()].view_as(lr), buf[lr.numel():].view_as(orr)
    return o / l[..., None]


# ---------------------------------------------------------------------------
# Cross entropy and argmax over vocab-sharded logits
# ---------------------------------------------------------------------------

class _VocabCE(torch.autograd.Function):
    """Per-position cross entropy of logits whose last dimension is this
    rank's vocab block (first column ``col0``) of a row split over
    ``model``: the log-sum-exp from the local max reduced with MAX, the
    local ``exp`` sum and the label's logit (a masked local gather)
    summed over ``model``.  The backward is the local softmax minus the
    one-hot, on the block, in the order autograd takes the one-process
    form (:func:`repro_torch.models.transformer._ce_rows`)."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, col0):
        m = all_reduce(mesh, logits.detach().amax(dim=-1), ("model",),
                       "vocab", dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = all_reduce(mesh, e.sum(dim=-1), ("model",), "vocab")
        lse = torch.log(s) + m
        width = logits.shape[-1]
        loc = labels.long() - col0
        mine = (loc >= 0) & (loc < width)
        idx = loc.clamp(0, width - 1)[..., None]
        lt = torch.where(mine, torch.gather(logits, -1, idx)[..., 0],
                         torch.zeros((), dtype=logits.dtype,
                                     device=logits.device))
        lt = all_reduce(mesh, lt, ("model",), "vocab")
        ctx.save_for_backward(e, s, idx, mine)
        return lse - lt

    @staticmethod
    def backward(ctx, g):
        e, s, idx, mine = ctx.saved_tensors
        d = (g / s)[..., None] * e
        d = d.scatter_add(-1, idx, torch.where(mine, -g, 0.0)[..., None])
        return d, None, None, None


def vocab_ce(logits: torch.Tensor, labels: torch.Tensor,
             col0: int) -> torch.Tensor:
    """:class:`_VocabCE` on the current mesh."""
    return _VocabCE.apply(logits, labels, current_mesh(), col0)


def vocab_argmax(logits: torch.Tensor, col0: int) -> torch.Tensor:
    """``argmax`` over the whole row of vocab-sharded logits, the lowest
    index on ties, as ``jnp.argmax``: each rank's largest value and its
    first index, gathered over ``model``; the first rank holding the
    largest value holds the lowest index."""
    mesh = current_mesh()
    idx = logits.argmax(dim=-1, keepdim=True)
    both = torch.cat([torch.gather(logits, -1, idx).double(),
                      (idx + col0).double()], dim=-1)
    every = gather_dim(mesh, both[None], 0, ("model",), "vocab")
    best = every[..., 0].argmax(dim=0, keepdim=True)
    return torch.gather(every[..., 1], 0, best)[0].long()
