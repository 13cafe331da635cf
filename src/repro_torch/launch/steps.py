"""Train / prefill / serve steps for the model scaffold, and their
abstract inputs.

Counterpart of ``repro/launch/steps.py``.  The steps are eager PyTorch,
the gradient through autograd (the attention's backward is the blockwise
one, :class:`repro_torch.models.attention._Flash`).  The abstract inputs
(:func:`abstract_params`, :func:`abstract_opt_state`,
:func:`abstract_cache`, :func:`input_specs`) are the reference's trees
(dicts, ``AdamWState(step, m, v)``, lists of cache named tuples), built
by the port's own ``init`` / ``adamw.init`` / ``init_cache`` on the
``meta`` device, so nothing is allocated; each leaf is an
:class:`AbstractArray`, a ``meta`` tensor with its spec on a mesh (the
reference's ``ShapeDtypeStruct`` with a ``NamedSharding``).  The dry run
(:mod:`repro_torch.launch.dryrun`) prices them.

Given a :class:`~repro_torch.launch.model_mesh.ModelMesh` (``mesh=``),
the steps run on it (:mod:`repro_torch.sharding.mesh_ops`): the
parameters and moments are this rank's blocks
(:func:`~repro_torch.launch.model_mesh.shard_params`), the batch is the
whole batch, which the step cuts by ``rules.batch_spec``, the loss and
the clipping norm are the whole batch's and the whole tree's, and AdamW
updates each block in place.  The prefill step returns this rank's
block of the last position's logits (batch over the FSDP axes, vocab
over ``model``); the serve step takes this rank's block of the decode
caches under ``rules.cache_specs`` (:func:`cache_blocks`: the batch over
the FSDP axes, the KV and latent caches' sequence and the recurrent
state's features over ``model``, each where its axes divide it; the
model code splits the attention's softmax over the sequence's blocks)
and returns the whole batch's next tokens, a distributed argmax.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import mesh_ops, rules


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def needs_window(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """long_500k on pure-attention archs runs the sliding-window serve
    variant; 0 = native/full attention."""
    if shape.name == "long_500k":
        return cfg.long_window
    return 0


def value_and_grad(loss_fn: Callable[[Any], tuple[torch.Tensor, dict]],
                   params: Any) -> tuple[torch.Tensor, dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)``: the loss,
    its aux dict (detached) and the gradient tree, each leaf in its
    parameter's dtype (zeros where the loss does not reach it)."""
    leaves = tree.map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, parts = loss_fn(leaves)
        grads = torch.autograd.grad(loss, tree.leaves(leaves),
                                    allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree.map(lambda _: next(it), params))


def cut_batch(mesh: Any, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole batch tensor under
    ``rules.batch_spec`` (the whole tensor without a mesh)."""
    if mesh is None:
        return t
    return mesh_ops.cut_tree(t, rules.batch_spec(mesh, t.shape[0]), mesh)


def on_mesh(mesh: Any, batch: int):
    """The model code on ``mesh`` with a batch of ``batch`` rows cut by
    ``rules.batch_spec``."""
    if mesh is None:
        return mesh_ops.use_mesh(None)
    return mesh_ops.use_mesh(mesh, rules.batch_spec(mesh, batch)[0])


def _grad_norm(grads: Any, specs: Any, mesh: Any) -> torch.Tensor:
    """The global norm of a sharded gradient tree: each leaf's sum of
    squares summed over the axes that cut it (one ``all_reduce`` a set
    of axes), then added up in leaf order, as ``adamw._global_norm``
    adds whole leaves."""
    pairs: list = []
    tree.map(lambda g, spec: pairs.append((g, spec)), grads, specs)
    sq, cut_by = [], []
    for g, spec in pairs:
        sq.append(sum(torch.sum(torch.square(g[sl].float()))
                      for sl in adamw._slices(g)))
        cut_by.append(tuple(a for a in mesh.axis_names
                            if any(a in mesh.axes(e) for e in spec)))
    for axes in sorted(set(cut_by)):
        if not axes:
            continue
        at = [i for i, c in enumerate(cut_by) if c == axes]
        summed = mesh_ops.all_reduce(mesh, torch.stack([sq[i] for i in at]),
                                     axes, "norm")
        for j, i in enumerate(at):
            sq[i] = summed[j]
    total = 0
    for s in sq:
        total = total + s
    return torch.sqrt(total)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    mesh: Any = None) -> Callable:
    """The step updates the parameters and moments in their tensors
    (:func:`repro_torch.optim.adamw.update`); on ``mesh`` each rank's
    blocks."""
    def train_step(params, opt_state, batch):
        tokens, labels = (cut_batch(mesh, batch[k])
                          for k in ("tokens", "labels"))
        with on_mesh(mesh, batch["tokens"].shape[0]):
            loss, parts, grads = value_and_grad(
                lambda p: transformer.lm_loss(p, cfg, tokens, labels),
                params)
            norm = None
            if mesh is not None and opt_cfg.grad_clip:
                norm = _grad_norm(grads, transformer.param_specs(cfg, mesh),
                                  mesh)
        params, opt_state = adamw.update(params, grads, opt_state, opt_cfg,
                                         grad_norm=norm)
        return params, opt_state, {"loss": loss, **parts}
    return train_step


def make_prefill_step(cfg: ModelConfig, mesh: Any = None) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        with on_mesh(mesh, batch["tokens"].shape[0]):
            logits, _ = transformer.forward(
                params, cfg, tokens=cut_batch(mesh, batch["tokens"]),
                remat=False)
        return logits[:, -1]      # next-token logits
    return prefill_step


def serve_logits(cfg: ModelConfig, params, token, caches, window: int = 0,
                 mesh: Any = None, cache_specs: Any = None):
    """One decode step of the whole batch ``token`` (B, 1): (this rank's
    logits block, the whole batch's next tokens, this rank's caches).
    On ``mesh`` the caches are this rank's blocks of ``cache_specs``
    (:func:`cache_blocks`), which a mesh requires."""
    if mesh is not None and cache_specs is None:
        raise ValueError("decode on a mesh takes the caches' specs "
                         "(steps.cache_blocks)")
    with on_mesh(mesh, token.shape[0]):
        logits, caches = transformer.decode_step(
            params, cfg, cut_batch(mesh, token), caches, window=window,
            cache_specs=cache_specs)
        nxt = transformer.greedy(logits, cfg)
        nxt = mesh_ops.gather_plain(nxt, 0, mesh_ops.batch_axes(), "batch")
    return logits, nxt, caches


def make_serve_step(cfg: ModelConfig, window: int = 0, mesh: Any = None,
                    cache_specs: Any = None) -> Callable:
    @torch.no_grad()
    def serve_step(params, token, caches):
        _, nxt, caches = serve_logits(cfg, params, token, caches, window,
                                      mesh, cache_specs)
        return nxt, caches
    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def _axis_size(entry, mesh) -> int:
    """The number of shards a spec entry cuts its dimension into."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


@dataclasses.dataclass(frozen=True)
class AbstractArray:
    """One abstract input: a ``meta`` tensor (shape and dtype, no
    storage) and its spec on ``mesh``."""

    value: torch.Tensor
    spec: tuple
    mesh: Any

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def shard_shape(self) -> tuple[int, ...]:
        """One device's block; a dimension that its axes do not divide
        rounds up, as XLA pads it."""
        spec = self.spec + (None,) * (len(self.shape) - len(self.spec))
        return tuple(-(-n // _axis_size(e, self.mesh))
                     for n, e in zip(self.shape, spec))

    @property
    def device_bytes(self) -> int:
        """Bytes of one device's block."""
        return math.prod(self.shard_shape) * self.value.element_size()


def is_abstract(x: Any) -> bool:
    return isinstance(x, AbstractArray)


def _abstract(shapes: Any, specs: Any, mesh: Any) -> Any:
    return tree.map(lambda s, sp: AbstractArray(s, sp, mesh), shapes, specs)


def _meta_params(cfg: ModelConfig) -> Any:
    return transformer.init(rnd.PRNGKey(0, "meta"), cfg)


def abstract_params(cfg: ModelConfig, mesh: Any) -> Any:
    shapes = _meta_params(cfg)
    moe_sh = cfg.moe.sharding if cfg.moe else "ep"
    return _abstract(shapes, rules.param_specs(shapes, mesh, moe_sh), mesh)


def abstract_opt_state(cfg: ModelConfig, mesh: Any, params_abs: Any,
                       opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()
                       ) -> adamw.AdamWState:
    shapes = adamw.init(tree.map(lambda a: a.value, params_abs,
                                 is_leaf=is_abstract), opt_cfg)
    moe_sh = cfg.moe.sharding if cfg.moe else "ep"

    def like(t):
        return _abstract(t, rules.param_specs(t, mesh, moe_sh), mesh)

    return adamw.AdamWState(step=AbstractArray(shapes.step, (), mesh),
                            m=like(shapes.m), v=like(shapes.v))


def abstract_cache(cfg: ModelConfig, mesh: Any, batch: int, max_len: int,
                   window: int = 0) -> Any:
    shapes = transformer.init_cache(cfg, batch, max_len, window,
                                    device="meta")
    return _abstract(shapes, rules.cache_specs(shapes, mesh), mesh)


def cache_blocks(cfg: ModelConfig, mesh: Any, batch: int, max_len: int,
                 window: int = 0) -> tuple[Any, Any]:
    """This rank's blocks of the decode caches under ``rules.cache_specs``
    on ``mesh`` (a :class:`~repro_torch.launch.model_mesh.ModelMesh`):
    zeros, every leaf, as ``transformer.init_cache`` makes the whole (it
    stacks each layer's cache as zeros, as the reference's does, so the
    xLSTM stabilizers start at 0 and not at the -1e30 of
    ``mlstm_init_cache`` / ``slstm_init_cache``), each allocated at its
    block's shape (:attr:`AbstractArray.shard_shape`) on the mesh's
    device, the whole never; and the specs, for
    :func:`serve_logits`."""
    abstract = abstract_cache(cfg, mesh, batch, max_len, window)
    blocks = tree.map(lambda a: torch.zeros(a.shard_shape, dtype=a.dtype,
                                            device=mesh.device),
                      abstract, is_leaf=is_abstract)
    return blocks, tree.map(lambda a: a.spec, abstract, is_leaf=is_abstract)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh: Any,
                opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()
                ) -> dict[str, Any]:
    """All abstract inputs for one (arch × shape × mesh) dry-run."""
    bsp = rules.batch_spec(mesh, shape.global_batch)
    params = abstract_params(cfg, mesh)

    def tokens(t):
        return AbstractArray(torch.empty((shape.global_batch, t),
                                         dtype=torch.int32, device="meta"),
                             bsp, mesh)

    if shape.kind == "train":
        tok = tokens(shape.seq_len)
        return {
            "params": params,
            "opt_state": abstract_opt_state(cfg, mesh, params, opt_cfg),
            "batch": {"tokens": tok, "labels": tok},
        }
    if shape.kind == "prefill":
        return {"params": params, "batch": {"tokens": tokens(shape.seq_len)}}
    # decode: one new token + a seq_len cache
    window = needs_window(cfg, shape)
    caches = abstract_cache(cfg, mesh, shape.global_batch, shape.seq_len,
                            window)
    return {"params": params, "token": tokens(1), "caches": caches,
            "window": window}
