"""Train / prefill / serve steps for the model scaffold.

Counterpart of ``repro/launch/steps.py``'s steps: eager PyTorch, the
gradient through autograd (the attention's backward is the blockwise
one, :class:`repro_torch.models.attention._Flash`).  The reference's
abstract inputs for the mesh dry-run (``abstract_params``,
``abstract_opt_state``, ``abstract_cache``, ``input_specs``) price XLA's
partitioned programs; they are not ported with the steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


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


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()
                    ) -> Callable:
    """The step updates the parameters and moments in their tensors
    (:func:`repro_torch.optim.adamw.update`)."""
    def train_step(params, opt_state, batch):
        loss, parts, grads = value_and_grad(
            lambda p: transformer.lm_loss(p, cfg, batch["tokens"],
                                          batch["labels"]), params)
        params, opt_state = adamw.update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **parts}
    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = transformer.forward(params, cfg,
                                        tokens=batch["tokens"], remat=False)
        return logits[:, -1]      # next-token logits
    return prefill_step


def make_serve_step(cfg: ModelConfig, window: int = 0) -> Callable:
    @torch.no_grad()
    def serve_step(params, token, caches):
        logits, caches = transformer.decode_step(params, cfg, token, caches,
                                                 window=window)
        return transformer.greedy(logits), caches
    return serve_step
