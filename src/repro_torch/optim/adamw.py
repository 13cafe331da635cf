"""AdamW with optional global-norm gradient clipping over trees of
tensors.

Counterpart of ``repro/optim/adamw.py``: moments in float32, bias
corrections ``1 − b ** step`` in float32, parameters written back in
their own dtype.  :class:`AdamWState` is the reference's named tuple
``(step, m, v)``, so checkpoints carry its keys (``.step``, ``.m/...``,
``.v/...``).

:func:`update` writes the new parameters and moments into the given
tensors (the reference returns new ones), a leading-axis slice at a
time, so a step holds no second copy of the moments and no float32 copy
of the gradients: what a multi-billion-parameter model needs on one
card.  A caller that keeps the old values clones them first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree

# elements a slice of the in-place update holds (its float32 temporaries)
_SLICE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    dev = tree.leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.map(zeros, params), v=tree.map(zeros, params))


def _slices(a: torch.Tensor):
    """``a`` whole, or along its leading axis in slices of at most
    ``_SLICE`` elements."""
    if a.ndim == 0 or a.numel() <= _SLICE:
        yield ...
        return
    per = max(1, _SLICE // max(1, a[0].numel()))
    for i in range(0, a.shape[0], per):
        yield slice(i, i + per)


def _global_norm(grads: Any) -> torch.Tensor:
    total = 0
    for g in tree.leaves(grads):
        s = sum(torch.sum(torch.square(g[sl].float())) for sl in _slices(g))
        total = total + s
    return torch.sqrt(total)


def _moments(cfg: AdamWConfig, p, g, m, v, scale, b1c, b2c, lr_eff):
    """One leaf (or slice) of the update: (new p, new m, new v)."""
    gf = g.to(cfg.state_dtype)
    if scale is not None:
        gf = gf * scale
    m = cfg.b1 * m + (1 - cfg.b1) * gf
    v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
    mh = m / b1c
    vh = v / b2c
    pf = p.to(cfg.state_dtype)
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
    return (pf - lr_eff * delta).to(p.dtype), m, v


@torch.no_grad()
def update(params: Any, grads: Any, state: AdamWState,
           cfg: AdamWConfig = AdamWConfig(),
           lr: Any | None = None,
           grad_norm: torch.Tensor | None = None) -> tuple[Any, AdamWState]:
    """One step, in place; returns ``params`` and the new state (its
    moments the given tensors).  ``lr`` (a float or a 0-d tensor)
    overrides cfg.lr: the schedule hook.  The clipped gradient is
    ``g · scale`` in float32, as the reference's bf16 gradient times its
    float32 scale promotes.  ``grad_norm`` is the gradients' global norm
    where ``grads`` holds only a block of each (a mesh rank's shards);
    ``None`` computes it from ``grads``."""
    step = state.step + 1
    scale = None
    if cfg.grad_clip:
        gn = _global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-9),
                                1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    lr_eff = cfg.lr if lr is None else lr
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state.m), tree.leaves(state.v)):
        for sl in _slices(p):
            p[sl], m[sl], v[sl] = _moments(cfg, p[sl], g[sl], m[sl], v[sl],
                                           scale, b1c, b2c, lr_eff)
    return params, AdamWState(step=step, m=state.m, v=state.v)
