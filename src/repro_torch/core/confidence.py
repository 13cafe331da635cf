"""Per-class confidence: the quantity TPFL clusters on (paper §4.2).

Counterpart of ``repro/core/confidence.py``.  Two providers with one
contract ``(model, D_conf) → (C,)`` scores:

* TM clients (the paper): the aggregate clause-vote margin on D_conf,
  :func:`repro_torch.core.tm.confidence_scores_batched`;
* NN clients (the framework's generalization): the summed per-class
  logit margin ``logit_c − max_{c'≠c} logit_{c'}`` over D_conf,
  :func:`logit_margin_confidence`.
"""
from __future__ import annotations

import torch

from repro_torch.core.tm import confidence_scores_batched  # noqa: F401


def logit_margin_confidence(logits: torch.Tensor) -> torch.Tensor:
    """logits (..., B, C) → (..., C) summed one-vs-rest margins."""
    top = logits.max(dim=-1, keepdim=True).values
    second = torch.sort(logits, dim=-1).values[..., -2:-1]
    margin = torch.where(logits == top, logits - second, logits - top)
    return margin.sum(dim=-2)


def cluster_assignment(conf: torch.Tensor) -> torch.Tensor:
    """c_max = argmax_c conf[c]; ties go to the lowest class, as in
    ``jnp.argmax``.  Cluster id == class id."""
    return torch.argmax(conf, dim=-1)
