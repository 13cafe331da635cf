"""Per-class confidence: the quantity TPFL clusters on (paper §4.2).

Counterpart of ``repro/core/confidence.py`` for TM clients; the scores
themselves are :func:`repro_torch.core.tm.confidence_scores_batched`.
"""
from __future__ import annotations

import torch

from repro_torch.core.tm import confidence_scores_batched  # noqa: F401


def cluster_assignment(conf: torch.Tensor) -> torch.Tensor:
    """c_max = argmax_c conf[c]; ties go to the lowest class, as in
    ``jnp.argmax``.  Cluster id == class id."""
    return torch.argmax(conf, dim=-1)
