"""TPFL federation settings (paper Algs. 1 and 2).

Counterpart of ``repro/core/federation.py``: the federation's knobs, and
the TPFL strategy they configure for the round engine.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import tm
from repro_torch.fl.runtime.strategy import TPFLStrategy


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 100
    rounds: int = 10
    local_epochs: int = 10
    weighted_confidence: bool = False   # Alg. 1 uses unweighted margins
    top_classes: int = 1                # j > 1: §7 multi-cluster sharing
    conf_threshold: float | None = None  # §7: share only confident classes


def tpfl_strategy(tm_cfg: tm.TMConfig, fed_cfg: FedConfig) -> TPFLStrategy:
    return TPFLStrategy(
        tm_cfg, local_epochs=fed_cfg.local_epochs,
        top_classes=fed_cfg.top_classes,
        conf_threshold=fed_cfg.conf_threshold,
        weighted_confidence=fed_cfg.weighted_confidence)
