"""Learning-rate schedules (warmup + cosine/linear decay), functions of
the step counter in float32.

Counterpart of ``repro/optim/schedules.py``.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    end_lr_frac: float = 0.1
    kind: str = "cosine"          # "cosine" | "linear" | "constant"


def lr_at(step: torch.Tensor, cfg: ScheduleConfig) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * torch.clamp_max(step / max(cfg.warmup_steps, 1),
                                         1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    end = cfg.peak_lr * cfg.end_lr_frac
    if cfg.kind == "cosine":
        decay = end + (cfg.peak_lr - end) * 0.5 * (
            1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * frac))
    elif cfg.kind == "linear":
        decay = cfg.peak_lr + (end - cfg.peak_lr) * frac
    else:
        decay = torch.full_like(step, cfg.peak_lr)
    return torch.where(step < cfg.warmup_steps, warm, decay)
