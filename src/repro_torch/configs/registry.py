"""Architecture registry: ``get(arch_id)`` → ModelConfig.

One module per assigned architecture under ``src/repro_torch/configs/``; each
cites its source in ``ModelConfig.source``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "jamba_1_5_large_398b",
    "qwen3_32b",
    "granite_20b",
    "musicgen_large",
    "yi_6b",
    "xlstm_350m",
    "deepseek_v3_671b",
    "phi3_medium_14b",
    "chameleon_34b",
    "granite_moe_3b_a800m",
)

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
# also accept the assignment's hyphenated ids (e.g. "jamba-1.5-large-398b")
_ALIAS.update({
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen3-32b": "qwen3_32b",
    "granite-20b": "granite_20b",
    "musicgen-large": "musicgen_large",
    "yi-6b": "yi_6b",
    "xlstm-350m": "xlstm_350m",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi3-medium-14b": "phi3_medium_14b",
    "chameleon-34b": "chameleon_34b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
})


def get(arch: str) -> ModelConfig:
    mod_name = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get(a) for a in ARCHS}
