"""Least-time arithmetic shared by the cost files.

A count's least time is the larger of its operations over the highest
published peak that could do them and its bytes over the memory
bandwidth (``peaks.json``); operations and bytes add up across counts
before the bound is taken, so a sum never claims overlap it cannot have.
"""
from __future__ import annotations

import math


def state_bits(n_states: int) -> int:
    """Bits that hold a TA state in [1, 2·n_states]."""
    return max(1, math.ceil(math.log2(2 * n_states)))


def class_bits(n_classes: int) -> int:
    return max(1, math.ceil(math.log2(n_classes)))


def add(*counts: dict) -> dict:
    return {"ops": sum(c["ops"] for c in counts),
            "bytes": sum(c["bytes"] for c in counts)}


def seconds(count: dict, peak: dict) -> float:
    """The least time of ``count`` on the card ``peak`` describes."""
    return max(count["ops"] / peak["int8_tensor_ops_per_s"],
               count["bytes"] / peak["hbm_bytes_per_s"])
