"""JSONL event records, numpy- and torch-safe.

Counterpart of the serialization half of ``repro/fl/obs/events.py``:
:func:`to_jsonable` coerces numpy and torch scalars and arrays, paths and
non-finite floats into plain JSON values, and :func:`append_event`
appends one event per line.
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Any

import numpy as np
import torch


def to_jsonable(value: Any) -> Any:
    """Recursively coerce a value into plain JSON types: numpy and torch
    scalars and arrays (→ nested lists), paths (→ str), NaN and ±inf
    (→ None, since JSON has no spelling for them)."""
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    if isinstance(value, pathlib.Path):
        return str(value)
    if isinstance(value, torch.Tensor):
        return to_jsonable(value.detach().cpu().tolist())
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        f = float(value)
        return f if math.isfinite(f) else None
    if isinstance(value, np.ndarray):
        return to_jsonable(value.tolist())
    return value


def append_event(path: str | pathlib.Path, event: dict) -> dict:
    """Append one event as a JSONL line and return the jsonable form
    that was written."""
    jsonable = to_jsonable(event)
    with open(path, "a") as f:
        f.write(json.dumps(jsonable, sort_keys=True) + "\n")
    return jsonable
