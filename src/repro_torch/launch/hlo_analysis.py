"""Roofline terms: the reference's ``roofline`` and its tables.

Counterpart of ``repro/launch/hlo_analysis.py``: ``_DTYPE_BYTES``,
``COLLECTIVES`` and :func:`roofline` are the reference's code, statement
for statement (``tests/test_torch_dryrun.py`` holds them to it by AST
and by equal outputs).  The reference's ``collective_bytes`` and its
HLO parser (``_shape_bytes``, ``_parse_computations``) are not ported:
they read the optimized HLO text of an XLA-partitioned program, and the
port compiles none.  The dry run (:mod:`repro_torch.launch.dryrun`)
passes ``cost={}`` and collective bytes derived from the sharding rules
instead.
"""
from __future__ import annotations

from typing import Any

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def roofline(cost: dict[str, Any], coll: dict[str, int], *,
             peak_flops: float, hbm_bw: float, ici_bw: float,
             model_flops: float | None = None,
             chips: int = 1, arg_bytes: float = 0.0) -> dict[str, Any]:
    """Three-term roofline from per-device cost analysis + collective bytes.

    cost_analysis() of a partitioned module reports *per-device* FLOPs and
    bytes, so each term divides by a single chip's peak — equivalent to
    the global/(chips·peak) formulation.

    XLA's cost analysis counts `while` bodies ONCE, so scanned layer
    stacks under-report FLOPs/bytes.  We therefore also report analytic
    floors — ``compute_s_analytic`` = 6·N·D (or 2·N·D) / (chips·peak) and
    ``memory_s_floor`` = per-device argument bytes (params + optimizer +
    cache must be read every step) / HBM bw — and derive the bottleneck
    from the *effective* terms ``max(hlo, floor)``.  Collective bytes are
    trip-count-weighted (see collective_bytes), so they need no floor.
    """
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(coll.values()))
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / hbm_bw
    t_coll = cbytes / ici_bw
    t_comp_analytic = (model_flops / (chips * peak_flops)
                       if model_flops else 0.0)
    t_mem_floor = arg_bytes / hbm_bw
    terms = {"compute_s": max(t_compute, t_comp_analytic),
             "memory_s": max(t_memory, t_mem_floor),
             "collective_s": t_coll,
             "compute_s_hlo": t_compute,
             "compute_s_analytic": t_comp_analytic,
             "memory_s_hlo": t_memory,
             "memory_s_floor": t_mem_floor,
             "hlo_flops_per_device": flops,
             "hlo_bytes_per_device": bytes_accessed,
             "collective_bytes_per_device": cbytes,
             "collective_breakdown": coll}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    if model_flops is not None:
        terms["model_flops_global"] = model_flops
        terms["useful_flops_ratio"] = (
            model_flops / (flops * chips) if flops else 0.0)
    return terms
