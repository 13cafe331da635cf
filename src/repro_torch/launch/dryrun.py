"""Dry run without XLA: what one (architecture × input shape × mesh)
needs of each device, priced from the sharding rules.

Counterpart of ``repro/launch/dryrun.py``, with its flags.  The
reference lowers and compiles each combination for 256 or 512 forced
host devices and reads XLA's memory and cost analyses and the
partitioned HLO's collectives.  The port compiles no partitioned
program, so it prices the same combination analytically, on the
``meta`` device: no card, no allocation.  For each combination:

* ``arch``, ``shape``, ``mesh``, ``chips``, ``kind``, ``params``,
  ``active_params``, as the reference reports them;
* ``memory.argument_bytes``: one device's block of every input of
  :func:`repro_torch.launch.steps.input_specs` (shard shape × itemsize,
  a dimension its axes do not divide rounded up as XLA pads), which is
  what XLA's ``argument_size_in_bytes`` counts
  (``tests/test_torch_dryrun.py`` holds the two equal on a forced 8-device
  CPU mesh); ``memory.output_bytes`` from the step's outputs: the new
  parameters and optimizer state (their inputs' specs) and three f32
  scalars for train, the token and the caches for decode, the last
  position's f32 logits (batch over the FSDP axes, vocab over ``model``)
  for prefill;
* ``roofline``: the reference's :func:`~repro_torch.launch.hlo_analysis.
  roofline` with ``cost={}``, at the H100's constants
  (:mod:`repro_torch.launch.mesh`) and the reference's model FLOPs
  (6·N_active·tokens for train, 2·N_active·tokens otherwise), so
  ``compute_s`` is the analytic term and ``memory_s`` the argument-bytes
  floor; ``collective_breakdown`` holds the parameter traffic the FSDP
  axes imply (:func:`fsdp_collectives`), ``"collective_source":
  "analytic (rules)"``, over one NDR port a card past one node's 8 cards
  and NVLink 4 within it (``link``).

What only XLA can report is left out, not set to zero: ``lower_s``,
``compile_s``, ``temp_bytes``, ``peak_bytes_per_device`` and the
roofline's ``*_hlo`` terms, ``hlo_flops_per_device``,
``hlo_bytes_per_device`` and ``useful_flops_ratio``.  This is the one
entry point of the port that needs no card, as the reference's dry run
needs no TPU.  It prints one JSON line a combination and writes files
only under ``--out``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--opt-dtype bf16] [--out DIR --tag perf]
"""
from __future__ import annotations

import argparse
import json
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import hlo_analysis, steps
from repro_torch.launch.mesh import (H100_HBM_BW, H100_NDR_BW,
                                     H100_NODE_GPUS, H100_NVLINK_BW,
                                     H100_PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import rules

# the step's arguments in input_specs, by kind ("window" is static)
ARGUMENTS = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "token", "caches")}
# roofline keys that read XLA's cost analysis: left out
XLA_ONLY = ("compute_s_hlo", "memory_s_hlo", "hlo_flops_per_device",
            "hlo_bytes_per_device", "useful_flops_ratio")
NOT_COUNTED = ("activation collectives on the 'model' axis: the tensor-"
               "parallel all-reduces, the context-parallel softmax's "
               "all-reduces over the sharded cache, the expert-parallel "
               "all-to-all")
SCALARS = 3                     # train metrics: loss, ce, aux (f32)


def device_bytes(t: Any) -> int:
    """One device's bytes of every abstract leaf of ``t``."""
    return sum(a.device_bytes
               for a in tree.leaves(t, is_leaf=steps.is_abstract))


def argument_bytes(ins: dict, kind: str) -> int:
    return sum(device_bytes(ins[k]) for k in ARGUMENTS[kind])


def output_bytes(cfg: ModelConfig, shape: steps.ShapeSpec, ins: dict,
                 mesh: Any) -> int:
    if shape.kind == "train":
        return (device_bytes(ins["params"]) + device_bytes(ins["opt_state"])
                + SCALARS * 4)
    if shape.kind == "decode":
        return device_bytes(ins["token"]) + device_bytes(ins["caches"])
    vocab = "model" if cfg.padded_vocab % mesh.shape.get("model", 1) == 0 \
        else None
    row = torch.empty((shape.global_batch, cfg.padded_vocab),
                      dtype=torch.float32, device="meta")
    spec = (rules.batch_spec(mesh, shape.global_batch)[0], vocab)
    return steps.AbstractArray(row, spec, mesh).device_bytes


def fsdp_collectives(params: Any, mesh: Any, kind: str) -> dict[str, int]:
    """Per-device bytes of the parameter collectives the FSDP axes imply,
    under the reference's kind names: each FSDP-sharded leaf is
    all-gathered over those axes once per forward (once more for the
    rematerialized backward in training), and its gradient
    reduce-scattered in training.  Each counts the gathered leaf's bytes
    on one device (the all-gather's result, the reduce-scatter's
    operand), which a ring moves to within (n − 1)/n; the reference's HLO
    count takes result shapes, which for a reduce-scatter is the shard.
    Optimizer state, caches and batches stay sharded and move nothing."""
    fsdp = set(rules.fsdp_axes(mesh))

    def unsharded(e):
        """A spec entry with the FSDP axes taken out."""
        if isinstance(e, tuple):
            return tuple(a for a in e if a not in fsdp) or None
        return None if e in fsdp else e

    gathers, scatters = (2, 1) if kind == "train" else (1, 0)
    out = dict.fromkeys(hlo_analysis.COLLECTIVES, 0)
    for leaf in tree.leaves(params, is_leaf=steps.is_abstract):
        whole = steps.AbstractArray(
            leaf.value, tuple(unsharded(e) for e in leaf.spec), mesh)
        if whole.shard_shape == leaf.shard_shape:
            continue                    # not FSDP-sharded, or over size 1
        out["all-gather"] += gathers * whole.device_bytes
        out["reduce-scatter"] += scatters * whole.device_bytes
    return out


def analyse(cfg: ModelConfig, shape: steps.ShapeSpec, mesh: Any,
            opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()) -> dict:
    """The memory and roofline of one (config × shape × mesh)."""
    ins = steps.input_specs(cfg, shape, mesh, opt_cfg)
    chips = mesh.size
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    arg = argument_bytes(ins, shape.kind)
    link, link_bw = (("NVLink 4", H100_NVLINK_BW) if chips <= H100_NODE_GPUS
                     else ("NDR 400 Gb/s", H100_NDR_BW))
    rf = hlo_analysis.roofline(
        {}, fsdp_collectives(ins["params"], mesh, shape.kind),
        peak_flops=H100_PEAK_FLOPS_BF16, hbm_bw=H100_HBM_BW,
        ici_bw=link_bw, model_flops=model_flops, chips=chips,
        arg_bytes=arg)
    for k in XLA_ONLY:
        del rf[k]
    rf.update(collective_source="analytic (rules)", link=link,
              collective_not_counted=NOT_COUNTED)
    return {"chips": chips, "kind": shape.kind,
            "params": cfg.param_count(), "active_params": n_active,
            "memory": {"argument_bytes": arg,
                       "output_bytes": output_bytes(cfg, shape, ins, mesh)},
            "roofline": rf}


def dryrun(arch: str, shape_name: str, multi_pod: bool = False,
           out: str | Path | None = None, extra_tag: str = "",
           opt_dtype: str = "f32") -> dict:
    cfg = registry.get(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    opt_cfg = adamw.AdamWConfig(
        state_dtype=torch.bfloat16 if opt_dtype == "bf16" else torch.float32)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
              **analyse(cfg, steps.SHAPES[shape_name], mesh, opt_cfg)}
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}_{shape_name}_{result['mesh']}" + \
            (f"_{extra_tag}" if extra_tag else "")
        (out / f"dryrun_{tag}.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch × shape on this mesh")
    ap.add_argument("--tag", default="", help="artifact suffix for perf runs")
    ap.add_argument("--opt-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--out", default=None,
                    help="write one dryrun_<tag>.json a combination here")
    args = ap.parse_args(argv)

    archs = list(registry.ARCHS) if args.arch in ("all",) or args.all \
        else [args.arch]
    shapes = list(steps.SHAPES) if args.shape in ("all",) or args.all \
        else [args.shape]

    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            try:
                r = dryrun(arch, shape, multi_pod=args.multi_pod,
                           out=args.out, extra_tag=args.tag,
                           opt_dtype=args.opt_dtype)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"FAIL {arch:24s} {shape:12s}: {e!r}", flush=True)
                traceback.print_exc()
                continue
            results.append(r)
            print(json.dumps(r), flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    return results


if __name__ == "__main__":
    main()
