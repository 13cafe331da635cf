"""Walk all 10 assigned architectures (reduced variants) through a short
training run each — the ``--arch`` selectable-config surface in one
script.

Counterpart of ``examples/multiarch_train.py``, on the GPU unless
``--device cpu``; each step updates the parameters and AdamW moments in
place (:func:`repro_torch.launch.steps.make_train_step`):

  PYTHONPATH=src python -m repro_torch.examples.multiarch_train \\
      [--steps 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.configs import registry
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import sync
from repro_torch.models import config as mcfg
from repro_torch.models import stubs, transformer
from repro_torch.optim import adamw


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    out = {}
    for arch in registry.ARCHS:
        cfg = mcfg.reduced(registry.get(arch))
        params = transformer.init(rnd.PRNGKey(0, dev), cfg)
        opt_cfg = adamw.AdamWConfig(lr=1e-3)
        opt = adamw.init(params, opt_cfg)
        step = steps_mod.make_train_step(cfg, opt_cfg)
        toks = stubs.tokens_for(cfg, rnd.PRNGKey(1, dev), 2, 32)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
        t0 = time.time()
        losses = []
        for _ in range(args.steps):
            params, opt, m = step(params, opt, batch)
            losses.append(round(float(m["loss"]), 3))
        sync(dev)
        print(f"{arch:24s} losses={losses}  ({time.time()-t0:.1f}s)",
              flush=True)
        out[arch] = losses
    return out


if __name__ == "__main__":
    main()
