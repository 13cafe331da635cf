"""Runnable LM training driver for the model scaffold, on the GPU unless
``--device cpu``.

Counterpart of ``repro/launch/train.py``: the same flags (and
``--device``), the same printed lines; eager PyTorch, the AdamW update
in place (:func:`repro_torch.optim.adamw.update`); ``--save`` /
``--restore`` through the port's checkpoints, which each package reads
from the other.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
      --steps 20 --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --steps 3 --seq 256 --batch 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data import loader
from repro_torch.launch import steps as steps_mod
from repro_torch.models import config as mcfg
from repro_torch.models import transformer
from repro_torch.optim import adamw, schedules


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced family variant (CPU-sized)")
    ap.add_argument("--mtp-weight", type=float, default=0.0,
                    help="DeepSeek-style multi-token-prediction aux loss")
    ap.add_argument("--warmup", type=int, default=0,
                    help="enable warmup+cosine LR schedule")
    ap.add_argument("--save", default="", help="checkpoint path to write")
    ap.add_argument("--restore", default="",
                    help="checkpoint path to resume from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap


def sync(dev: torch.device) -> None:
    """Wait for the card, so a host clock reads its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> dict:
    """Run the driver; returns the final parameters and optimizer state,
    each step's metrics (floats) and seconds, and the init seconds."""
    args = _parser().parse_args(argv)
    dev = devices.resolve(args.device)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = mcfg.reduced(cfg)
    print(f"arch={cfg.name} layers={len(cfg.layer_list())} "
          f"d_model={cfg.d_model} vocab={cfg.vocab}")

    t0 = time.perf_counter()
    key = rnd.PRNGKey(args.seed, dev)
    params = transformer.init(key, cfg)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"params: {n_params/1e6:.2f}M")

    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    opt = adamw.init(params, opt_cfg)
    if args.restore:
        state = ckpt.restore(args.restore, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        print(f"restored from {args.restore} (step {int(opt.step)})")

    sched = schedules.ScheduleConfig(
        peak_lr=args.lr, warmup_steps=args.warmup,
        total_steps=max(args.steps, 1)) if args.warmup else None

    def mtp_train_step(params, opt_state, batch):
        def loss_fn(p):
            loss, parts = transformer.lm_loss(p, cfg, batch["tokens"],
                                              batch["labels"])
            if args.mtp_weight:
                loss = loss + transformer.mtp_loss(
                    p, cfg, batch["tokens"], batch["labels"],
                    weight=args.mtp_weight)
            return loss, parts
        loss, parts, grads = steps_mod.value_and_grad(loss_fn, params)
        lr = schedules.lr_at(opt_state.step + 1, sched) if sched else None
        params, opt_state = adamw.update(params, grads, opt_state, opt_cfg,
                                         lr=lr)
        return params, opt_state, {"loss": loss, **parts}

    step = (mtp_train_step if (args.mtp_weight or sched)
            else steps_mod.make_train_step(cfg, opt_cfg))

    batcher = loader.TokenBatcher(cfg, args.batch, args.seq,
                                  seed=args.seed, device=dev)
    metrics_log, step_s = [], []
    for i in range(args.steps):
        batch = batcher(i)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        sync(dev)
        dt = time.perf_counter() - t0
        metrics_log.append({k: float(v) for k, v in metrics.items()})
        step_s.append(dt)
        print(f"step {i:4d} loss={loss:.4f} "
              f"ce={float(metrics['ce']):.4f} "
              f"aux={float(metrics['aux']):.5f} "
              f"dt={dt:.2f}s", flush=True)

    if args.save:
        ckpt.save(args.save, {"params": params, "opt": opt})
        print(f"saved checkpoint → {args.save}")
    return {"cfg": cfg, "params": params, "opt": opt,
            "metrics": metrics_log, "step_s": step_s, "init_s": init_s,
            "n_params": n_params}


if __name__ == "__main__":
    main()
