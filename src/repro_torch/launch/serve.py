"""Transformer decode demo: prefill a batch of prompts, then decode with
the unified KV-cache protocol, on the GPU unless ``--device cpu``.

Counterpart of ``repro/launch/serve.py``: the same flags (and
``--device``), the same printed lines.  This drives the *transformer*
stack's cache protocol — it is not the federated serving plane
(``repro_torch.launch.fed_serve``).  ``REPRO_QUANT_KV=1`` serves from the
int8 KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
      --reduced --prompt-len 32 --decode-steps 16 --batch 2 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.configs import registry
from repro_torch.launch.train import sync
from repro_torch.models import config as mcfg
from repro_torch.models import stubs, transformer


@torch.no_grad()
def prefill_into_cache(params, cfg, tokens, caches, window=0,
                       collect: list | None = None):
    """Feed prompt tokens through decode steps to fill the cache (the
    driver exercises the cache protocol; a production system prefills
    with the parallel forward).  ``collect`` gathers each step's logits."""
    last = None
    for t in range(tokens.shape[1]):
        last, caches = transformer.decode_step(
            params, cfg, tokens[:, t:t + 1], caches, window=window)
        if collect is not None:
            collect.append(last)
    return last, caches


@torch.no_grad()
def run(cfg, params, batch: int, prompt_len: int, decode_steps: int,
        window: int = 0, device=None) -> dict:
    """Prefill and greedy decode from ``params``; prints the driver's
    lines and returns the fed tokens (B, P+D), every step's logits
    (B, P+D, V) float32, the generated tokens (B, D+1) and the seconds
    of prefill and decode."""
    dev = devices.resolve(device)
    max_len = prompt_len + decode_steps
    caches = transformer.init_cache(cfg, batch, max_len, window, device=dev)
    prompt = stubs.tokens_for(cfg, rnd.PRNGKey(1, dev), batch, prompt_len)
    steps_logits: list = []
    t0 = time.perf_counter()
    logits, caches = prefill_into_cache(params, cfg, prompt, caches,
                                        window, collect=steps_logits)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {prompt_len} tokens: {prefill_s:.2f}s")

    tok = transformer.greedy(logits)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        logits, caches = transformer.decode_step(params, cfg, tok, caches,
                                                 window=window)
        steps_logits.append(logits)
        tok = transformer.greedy(logits)
        out.append(tok)
    sync(dev)
    dt = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    print(f"decoded {decode_steps} steps in {dt:.2f}s "
          f"({decode_steps*batch/dt:.1f} tok/s)")
    print("sample:", gen[0, :16].tolist())
    return {"tokens": torch.cat([prompt, gen[:, :-1]], dim=1),
            "logits": torch.cat(steps_logits, dim=1), "generated": gen,
            "prefill_s": prefill_s, "decode_s": dt}


def main(argv: list[str] | None = None) -> dict:
    """Run the driver; returns :func:`run`'s dict with the config, the
    parameters and the init seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = mcfg.reduced(cfg)

    t0 = time.perf_counter()
    params = transformer.init(rnd.PRNGKey(0, dev), cfg)
    sync(dev)
    init_s = time.perf_counter() - t0
    out = run(cfg, params, args.batch, args.prompt_len, args.decode_steps,
              args.window, dev)
    return {"cfg": cfg, "params": params, "init_s": init_s, **out}


if __name__ == "__main__":
    main()
