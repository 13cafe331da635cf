"""Serve a small model with batched requests: prefill via the parallel
forward, then batched greedy decode through the unified cache protocol
(GQA ring-buffer / MLA latent / SSM state caches all behind one API).

Counterpart of ``examples/serve_decode.py``, on the GPU unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      --arch deepseek-v3-671b [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      --arch xlstm-350m
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
def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--decode-steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    cfg = mcfg.reduced(registry.get(args.arch))
    print(f"serving {cfg.name}: {len(cfg.layer_list())} layers, "
          f"d_model={cfg.d_model}, batched requests={args.batch}")
    params = transformer.init(rnd.PRNGKey(0, dev), cfg)

    prompts = stubs.tokens_for(cfg, rnd.PRNGKey(1, dev), args.batch,
                               args.prompt_len)
    max_len = args.prompt_len + args.decode_steps
    caches = transformer.init_cache(cfg, args.batch, max_len, device=dev)

    # prefill: parallel forward for logits; decode path fills the cache
    t0 = time.time()
    logits, _ = transformer.forward(params, cfg, tokens=prompts, remat=False)
    for t in range(args.prompt_len):
        _, caches = transformer.decode_step(params, cfg,
                                            prompts[:, t:t + 1], caches)
    sync(dev)
    print(f"prefill({args.prompt_len} tok × {args.batch} req): "
          f"{time.time()-t0:.2f}s")

    tok = transformer.greedy(logits[:, -1:])
    t0 = time.time()
    gen = [tok]
    for _ in range(args.decode_steps):
        lg, caches = transformer.decode_step(params, cfg, tok, caches)
        tok = transformer.greedy(lg)
        gen.append(tok)
    sync(dev)
    dt = time.time() - t0
    print(f"decode: {args.decode_steps} steps × {args.batch} requests "
          f"in {dt:.2f}s → {args.decode_steps*args.batch/dt:.1f} tok/s")
    tokens = torch.cat(gen, 1)
    print("request 0 tokens:", tokens[0, :12].tolist())
    return {"prompts": prompts, "logits": logits, "tokens": tokens}


if __name__ == "__main__":
    main()
