"""Measure ``gloo`` collectives on CUDA tensors among 4 ranks on one card.

The model mesh's ranks share the card in a ``gloo`` group, which stages
every CUDA tensor through the host.  Four spawned ranks on ``cuda:0``
check that ``gloo`` takes the collectives the mesh runs (a MAX
all-reduce, bfloat16 and int64 gathers) and time, with the card synced
around each call:

* an ``all_gather`` over the 4 ranks of bfloat16 blocks whose result is
  25 MB and 100 MB (4 calls each);
* an ``all_reduce`` of 25 MB and 100 MB over a 2-rank group (3 calls);
* a ``broadcast`` of 25 MB and 100 MB from rank 0 (2 calls).

Prints the card's name and power limit, then one JSON line: every
rank's seconds a call.

    python3 tools/gloo_rates.py
"""
import json
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 4


def _timed(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def _rank(rank: int, store: str, out: str) -> None:
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=RANKS, rank=rank)
    pair = [dist.new_group([0, 2]), dist.new_group([1, 3])][rank % 2]
    res = {}
    checks = {
        "all_reduce_max": lambda: dist.all_reduce(
            torch.full((4,), float(rank), device=dev),
            op=dist.ReduceOp.MAX),
        "all_gather_bf16": lambda: dist.all_gather(
            [torch.empty(4, dtype=torch.bfloat16, device=dev)
             for _ in range(RANKS)],
            torch.ones(4, dtype=torch.bfloat16, device=dev)),
        "all_gather_int64": lambda: dist.all_gather(
            [torch.empty(4, dtype=torch.int64, device=dev)
             for _ in range(RANKS)],
            torch.ones(4, dtype=torch.int64, device=dev))}
    for name, fn in checks.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except (RuntimeError, ValueError) as e:
            res[name] = repr(e)[:200]
    for mb in (25, 100):
        n = mb * 2**20 // 2
        shard = torch.randn(n // RANKS, device=dev).to(torch.bfloat16)
        parts = [torch.empty_like(shard) for _ in range(RANKS)]
        res[f"all_gather_{mb}MB_s"] = _timed(
            lambda: dist.all_gather(parts, shard), 4)
        whole = torch.randn(n, device=dev).to(torch.bfloat16)
        res[f"all_reduce_2_ranks_{mb}MB_s"] = _timed(
            lambda: dist.all_reduce(whole, group=pair), 3)
        res[f"broadcast_{mb}MB_s"] = _timed(
            lambda: dist.broadcast(whole, src=0), 2)
    every = [None] * RANKS
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(every, f)
    dist.destroy_process_group()


def main() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rates.json")
        mp.spawn(_rank, args=(os.path.join(d, "store"), out), nprocs=RANKS,
                 join=True)
        with open(out) as f:
            print(json.dumps(json.load(f)), flush=True)


if __name__ == "__main__":
    main()
