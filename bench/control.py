"""The control of the comparison, on the card at a cell's own size.

    python3 bench/control.py --workload tm-mnist-c10.silo20 --seeds 1 2 3

For each seed: the cell's inputs, then the plain reference put in the
program's place and computed in bfloat16 where the configuration states
float32 (the activation probability and its compare, the mean of the
uploads), held by ``bench/check.py`` against the float32 reference over
the rounds a run checks.  Prints the compared numbers a seed; the
control must come out not correct on every seed.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from bench import check, ref_tm, run, threefry, traffic
    _, _, workload, config = run.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    tm = ref_tm.TM.of(config)
    n, k = workload["population"], workload["cohort"]
    refused = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        data = traffic.make(config, workload, seed, "cuda")
        key = threefry.key(seed, "cuda")
        low, ref = (ref_tm.init_state(tm, key, n) for _ in range(2))
        total = None
        for r in range(workload["reference_rounds"]):
            low, got = ref_tm.run_round(tm, low, data, key, r, k, lowp=True)
            ref, want = ref_tm.run_round(tm, ref, data, key, r, k)
            total = check.add(total, check.compare(got, want, 0))
        refused += not check.passed(total)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": check.passed(total),
                          "seconds": time.perf_counter() - t0,
                          "check": {a: v["value"] for a, v in total.items()}}),
              flush=True)
        del low, ref, got, want, data
    return 0 if refused == len(args.seeds) else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
