"""A cell at a size the CPU tests hold: the paper's TM shape cut to 16
clauses and 12 x 12 images (as the repository's CPU smoke tests cut it),
6 clients of 20 / 10 / 10 samples, on the CPU."""
from __future__ import annotations

import json

from bench import run


def cell(n_classes: int = 10, population: int = 6, cohort: int = 3,
         rounds_checked: int = 5, partition=None):
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    config = {"name": "tiny", "reference": "ref_tm",
              "tm": {"n_classes": n_classes, "n_clauses": 16,
                     "n_features": 144, "n_states": 63, "s": 5.0, "T": 40,
                     "local_epochs": 2},
              "data": {"side": 12, "n_strokes": 3, "max_thick": 2,
                       "flip": 0.08},
              "partition": partition or {"kind": "dirichlet",
                                         "alpha": 0.05}}
    workload = {"config": "tiny", "population": population,
                "cohort": cohort,
                "per_client": {"train": 20, "test": 10, "conf": 10},
                "rounds_per_cycle": 5, "reference_rounds": rounds_checked}
    entry = {"name": "tiny", "config": "tiny", "traffic": "tiny",
             "chips": 1}
    bench["workloads"].append(entry)
    # the tiny cell reads what the silo cell, all clients training, reads
    for m in bench["per_layer"]:
        if "tm-mnist-c10.silo20" in m.get("workloads", []):
            m["workloads"].append(entry["name"])
    return bench, entry, workload, config


def run_tiny(seed: int = 3, trace: int = 0, **kw) -> dict:
    return run.main(["--workload", "tiny", "--seed", str(seed),
                     "--seconds", "0.1", "--trace", str(trace)],
                    device="cpu", isolation=False, cell=cell(**kw))
