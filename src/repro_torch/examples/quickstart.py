"""Quickstart: train one Tsetlin Machine client, inspect its confidence,
then run a 5-client TPFL mini-federation.

Counterpart of ``examples/quickstart.py``, on the GPU unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core import federation, tm
from repro_torch.data import partition, synthetic


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    key = rnd.PRNGKey(0, dev)

    # --- 1. a single TM client ------------------------------------------
    x, y, dcfg = synthetic.make_dataset("synthmnist", 2000, key, side=12)
    tm_cfg = tm.TMConfig(n_classes=10, n_clauses=50,
                         n_features=dcfg.n_features, s=5.0, T=30)
    params = tm.init_params(tm_cfg, key)
    params = tm.train(params, x[:300], y[:300], rnd.PRNGKey(1, dev),
                      tm_cfg, epochs=3)
    acc = float(tm.accuracy(params, x[1000:1500], y[1000:1500], tm_cfg))
    print(f"single TM client accuracy: {acc:.3f}")

    conf = tm.confidence_scores(params, x[1500:1700], tm_cfg)
    print(f"per-class confidence: {conf.tolist()}")
    print(f"most-confident class (c_max): {int(torch.argmax(conf))}")

    # --- 2. TPFL mini-federation (fully non-IID) ------------------------
    data = partition.partition(x, y, 10, n_clients=5, experiment=5,
                               key=rnd.PRNGKey(2, dev),
                               n_train=60, n_test=30, n_conf=30)
    fed_cfg = federation.FedConfig(n_clients=5, rounds=2, local_epochs=2)
    _, hist = federation.run(data, tm_cfg, fed_cfg, rnd.PRNGKey(3, dev))
    for r, h in enumerate(hist):
        print(f"round {r}: mean acc {float(h.mean_accuracy):.3f}  "
              f"clusters {h.assignment.tolist()}")
    up, down = federation.total_comm_mb(hist)
    print(f"total comm: upload {up*1000:.1f} KB, download {down*1000:.1f} KB"
          f"  (one class-weight vector per client per round)")
    return {"accuracy": acc, "confidence": conf, "history": hist,
            "comm_mb": (up, down)}


if __name__ == "__main__":
    main()
