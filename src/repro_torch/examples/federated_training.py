"""End to end: the paper's full experiment at laptop scale —
TPFL vs FedAvg vs FedTM on fully non-IID synthetic FEMNIST (62 classes),
multi-round, with exact communication metering.

Counterpart of ``examples/federated_training.py``, on the GPU unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.federated_training \\
      [--rounds 5] [--clients 12] [--dataset synthmnist] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core import baselines, federation, tm
from repro_torch.data import partition, synthetic


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--dataset", default="synthfemnist",
                    choices=synthetic.DATASETS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    x, y, dcfg = synthetic.make_dataset(args.dataset, 8000,
                                        rnd.PRNGKey(0, dev), side=12)
    data = partition.partition(
        x, y, dcfg.n_classes, n_clients=args.clients, experiment=5,
        key=rnd.PRNGKey(1, dev), n_train=80, n_test=40, n_conf=40)
    print(f"{args.dataset}: {dcfg.n_classes} classes, "
          f"{args.clients} clients, fully non-IID (experiment 5)")

    tm_cfg = tm.TMConfig(n_classes=dcfg.n_classes, n_clauses=48,
                         n_features=dcfg.n_features, s=5.0, T=40)

    t0 = time.time()
    fed_cfg = federation.FedConfig(n_clients=args.clients,
                                   rounds=args.rounds, local_epochs=2)
    _, hist = federation.run(data, tm_cfg, fed_cfg, rnd.PRNGKey(2, dev))
    up, down = federation.total_comm_mb(hist)
    print(f"\nTPFL   acc/round: "
          f"{[round(float(h.mean_accuracy), 3) for h in hist]}")
    print(f"TPFL   comm: up {up:.4f} MB / down {down:.4f} MB "
          f"({time.time()-t0:.0f}s)")

    bcfg = baselines.BaselineConfig(n_clients=args.clients,
                                    rounds=args.rounds, local_epochs=2)
    t0 = time.time()
    fedavg = baselines.run_fedavg(data, bcfg, rnd.PRNGKey(3, dev),
                                  dcfg.n_features, dcfg.n_classes)
    print(f"\nFedAvg acc/round: {[round(a, 3) for a in fedavg.accuracy]}")
    print(f"FedAvg comm: up {fedavg.upload_mb:.4f} MB "
          f"({time.time()-t0:.0f}s)")

    t0 = time.time()
    fedtm = baselines.run_fedtm(data, tm_cfg, bcfg, rnd.PRNGKey(4, dev))
    print(f"\nFedTM  acc/round: {[round(a, 3) for a in fedtm.accuracy]}")
    print(f"FedTM  comm: up {fedtm.upload_mb:.4f} MB ({time.time()-t0:.0f}s)")

    print("\n→ TPFL uploads one class-weight vector per client-round; "
          "FedTM uploads all classes; FedAvg ships the full DL model.")
    return {"tpfl": hist, "tpfl_comm_mb": (up, down), "fedavg": fedavg,
            "fedtm": fedtm}


if __name__ == "__main__":
    main()
