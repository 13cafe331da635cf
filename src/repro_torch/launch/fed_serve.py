"""Federated serving CLI: personalized inference as a service.

Counterpart of ``repro/launch/fed_serve.py`` for what the port supports:
every strategy (TPFL, FedTM and the MLP baselines) over a resident
population.  ``fed_train --ckpt-dir D --ckpt-every
k`` leaves round checkpoints behind; this CLI stands up the serving
plane over them:

1. **Publish.**  The newest checkpoint under ``--ckpt-dir`` is placed
   into the ``--registry`` as an immutable version (sha256
   verify-then-place, atomic rename, sidecar last).
2. **Activate.**  The plane pulls the latest registry version —
   sidecar-verified, then decoded against this process's engine-state
   template, so a corrupted payload, flipped sidecar or layout drift is
   refused before a single request is answered.
3. **Serve.**  ``--requests`` batches of ``--batch`` requests each,
   strided over the client population so every batch mixes clusters;
   each batch is one ``predict_batched`` call (for the TM one
   fused-votes-batched launch on the GPU, for the MLP one batched
   product).  Between batches the plane polls ``refresh()``.

The scenario flags (``--strategy --dataset --data-dir --encoding
--clients --clauses --seed --max-slots --probe-size ...``) must repeat
the training run's, and
so must the structural flags (``--codec --sparse --error-feedback``,
which shape the checkpointed wire lanes, and ``--buffer-capacity``,
the async buffer's).  ``--verify-offline`` then serves one
covering batch (every client once) and checks each client's served
prediction against the offline prediction of its resolved row
(``tm.predict``, one fused-votes launch per client; for the MLP the
logits' argmax); the process exits 1 on any mismatch.

  PYTHONPATH=src python -m repro_torch.launch.fed_serve \\
      --ckpt-dir runs/ckpt --clients 20 --batch 32 --requests 8 \\
      --verify-offline

runs on the GPU; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import time

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.core import mlp, tm
from repro_torch.data.ingest import registry as datasets
from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                    checkpointing)
from repro_torch.fl.runtime.codec import CODECS
from repro_torch.fl.serve import ModelRegistry, ServeTelemetry, ServingPlane
from repro_torch.launch.fed_train import STRATEGY_CHOICES, build_scenario


def _offline_predict(strategy, row, x: torch.Tensor) -> torch.Tensor:
    """One client's predictions from its own row, outside the plane."""
    tm_cfg = getattr(strategy, "tm_cfg", None)
    if tm_cfg is not None:
        return tm.predict(row, x, tm_cfg)
    params = getattr(row, "params", row)   # FLIS wraps the MLP
    return mlp.apply(params, x).argmax(-1)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Federated serving plane on PyTorch: personalized "
                    "inference from a versioned model registry")
    # scenario — must match the training run (rebuilds its layout)
    ap.add_argument("--strategy", default="tpfl", choices=STRATEGY_CHOICES)
    ap.add_argument("--dataset", default="synthmnist",
                    choices=datasets.names())
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--encoding", default="bool", metavar="SPEC")
    ap.add_argument("--experiment", type=int, default=5)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--clauses", type=int, default=48)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--probe-size", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain versions)")
    # structural knobs that shape the checkpointed engine state
    ap.add_argument("--codec", default="float32", choices=CODECS)
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--error-feedback", action="store_true",
                    dest="error_feedback")
    ap.add_argument("--buffer-capacity", type=int, default=64,
                    help="the async buffer's entries in the training "
                         "run's state (its --buffer-capacity)")
    # registry / serving
    ap.add_argument("--ckpt-dir", default=None,
                    help="training checkpoint directory; its newest "
                         "round is published into the registry at "
                         "startup")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="registry root (default: <ckpt-dir>/registry)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8,
                    help="number of batches to serve")
    ap.add_argument("--verify-offline", action="store_true",
                    help="after serving, check every client's served "
                         "prediction against its resolved row's offline "
                         "prediction; exit 1 on mismatch")
    ap.add_argument("--telemetry-dir", default=None, metavar="RUN_DIR",
                    help="write serve_events.jsonl (per-batch latency "
                         "and spans, swap/publish events) there")
    args = ap.parse_args(argv)

    device = (devices.default_device() if args.device == "cuda"
              else devices.resolve(args.device))
    if args.registry is None and args.ckpt_dir is None:
        raise SystemExit("need --registry and/or --ckpt-dir: nowhere "
                         "to pull a model from")
    registry_root = args.registry or str(
        pathlib.Path(args.ckpt_dir) / "registry")

    data, _, _, strategy = build_scenario(
        dataset=args.dataset, data_dir=args.data_dir,
        encoding=args.encoding, clients=args.clients, clauses=args.clauses,
        seed=args.seed, experiment=args.experiment,
        local_epochs=args.local_epochs, strategy=args.strategy,
        max_slots=args.max_slots, probe_size=args.probe_size, device=device)
    engine = Engine(strategy, data, RuntimeConfig(
        codec=CodecConfig(args.codec, sparse=args.sparse,
                          error_feedback=args.error_feedback),
        buffer_capacity=args.buffer_capacity))
    # the engine's key chain is k_init, k_rounds = split(PRNGKey(seed))
    k_init = rnd.split(rnd.PRNGKey(args.seed, device))[0]
    like = engine.init(k_init)

    telemetry = ServeTelemetry(args.telemetry_dir) \
        if args.telemetry_dir else None
    registry = ModelRegistry(registry_root)
    if args.ckpt_dir:
        newest = checkpointing.latest(args.ckpt_dir)
        if newest is not None:
            version = registry.publish(newest)
            if telemetry is not None:
                telemetry.publish_event(version, registry.path_for(version))
            print(f"published {newest} as registry version {version}",
                  flush=True)
    if registry.latest() is None:
        raise SystemExit(f"registry {registry_root} is empty and "
                         f"--ckpt-dir offered no checkpoint to publish")

    plane = ServingPlane(engine.strategy, registry, like,
                         telemetry=telemetry)
    plane.refresh()
    n = args.clients
    n_test = int(data.x_test.shape[1])
    print(f"serving {args.strategy} version {plane.active_version} "
          f"[{device}] over "
          f"{n} clients (store=resident): {args.requests} batches of "
          f"{args.batch}", flush=True)

    x_test = data.x_test
    latencies = []
    for r in range(args.requests):
        # stride-round-robin over the population: consecutive lanes hit
        # different clients, so every batch mixes clusters
        ids = (np.arange(args.batch) * 7 + r) % n
        pick = (r + np.arange(args.batch)) % n_test
        x = x_test[torch.as_tensor(ids, device=device),
                   torch.as_tensor(pick, device=device)]
        t0 = time.perf_counter()
        preds = plane.predict(ids, x)       # returns on the host: synced
        latencies.append(time.perf_counter() - t0)
        del preds
        plane.refresh()   # a newer published version warm-swaps here

    lat = sorted(latencies)
    p50 = statistics.median(lat)
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    served = args.requests * args.batch
    total = sum(lat)
    rps = served / total if total > 0 else float("inf")
    print(f"served {served} requests in {total * 1e3:.1f}ms: "
          f"{rps:.0f} req/s, p50={p50 * 1e6:.0f}us "
          f"p99={p99 * 1e6:.0f}us per batch", flush=True)

    result = {"version": plane.active_version, "requests": served,
              "requests_per_s": rps, "p50_s": p50, "p99_s": p99,
              "latencies_s": latencies}

    if args.verify_offline:
        # one covering batch: every client once, each with its own test
        # sample — served predictions must equal the offline (unbatched,
        # per-client) predictions of the resolved rows
        ids = np.arange(n)
        x = x_test[:, 0]
        got = plane.predict(ids, x)
        state = registry.pull(plane.active_version, like)
        rows, _ = plane._resolve_rows(state, ids)
        mismatch = 0
        for c in range(n):
            row = tree.map(lambda a: a[c], rows)
            want = int(_offline_predict(strategy, row, x[c:c + 1])[0])
            if want != int(got[c]):
                mismatch += 1
                print(f"client {c}: served {int(got[c])}, "
                      f"offline {want}", flush=True)
        result["verified_clients"] = n
        result["mismatches"] = mismatch
        if mismatch:
            raise SystemExit(
                f"serving parity FAILED: {mismatch}/{n} clients differ "
                f"from offline predictions")
        print(f"offline parity: OK ({n} clients bit-identical)",
              flush=True)
    return result


if __name__ == "__main__":
    main()
