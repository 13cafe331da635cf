"""The federated dry run without XLA: the paper's communication claim on
the production mesh, and the client store at population scale.

Counterpart of ``repro/launch/fed_dryrun.py``, with its flags.  The
reference lowers three round programs for a 16 x 16 (or 2 x 16 x 16)
mesh at paper width (C = 10, m = 300 clauses, o = 784 features, 256
clients over the FSDP axes, a 512-row async buffer) and reads their
collectives from XLA's partitioned HLO (``hlo_analysis.
collective_bytes``).  The port compiles no partitioned program, so
:func:`collectives` prices the same three sections from the abstract
round inputs (:func:`repro_torch.launch.fed_train.abstract_round_inputs`
and :func:`~repro_torch.launch.fed_train.abstract_async_inputs`, ``meta``
tensors with their specs: no card, no allocation), under the
reference's kind names, each labelled ``"collective_source":
"analytic"``:

* ``tpfl``, the engine's shard-mapped sync round with ``psum``: one
  all-reduce of the (C, m) accumulator and its (C,) totals
  (``masked_collectives.collective_payload_bytes``);
* ``tpfl_async``, the shard-mapped async buffered update: one tiled
  all-gather of the round's five upload lanes (n·j rows of the m-float
  payload, slot, maturity round, weight and validity: every device ends
  with all of them), then the same psum;
* ``fedavg_tm``, the legacy full-state mean
  (:func:`~repro_torch.launch.fed_train.make_fedavg_tm_round`): the
  all-reduce of one client's TA state and weights, in the float32 the
  mean is taken in, and of the f32 ``mean_accuracy`` (4 bytes), when the
  clients span more than one device (XLA drops it over one device; the
  shard-mapped rounds keep their explicit collectives even there).

``tests/test_torch_fed_dryrun.py`` holds each section to XLA's bytes for
the reference's three programs on forced 8-device CPU meshes, kind by
kind.  ``fedavg_over_tpfl`` is the ratio of the two rounds' bytes.
``collective_s`` prices the bytes over the link a world of that many
cards crosses (:func:`repro_torch.launch.dryrun.link_for`: one NDR
400 Gb/s port a card past one node), named in ``link``.  XLA's
``compile_s`` is left out.

:func:`client_scale` is the reference's host-side section: where the K
rows of a round come from when the population is a million simulated
clients.  A :class:`~repro_torch.fl.store.ClientStore` sized for N
clients holds TM rows drawn by ``TPFLStrategy.init_cohort`` (the
fault-in path the mmap engine wires), and one K-row gather → change →
spill → flush cycle is timed end to end, then read back.  Its meters
are the reference's: ``row_bytes``, ``resident_rows`` and
``resident_bytes`` (only the rows written take space; the rest are holes
in sparse files), ``io_read_bytes``, ``io_written_bytes`` and
``roundtrip_ok``.  It draws on the card unless ``--device cpu``; the
sections need none (``--skip-client-scale`` runs them alone).  JSON is
written only under ``--out DIR``.

  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun [--multi-pod] \\
      [--clients 256] [--buffer-capacity 512] [--skip-client-scale | \\
       --population 1000000 --active 256 --device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core import federation, tm
from repro_torch.fl.masked_collectives import collective_payload_bytes
from repro_torch.fl.runtime.strategy import TPFLStrategy
from repro_torch.fl.store import ClientStore, client_store
from repro_torch.launch import fed_train, hlo_analysis
from repro_torch.launch.dryrun import link_for
from repro_torch.launch.mesh import make_production_mesh

SECTIONS = ("tpfl", "tpfl_async", "fedavg_tm")
MEAN_ACCURACY_BYTES = 4          # the f32 mean over the clients' devices
FEDAVG_NOT_COUNTED = (
    "collectives XLA's partitioner may add beyond the round's data: the "
    "reference's 16x16 record (benchmarks/artifacts/fed_dryrun_16x16.json) "
    "holds 2,048 more all-reduce and 320 collective-permute bytes, which "
    "the same program lowered by jax 0.9.0 on a forced 256-device CPU mesh "
    "does not move")


def _whole_bytes(a) -> int:
    """The bytes of an abstract array as a whole (every device's block)."""
    return math.prod(a.shape) * a.value.element_size()


def _section(breakdown: dict[str, int], chips: int) -> dict:
    coll = dict.fromkeys(hlo_analysis.COLLECTIVES, 0)
    coll.update(breakdown)
    total = sum(coll.values())
    link, link_bw = link_for(chips)
    return {"collective_bytes_per_device": total,
            "collective_s": total / link_bw, "link": link,
            "breakdown": coll, "collective_source": "analytic"}


def collectives(tm_cfg: tm.TMConfig, fed_cfg: federation.FedConfig, mesh,
                buffer_capacity: int = 512, **data_kw) -> dict[str, dict]:
    """Each section's per-device collective bytes on ``mesh`` (module
    docstring).  Raises ``SystemExit`` where the client count does not
    divide the mesh's FSDP axes, as the reference does."""
    params, _, _, _, _, _, client_axes = fed_train.abstract_round_inputs(
        tm_cfg, fed_cfg, mesh, **data_kw)
    if client_axes is None:
        raise SystemExit(f"{fed_cfg.n_clients} clients do not divide the "
                         f"mesh's FSDP axes — pick a multiple")
    j = fed_cfg.top_classes
    C, m = tm_cfg.n_classes, tm_cfg.n_clauses
    psum = collective_payload_bytes("psum", fed_cfg.n_clients * j, m, C)
    _, up, _, _, _ = fed_train.abstract_async_inputs(
        tm_cfg, fed_cfg, mesh, capacity=buffer_capacity, j_slots=j)
    names = client_axes if isinstance(client_axes, tuple) else (client_axes,)
    state = mean_acc = 0
    if math.prod(mesh.shape[a] for a in names) > 1:
        # one client's block of each state leaf, as the f32 mean sums it
        state = sum(math.prod(p.shape[1:]) * 4 for p in params)
        mean_acc = MEAN_ACCURACY_BYTES
    out = {
        "tpfl": _section({"all-reduce": psum}, mesh.size),
        "tpfl_async": _section(
            {"all-gather": sum(_whole_bytes(a) for a in up),
             "all-reduce": psum}, mesh.size),
        "fedavg_tm": _section({"all-reduce": state + mean_acc}, mesh.size),
    }
    out["fedavg_tm"].update(payload_bytes=state,
                            mean_accuracy_bytes=mean_acc,
                            not_counted=FEDAVG_NOT_COUNTED)
    return out


def run(multi_pod: bool = False, n_clients: int = 256, clauses: int = 300,
        buffer_capacity: int = 512) -> dict:
    """The three sections at paper width on the production mesh, and
    ``fedavg_over_tpfl``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    tm_cfg = tm.TMConfig(n_classes=10, n_clauses=clauses, n_features=784,
                         n_states=127, s=10.0, T=1000)
    fed_cfg = federation.FedConfig(n_clients=n_clients, rounds=1,
                                   local_epochs=1)
    result = {"mesh": mesh.name, "n_clients": n_clients, "clauses": clauses,
              "buffer_capacity": buffer_capacity}
    result.update(collectives(tm_cfg, fed_cfg, mesh, buffer_capacity,
                              n_train=64, n_test=32, n_conf=32))
    for name in SECTIONS:
        total = result[name]["collective_bytes_per_device"]
        print(f"{name:10s}: {total/1e6:.3f} MB/device collectives "
              f"(analytic, {result[name]['link']})", flush=True)
    if result["tpfl"]["collective_bytes_per_device"]:
        result["fedavg_over_tpfl"] = (
            result["fedavg_tm"]["collective_bytes_per_device"]
            / result["tpfl"]["collective_bytes_per_device"])
        print(f"FedAvg-TM moves {result['fedavg_over_tpfl']:.1f}× the "
              f"collective bytes of TPFL", flush=True)
    return result


def client_scale(n_total: int = 1_000_000, k_active: int = 256,
                 device=None, root: str | None = None) -> dict:
    """One K-active gather → change → spill → flush cycle over a store of
    ``n_total`` TM rows (10 classes, 16 clauses, 64 features) under
    ``root`` (a fresh temporary directory without one); the init is
    drawn on ``device`` (the GPU unless the caller names another)."""
    device = devices.resolve(device)
    strat = TPFLStrategy(tm.TMConfig(n_classes=10, n_clauses=16,
                                     n_features=64, n_states=63, s=5.0,
                                     T=16), local_epochs=1)
    key = rnd.PRNGKey(0, device)

    def init_fn(ids):
        return client_store.tree_map(
            client_store.to_host, strat.init_cohort(key, ids, n_total))

    row = client_store.tree_map(lambda a: a[0],
                                init_fn(np.zeros((1,), np.int64)))
    store = ClientStore(root or tempfile.mkdtemp(
        prefix="dryrun_client_store_"), n_total, {"cs": row},
        init_fn=lambda ids: {"cs": init_fn(ids)})
    ids = rnd.choice(rnd.PRNGKey(1, device), n_total,
                     k_active).cpu().numpy()
    t0 = time.time()
    bundle = store.gather(ids)                    # faults K rows in
    bundle = client_store.tree_map(lambda a: (a + 1).astype(a.dtype),
                                   bundle)
    store.spill(ids, bundle)                      # the round's write-back
    store.flush()
    wall = time.time() - t0
    back = store.gather(ids)                      # read back
    ok = all(bool(np.array_equal(a, b)) for a, b in zip(
        client_store.flatten(bundle)[0], client_store.flatten(back)[0]))
    section = {
        "n_clients": n_total, "k_active": k_active,
        "row_bytes": store.row_nbytes,
        "resident_rows": store.written_count(),
        "resident_bytes": store.written_count() * store.row_nbytes,
        "gather_spill_s": round(wall, 3),
        "io_read_bytes": store.io_read_bytes,
        "io_written_bytes": store.io_written_bytes,
        "roundtrip_ok": ok,
    }
    print(f"client_scale: {k_active} of {n_total} rows resident "
          f"({section['resident_bytes']/1e6:.1f} MB of "
          f"{n_total*store.row_nbytes/1e9:.0f} GB virtual), "
          f"gather+spill {section['gather_spill_s']}s", flush=True)
    return section


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="the federated round's collectives on the production "
                    "mesh, priced analytically, and the client store at "
                    "population scale")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--clients", type=int, default=256,
                    help="clients of the mesh round (a multiple of the "
                         "FSDP axes: 16, or 32 multi-pod)")
    ap.add_argument("--buffer-capacity", type=int, default=512)
    ap.add_argument("--population", type=int, default=1_000_000,
                    help="client_scale: simulated clients in the store")
    ap.add_argument("--active", type=int, default=256,
                    help="client_scale: rows gathered and spilled")
    ap.add_argument("--device", default="cuda",
                    help="where client_scale draws the rows' init "
                         "(cuda or cpu)")
    ap.add_argument("--store-dir", default=None, metavar="DIR")
    ap.add_argument("--skip-client-scale", action="store_true",
                    help="the analytic sections alone (no card needed)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write fed_dryrun_<mesh>.json here")
    args = ap.parse_args(argv)
    device = None
    if not args.skip_client_scale:     # refuse a card-less host up front
        device = (devices.default_device() if args.device == "cuda"
                  else args.device)
    out = run(multi_pod=args.multi_pod, n_clients=args.clients,
              buffer_capacity=args.buffer_capacity)
    if device is not None:
        out["client_scale"] = client_scale(args.population, args.active,
                                           device, args.store_dir)
    if args.out is not None:
        path = Path(args.out)
        path.mkdir(parents=True, exist_ok=True)
        (path / f"fed_dryrun_{out['mesh']}.json").write_text(
            json.dumps(out, indent=2))
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
