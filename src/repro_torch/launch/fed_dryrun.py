"""The federated dry run's host-side section: the client store at
population scale.

Counterpart of ``repro/launch/fed_dryrun.py``'s :func:`client_scale`:
where the K rows of a round come from when the population is a million
simulated clients.  A :class:`~repro_torch.fl.store.ClientStore` sized
for N clients holds TM rows drawn by ``TPFLStrategy.init_cohort`` (the
fault-in path the mmap engine wires), and one K-row gather → change →
spill → flush cycle is timed end to end, then read back.  The meters
are the reference's: ``row_bytes``, ``resident_rows`` and
``resident_bytes`` (only the rows written take space; the rest are
holes in sparse files), ``io_read_bytes``, ``io_written_bytes`` and
``roundtrip_ok``.

The reference's other sections (``tpfl``, ``tpfl_async``,
``fedavg_tm``) lower the round programs for a 16 x 16 TPU mesh and
price their collectives in XLA's partitioned HLO
(``hlo_analysis.collective_bytes``).  ``torch.distributed`` compiles no
partitioned program to read: the port's collectives are explicit calls,
metered as they run (``masked_collectives.CollectiveMeter``, predicted
by ``collective_payload_bytes``), so those sections have no analogue
here and none is imitated.  The round constructors they lower
(``make_tpfl_round``, ``make_fedavg_tm_round``, the ``abstract_*``
inputs) are ROADMAP queue A9.2 items 4–5, still to port.

  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun \\
      [--clients 1000000] [--active 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core import tm
from repro_torch.fl.runtime.strategy import TPFLStrategy
from repro_torch.fl.store import ClientStore, client_store


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
        description="the client store at population scale (the dry run's "
                    "host-side section)")
    ap.add_argument("--clients", type=int, default=1_000_000)
    ap.add_argument("--active", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the rows' init is drawn (cuda or cpu)")
    ap.add_argument("--store-dir", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    out = {"client_scale": client_scale(
        args.clients, args.active,
        devices.default_device() if args.device == "cuda" else args.device,
        args.store_dir)}
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
