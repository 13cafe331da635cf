"""XLA's collective bytes for the JAX package's three federated round
programs, the numbers ``repro_torch.launch.fed_dryrun`` prices without
XLA.

Lowers and compiles, as ``repro/launch/fed_dryrun.py``'s ``run`` does,
the engine's shard-mapped sync round (``build_sharded_round``, psum), the
shard-mapped async buffered update (``build_sharded_async_update``) and
the legacy FedAvg-TM round (``make_fedavg_tm_round``) on forced host CPU
devices, and reads each program's collectives with
``hlo_analysis.collective_bytes``.  Prints one JSON line,
``{"<case>/<program>": {kind: bytes}}``.

  JAX_PLATFORMS=cpu PYTHONPATH=src python tools/fed_dryrun_xla.py [SPEC]

SPEC is a JSON object: ``tm`` (TMConfig keywords), ``n`` (clients),
``cap`` (buffer rows), ``data`` (``n_train`` / ``n_test`` / ``n_conf``)
and ``cases`` (each an ``id``, the mesh's ``sizes`` and ``names`` and
``j``, the top classes shared).  Without one: the reference's paper
width (C = 10, m = 300, o = 784, 256 clients, 512 rows) on 16 x 16 and
2 x 16 x 16, which forces 512 devices (about 20 s on 8 cores).
``tests/test_torch_fed_dryrun.py`` runs it at a reduced width on 8.
"""
import json
import math
import os
import sys

PAPER = {
    "tm": dict(n_classes=10, n_clauses=300, n_features=784, n_states=127,
               s=10.0, T=1000),
    "n": 256, "cap": 512, "data": dict(n_train=64, n_test=32, n_conf=32),
    "cases": [dict(id="16x16", sizes=[16, 16], names=["data", "model"],
                   j=1),
              dict(id="2x16x16", sizes=[2, 16, 16],
                   names=["pod", "data", "model"], j=1)]}


def main(spec: dict) -> dict:
    devices = max(math.prod(c["sizes"]) for c in spec["cases"])
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devices}"
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.core import federation, tm
    from repro.fl.runtime.executors import (build_sharded_async_update,
                                            build_sharded_round)
    from repro.launch import fed_train, hlo_analysis
    from repro.sharding import compat

    out = {}
    for case in spec["cases"]:
        n_dev = math.prod(case["sizes"])
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]).reshape(case["sizes"]),
                    tuple(case["names"]))
        tm_cfg = tm.TMConfig(**spec["tm"])
        fed_cfg = federation.FedConfig(n_clients=spec["n"], rounds=1,
                                       local_epochs=1, top_classes=case["j"])
        params, cw, data, key, keys, arrive, axes = \
            fed_train.abstract_round_inputs(tm_cfg, fed_cfg, mesh,
                                            **spec["data"])
        strategy = federation._strategy(tm_cfg, fed_cfg)
        buf, up, round_idx, prev, _ = fed_train.abstract_async_inputs(
            tm_cfg, fed_cfg, mesh, capacity=spec["cap"],
            j_slots=strategy.j_slots)
        programs = (
            ("tpfl", build_sharded_round(strategy, mesh, axis_name=axes,
                                         collective="psum",
                                         n_clients=spec["n"]),
             (params, cw, data, keys, arrive)),
            ("tpfl_async", build_sharded_async_update(
                strategy, mesh, axis_name=axes, collective="psum",
                min_uploads=4, n_valid=spec["n"] * strategy.j_slots),
             (buf, up, round_idx, prev)),
            ("fedavg_tm", fed_train.make_fedavg_tm_round(tm_cfg, fed_cfg),
             (params, data, key)))
        with compat.set_mesh(mesh):
            for name, build, args in programs:
                text = jax.jit(build).lower(*args).compile().as_text()
                out[f"{case['id']}/{name}"] = \
                    hlo_analysis.collective_bytes(text)
    return out


if __name__ == "__main__":
    print(json.dumps(main(json.loads(sys.argv[1]) if len(sys.argv) > 1
                          else PAPER)))
