"""The order in which this host's XLA:CPU sums the reference's aggregate.

``repro/core/clustering.py::aggregate`` sums uploads with the one-hot
product ``onehot.T @ uploads``, an eager ``jit_matmul`` that XLA:CPU
hands to its matrix library; the order of the adds depends on the shape
(clusters C, rows n, features m).  This script classifies that order
shape by shape, on non-integer uploads ``q·scale`` (q int8) spread over
three clusters, against two candidate orders:

* ``4``: four lanes (row r into lane r mod 4 for the first n − n % 4
  rows), reduced as (l0 + l1) + (l2 + l3), plus the last n % 4 rows
  summed apart and added last;
* ``S``: row order;
* ``-``: neither.

It prints one line per (C, m): the class at each n.  The port's
``repro_torch.core.clustering.four_lanes`` is the table read off this
output.  Run on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_dot_order.py \\
        --clusters 10,62 --features 2,8,16,17,48,300 --rows 4:49
"""
from __future__ import annotations

import argparse

import numpy as np


def xla_sums(up: np.ndarray, ids: np.ndarray, n_clusters: int) -> np.ndarray:
    """``onehot.T @ uploads`` as the reference computes it, eagerly."""
    import jax
    import jax.numpy as jnp
    onehot = jax.nn.one_hot(jnp.asarray(ids), n_clusters, dtype=jnp.float32)
    return np.asarray(onehot.T @ jnp.asarray(up))


def ordered_sums(up: np.ndarray, ids: np.ndarray, n_clusters: int,
                 lanes: bool) -> np.ndarray:
    """The per-cluster sums in four lanes or in row order, float32."""
    n, m = up.shape
    acc = np.zeros((5, n_clusters, m), np.float32)
    whole = n - n % 4
    for r in range(n):
        lane = (r % 4 if r < whole else 4) if lanes else 0
        acc[lane, ids[r]] = (acc[lane, ids[r]] + up[r]).astype(np.float32)
    if not lanes:
        return acc[0]
    red = ((acc[0] + acc[1]).astype(np.float32)
           + (acc[2] + acc[3]).astype(np.float32)).astype(np.float32)
    return (red + acc[4]).astype(np.float32)


def classify(n_clusters: int, n: int, m: int, trials: int = 2,
             seed: int = 0) -> str:
    """"4", "S" or "-" (module docstring); where both orders match every
    trial (fewer than 4 rows, or sums that no order moves), "4"."""
    rng = np.random.default_rng(seed + 1000 * n + m + 7 * n_clusters)
    ok = {"4": True, "S": True}
    for _ in range(trials):
        q = rng.integers(-127, 128, (n, m)).astype(np.float32)
        up = (q * np.float32(rng.uniform(0.001, 0.5))).astype(np.float32)
        pick = rng.permutation(n_clusters)[:min(n_clusters, 3)]
        ids = pick[rng.integers(0, len(pick), n)].astype(np.int32)
        want = xla_sums(up, ids, n_clusters)
        live = np.bincount(ids, minlength=n_clusters) > 0
        for name, lanes in (("4", True), ("S", False)):
            got = ordered_sums(up, ids, n_clusters, lanes)
            ok[name] &= bool(np.array_equal(got[live], want[live]))
    return "4" if ok["4"] else "S" if ok["S"] else "-"


def _ints(spec: str) -> list[int]:
    if ":" in spec:
        lo, hi = spec.split(":")
        return list(range(int(lo), int(hi)))
    return [int(v) for v in spec.split(",")]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", default="10,62")
    ap.add_argument("--features", default="2:25")
    ap.add_argument("--rows", default="4:49")
    args = ap.parse_args(argv)
    rows = _ints(args.rows)
    print(f"rows {rows[0]}..{rows[-1]}", flush=True)
    for c in _ints(args.clusters):
        for m in _ints(args.features):
            print(f"C={c:3d} m={m:4d} "
                  + "".join(classify(c, n, m) for n in rows), flush=True)


if __name__ == "__main__":
    main()
