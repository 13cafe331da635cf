"""Least work of one local epoch of N clients (kernel 1, the fused
epoch), from the configuration's shapes alone.

Each of the S samples of a client updates two classes, its label and
one negative class (``cls2``).  Counted:

* operations: each class's clause outputs, m clauses of L = 2o literals
  tested against the sample, as 0/1 multiply-adds (two operations each)
  that int8 tensor cores could run: ``2 · N · S · 2 · m · L``;
* bytes: the epoch's TA states read and written once at the bits that
  hold a state (7 bits for n_states = 63), the weights read and written
  at 16 bits, the samples' o bits and labels read once.

Left out, since their amount follows the data: the Type I and II
updates and the threefry draws of the Type I rows (its coins).
"""
from __future__ import annotations

from bench.costs.common import class_bits, state_bits


def count(tm: dict, n: int, s: int) -> dict:
    C, m, o = tm["n_classes"], tm["n_clauses"], tm["n_features"]
    L = 2 * o
    ops = 2 * n * s * 2 * m * L
    ta = n * C * m * L * state_bits(tm["n_states"]) / 8
    byt = 2 * ta + 2 * n * C * m * 2 + n * s * (o + class_bits(C)) / 8
    return {"ops": ops, "bytes": byt}
