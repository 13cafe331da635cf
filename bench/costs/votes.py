"""Least work of one fused-votes call over N clients of B samples
(kernel 2, ``votes_mma_kernel``): the confidence pass and the
population's evaluation.

* operations: every sample against every clause of every class, L 0/1
  multiply-adds a clause (two operations each, int8 tensor cores), and
  the clause weights' multiply-adds into the C votes;
* bytes: the include bit of each literal (one bit: the least that tells
  whether a literal is included), the weights at 16 bits, the samples'
  o bits, and the (B, C) votes written at 4 bytes.
"""
from __future__ import annotations


def count(tm: dict, n: int, b: int) -> dict:
    C, m, o = tm["n_classes"], tm["n_clauses"], tm["n_features"]
    L = 2 * o
    ops = 2 * n * b * C * m * L + 2 * n * b * C * m
    byt = n * C * m * L / 8 + n * C * m * 2 + n * b * o / 8 + n * b * C * 4
    return {"ops": ops, "bytes": byt}
