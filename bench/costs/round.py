"""Least work of one TPFL round: the cohort's local epochs (kernel 1's
count), the confidence votes over D_conf and the population's
evaluation (kernel 2's count), and the aggregation's bytes (the K
uploaded rows read and the C server rows written, float32).  The
gather and scatter of the cohort are left out: a program that trains in
place needs neither."""
from __future__ import annotations

from bench.costs import train_epoch, votes
from bench.costs.common import add


def count(tm: dict, workload: dict) -> dict:
    k, n = workload["cohort"], workload["population"]
    split = workload["per_client"]
    m = tm["n_clauses"]
    epoch = train_epoch.count(tm, k, split["train"])
    agg = {"ops": 0, "bytes": 4 * m * (k + tm["n_classes"])}
    return add(*([epoch] * tm["local_epochs"]),
               votes.count(tm, k, split["conf"]),
               votes.count(tm, n, split["test"]), agg)
