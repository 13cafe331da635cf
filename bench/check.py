"""The comparison that decides ``correct``.

The TM is integers and its round is exact: every number compared counts
the elements in which the program's output differs from the reference's
(bit for bit, floats included), and every limit is 0.  The numbers
cover each layer a round passes through:

* ``cohort``: sampled client ids (the scheduler);
* ``ta_states``: the cohort's TA states after the round (key chain and
  kernel 1's local training);
* ``weights``: every client's clause weights (training, the top-class
  upload, the broadcast merge and the scatter into the population);
* ``server``: the server's rows (kernel 2's confidence, the strategy's
  pick, the aggregation and the server update);
* ``cluster_counts``, ``assignment``: the clusters and who applied them;
* ``accuracy``: every client's test accuracy (the population's
  evaluation by kernel 2);
* ``ta_row_sums``: each client's TA-state sum (the scatter);
* ``bytes``: the summed absolute gaps of the upload and download byte
  counts and the aggregated uploads;
* ``cycles_differing``: cycles, of the window's and the checked one
  after it, whose last round's accuracies or cluster counts differ from
  the window's first cycle's (every cycle repeats the same work).

The checked cycle's first ``reference_rounds`` rounds are compared, and
each number is summed over them.
"""
from __future__ import annotations

import torch

NAMES = ("cohort", "ta_states", "weights", "server", "cluster_counts",
         "assignment", "accuracy", "ta_row_sums", "bytes",
         "cycles_differing")
_INTS = ("upload_bytes", "download_bytes_broadcast",
         "download_bytes_per_client", "aggregated_uploads")


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    a, b = a.to(b.device), b
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    if a.is_floating_point() or b.is_floating_point():
        a, b = a.to(torch.float32), b.to(torch.float32)
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return int((a.to(torch.int64) != b.to(torch.int64)).sum())


def compare(got: dict, want: dict, cycles_differing: int) -> dict:
    """``{name: {"value": n, "limit": 0}}`` in :data:`NAMES` order."""
    vals = {
        "cohort": _differ(got["idx"], want["idx"]),
        "ta_states": _differ(got["cohort_ta"], want["cohort_ta"]),
        "weights": _differ(got["w"], want["w"]),
        "server": _differ(got["server"], want["server"]),
        "cluster_counts": _differ(got["counts"], want["counts"]),
        "assignment": _differ(got["assignment"], want["assignment"]),
        "accuracy": _differ(got["acc"], want["acc"]),
        "ta_row_sums": _differ(got["ta_rowsum"], want["ta_rowsum"]),
        "bytes": sum(abs(int(got[k]) - int(want[k])) for k in _INTS),
        "cycles_differing": int(cycles_differing),
    }
    return {k: {"value": vals[k], "limit": 0} for k in NAMES}


def add(a: dict | None, b: dict) -> dict:
    """Two rounds' numbers summed, name by name."""
    if a is None:
        return b
    return {k: {"value": a[k]["value"] + b[k]["value"],
                "limit": b[k]["limit"]} for k in b}


def passed(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
