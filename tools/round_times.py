"""Time the port's training-path rounds and its aggregate on the GPU.

Builds the full-width scenario (20 clients, 300 clauses, the mnist
mirror written under ``REPO/build/probe_data``) with the ``repro_torch``
of the checkout at ``REPO``, runs nine rounds of the float32 training
path (host clock, synced, round 0 with its first-call costs), times
``clustering.aggregate`` of 20 x 300 integer uploads into 10 slots (50
calls, synced once), and lists the top ops by host time of one profiled
round.  To compare two checkouts, run it on each in one machine, in
alternation:

    python3 tools/round_times.py PARENT_CHECKOUT parent
    python3 tools/round_times.py CHANGE_CHECKOUT change
"""
import statistics
import sys
import time
from pathlib import Path

root = Path(sys.argv[1]).resolve()
tag = sys.argv[2]
sys.path.insert(0, str(root / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import clustering  # noqa: E402
from repro_torch.data.ingest import mirror  # noqa: E402
from repro_torch.fl.runtime import Engine, RuntimeConfig  # noqa: E402
from repro_torch.launch import fed_train  # noqa: E402

dev = torch.device("cuda")
data_dir = root / "build" / "probe_data"
if not (data_dir / "mnist").exists():
    mirror.write_idx_mirror(data_dir / "mnist", "synthmnist", 6000, 28, 0,
                            device=dev)
data, _, _, strat = fed_train.build_scenario(
    dataset="mnist", data_dir=str(data_dir), clients=20, clauses=300,
    device=dev)
eng = Engine(strat, data, RuntimeConfig(rounds=1))
state = eng.init(rnd.PRNGKey(0, dev))
k = rnd.split(rnd.PRNGKey(0, dev))[1]
times = []
for r in range(9):
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = eng.run_round(state, rnd.fold_in(k, r))
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t)
print(f"{tag}: rounds (ms) {[round(x * 1e3, 2) for x in times]}; median "
      f"of 1-8 {statistics.median(times[1:]) * 1e3:.2f}")
up = torch.as_tensor(np.random.default_rng(0).integers(
    0, 40, (20, 300)).astype(np.float32), device=dev)
ids = torch.as_tensor(np.random.default_rng(1).integers(
    -1, 10, 20).astype(np.int32), device=dev)
for _ in range(3):
    clustering.aggregate(up, ids, 10)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(50):
    clustering.aggregate(up, ids, 10)
torch.cuda.synchronize()
print(f"{tag}: aggregate of 20 x 300 into 10 slots: "
      f"{(time.perf_counter() - t) / 50 * 1e3:.3f} ms a call (host clock, "
      f"synced after 50)")
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run_round(state, rnd.fold_in(k, 9))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
print(f"{tag}: profiled round wall {wall * 1e3:.1f} ms; top ops by self "
      f"CPU time:")
for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total
                )[:12]:
    print(f"   {e.self_cpu_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
          f"{e.key[:60]}")
