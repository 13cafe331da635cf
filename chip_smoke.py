"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), timed;
3. hold each kernel against its plain PyTorch version on the card,
   exactly, at the paper's TM width (20 clients, C = 10, m = 300,
   L = 1568: fused votes at B = 40, one fused epoch at S = 80) and at one
   tile-unaligned shape each;
4. run the port's ``fed_train`` at full width (mnist 28x28, 300 clauses,
   20 clients, 2 rounds of 2 local epochs) with the launch counters set
   to 0 just before, printing its round lines, and check its output;
5. require every kernel of that path to have launched, and check a small
   federation on the card against the same federation on the CPU;
6. time each kernel at the main path's shapes with CUDA events, beside
   its plain version, a one-call PyTorch yardstick where one exists, and
   the bound from bytes and operations;
7. profile one more full-width round (device busy share, top ops), then
   print the kernel times as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12          # tensor-core int8, for 8-bit {0,1} work
FP32_OPS_PER_S = 67e12            # 32-bit work outside the tensor cores

MAIN_ARGS = ["--dataset", "mnist", "--clauses", "300", "--clients", "20",
             "--rounds", "2", "--local-epochs", "2", "--device", "cuda"]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def vote_inputs(gen, N, C, m, L, B, device):
    import torch
    include = torch.rand((N, C, m, L), generator=gen, device=device) < 2.0 / L
    include[:, :, ::5] = False                     # empty clauses
    lits = torch.randint(0, 2, (N, B, L), generator=gen, device=device,
                         dtype=torch.int32)
    wpol = torch.randint(-7, 8, (N, C, m), generator=gen, device=device,
                         dtype=torch.int32)
    return include, lits, wpol


def epoch_inputs(gen, N, S, C, m, L, n_states, device):
    """Near-boundary TA banks with a few included literals per clause,
    weights, literals, and one epoch's real draws."""
    import torch
    from repro_torch import random as rnd
    from repro_torch.kernels import draws
    ta = torch.randint(n_states - 3, n_states + 1, (N, C, m, L),
                       generator=gen, device=device, dtype=torch.int32)
    inc = torch.rand((N, C, m, L), generator=gen, device=device) < 3.0 / L
    ta[inc] += 4
    w = torch.randint(0, 5, (N, C, m), generator=gen, device=device,
                      dtype=torch.int32)
    x = (torch.rand((N, S, L // 2), generator=gen, device=device) < 0.4
         ).to(torch.int32)
    lits = torch.cat([x, 1 - x], -1).contiguous()
    ys = torch.randint(0, C, (N, S), generator=gen, device=device,
                       dtype=torch.int32)
    keys = rnd.split(rnd.PRNGKey(int(torch.randint(0, 1 << 30, (1,),
                                                   generator=gen, device=device
                                                   ).item()), device), N)
    offs, u_act, coin = draws.epoch_draws(keys, S, m, L, C, 0.8, 0.2)
    cls2 = torch.stack([ys, (ys + offs) % C], -1).contiguous()
    return ta, w, lits, cls2, u_act, coin


def profile_round(engine, state, key) -> None:
    """Run one round under torch.profiler and print the device's busy
    share of the round's wall time and the ops with the most device
    time.  The profiler's own overhead lengthens the wall time, so the
    busy share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.run_round(state, key)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernels are the device-side events; the ops that launched them
    # carry the same device time, so only one of the two is summed
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if e.device_type != DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled round: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f} %) in "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} "
              f"{e.key[:70]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.core import tm
    from repro_torch.data import partition, synthetic
    from repro_torch.fl.runtime import (Engine, RuntimeConfig,
                                        TPFLStrategy)
    from repro_torch.kernels import _build, draws, ops, ref
    from repro_torch.launch import fed_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # 3. kernels against their plain versions, exactly
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err = {"fused_votes_batched": 0, "train_epoch_fused": 0}
    for shape in ((20, 10, 300, 1568, 40), (3, 3, 33, 130, 7)):
        args = vote_inputs(gen, *shape, dev)
        for predict in (True, False):
            got = ops.fused_votes_batched(*args, predict)
            want = ref.fused_votes_batched_ref(*args, predict)
            torch.cuda.synchronize()
            diff = int((got - want).abs().max())
            err["fused_votes_batched"] = max(err["fused_votes_batched"], diff)
            fired = int((want != 0).sum())
            print(f"check fused_votes_batched {shape} predict={predict}: "
                  f"max_abs_err={diff} nonzero_votes={fired}", flush=True)
            if diff != 0 or not torch.equal(got, want):
                raise SystemExit("fused_votes_batched disagrees with its "
                                 "plain version")
    for N, S, C, m, L in ((20, 80, 10, 300, 1568), (4, 17, 3, 33, 130)):
        args = epoch_inputs(gen, N, S, C, m, L, 63, dev)
        got = ops.train_epoch_fused(*args, n_states=63, T=40)
        want = ref.train_epoch_ref(*args, n_states=63, T=40)
        torch.cuda.synchronize()
        diff = max(int((g - w).abs().max()) for g, w in zip(got, want))
        err["train_epoch_fused"] = max(err["train_epoch_fused"], diff)
        moved = int((want[0] != args[0]).sum())
        print(f"check train_epoch_fused N={N} S={S} C={C} m={m} L={L}: "
              f"max_abs_err={diff} ta_changed={moved}", flush=True)
        if diff != 0 or moved == 0:
            raise SystemExit("train_epoch_fused disagrees with its plain "
                             "version (or changed nothing)")
        del args, got, want

    # 4. the main path at full width, through the CLI entry point
    round_s = []
    run_round = Engine.run_round

    def timed_round(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_round(self, *a, **kw)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t)
        return out

    Engine.run_round = timed_round
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    try:
        result = fed_train.main(MAIN_ARGS)
        torch.cuda.synchronize()
    finally:
        Engine.run_round = run_round
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {wall:.2f}s wall for 2 rounds (rounds "
          f"{[round(s, 3) for s in round_s]} s), peak device memory "
          f"{peak / 2**30:.2f} GiB, launches {launches}", flush=True)

    # 5. the path went through every kernel, and its output is sane
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"{name} never launched on the main path")
    state = result["state"]
    for rep in result["reports"]:
        acc = rep.per_client_accuracy
        if acc.shape != (20,) or not bool(torch.isfinite(acc).all()) \
                or not bool(((acc >= 0) & (acc <= 1)).all()):
            raise SystemExit(f"round {rep.round_idx}: bad accuracies {acc}")
    ta, w = state.client_state
    if ta.shape != (20, 10, 300, 1568) or int(ta.min()) < 1 \
            or int(ta.max()) > 126 or int(w.min()) < 0:
        raise SystemExit("final client state out of range")

    # Alg. 1 as written, and the §7 multi-cluster, thresholded,
    # weighted-confidence variant
    x, y, _ = synthetic.make_pool("synthmnist", 400, seed=0)
    cfg = tm.TMConfig(n_classes=10, n_clauses=16, n_features=144,
                      n_states=63, s=5.0, T=40)
    for kw in ({}, dict(top_classes=2, conf_threshold=2.0,
                        weighted_confidence=True)):
        small = []
        for d in ("cpu", "cuda"):
            data = partition.partition(x, y, 10, n_clients=4, experiment=5,
                                       seed=1, n_train=16, n_test=8,
                                       n_conf=8, device=d)
            eng = Engine(TPFLStrategy(cfg, local_epochs=2, **kw), data,
                         RuntimeConfig(rounds=2))
            st, reps = eng.run(rnd.PRNGKey(5, d))
            small.append(convert.to_numpy(
                [*st.client_state, st.server.slots,
                 *(r.per_client_accuracy for r in reps),
                 *(r.assignment for r in reps)])
                + [[r.upload_bytes for r in reps]])
        if not all(np.array_equal(a, b) for a, b in zip(*small)):
            raise SystemExit(f"small federation {kw}: GPU and CPU runs "
                             f"disagree")
        print(f"check small federation {kw}: GPU == CPU bit for bit",
              flush=True)

    # 6. times at the main path's shapes
    cfg = tm.TMConfig(n_classes=10, n_clauses=300, n_features=784,
                      n_states=63, s=5.0, T=40)
    data, _, _, strategy = fed_train.build_scenario(
        dataset="mnist", clients=20, clauses=300, device=dev)
    include = tm.include_mask(state.client_state, cfg)
    lits = tm.literals(data.x_test)
    wpol = tm.clause_polarity(cfg, dev) * state.client_state.weights
    N, C, m, L = include.shape
    B = lits.shape[1]
    votes = (include, lits, wpol)
    k2_ms = cuda_ms(lambda: ops.fused_votes_batched(*votes), reps=20)
    k2_plain = cuda_ms(lambda: ref.fused_votes_batched_ref(*votes), reps=5)
    nlit_f = (1 - lits).to(torch.float32)
    inc_f = include.reshape(N, C * m, L).to(torch.float32).transpose(1, 2)
    k2_lib = cuda_ms(lambda: torch.bmm(nlit_f, inc_f), reps=20)
    del nlit_f, inc_f
    k2_bytes = N * C * m * L + N * B * L + 4 * N * C * m + 4 * N * B * C
    k2_ops = 2 * N * B * C * m * L
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / INT8_OPS_PER_S)

    S = data.x_train.shape[1]
    ekeys = rnd.split(rnd.split(rnd.PRNGKey(1, dev), N), 2)[:, 0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    offs, u_act, coin = draws.epoch_draws(ekeys, S, m, L, C, 0.8, 0.2)
    torch.cuda.synchronize()
    draws_ms = (time.perf_counter() - t) * 1e3
    ys = data.y_train.to(torch.int32)
    epoch = (state.client_state.ta_state, state.client_state.weights,
             tm.literals(data.x_train).contiguous(),
             torch.stack([ys, (ys + offs) % C], -1).contiguous(), u_act, coin)
    del offs, u_act, coin
    k1_ms = cuda_ms(lambda: ops.train_epoch_fused(*epoch, n_states=63,
                                                   T=40), reps=5)
    k1_plain = cuda_ms(lambda: ref.train_epoch_ref(*epoch, n_states=63,
                                                   T=40), reps=1, warmup=0)
    # coins are read only on the rows that take Type I feedback
    stats = {}
    ref.train_epoch_ref(*epoch, n_states=63, T=40, stats=stats)
    k1_bytes = (2 * 4 * N * C * m * L + 2 * 4 * N * C * m + 4 * N * S * L
                + 4 * N * S * 2 + 4 * N * S * 2 * m
                + stats["type1_rows"] * L)
    k1_ops = 2 * (2 * S) * N * m * L          # every step evaluates m·L
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S)
    print(f"epoch_draws (plain torch, one epoch, N={N} S={S}): "
          f"{draws_ms:.1f} ms", flush=True)
    print(f"train_epoch_fused bound: {stats['type1_rows']} Type I rows of "
          f"{N * S * 2 * m} ({k1_bytes / 1e9:.3f} GB moved at least, "
          f"{k1_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"{k1_ops / FP32_OPS_PER_S * 1e3:.4f} ms of operations)",
          flush=True)
    print(f"fused_votes_batched bound: {k2_bytes / 1e9:.4f} GB, "
          f"{k2_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {k2_ops:.3e} "
          f"operations, {k2_ops / INT8_OPS_PER_S * 1e3:.4f} ms", flush=True)

    # 7. one more full-width round under torch.profiler
    del epoch
    profile_round(Engine(strategy, data, RuntimeConfig(rounds=1)), state,
                  rnd.PRNGKey(2, dev))

    kernels = [
        {"name": "fused_votes_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/clause_eval.cu",
         "replaces": "src/repro/kernels/clause_eval.py:185",
         "launches": launches["fused_votes_batched"],
         "max_abs_err": err["fused_votes_batched"], "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound * 1e3,
         "bound_by": ("bytes" if k2_bytes / HBM_BYTES_PER_S
                      >= k2_ops / INT8_OPS_PER_S else "operations"),
         "library_ms": k2_lib},
        {"name": "train_epoch_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/train_epoch.cu",
         "replaces": "src/repro/kernels/train_epoch.py:115",
         "launches": launches["train_epoch_fused"],
         "max_abs_err": err["train_epoch_fused"], "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound * 1e3,
         "bound_by": ("bytes" if k1_bytes / HBM_BYTES_PER_S
                      >= k1_ops / FP32_OPS_PER_S else "operations"),
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
