"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --path-m LAYERS

The second form runs only the card's line and path (M) below, at
``LAYERS`` of the models' 32 layers (``path_m``), with no kernel built.

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), timed;
3. hold each of the five kernels against its plain PyTorch version on
   the card, exactly, at the paper's TM width (20 clients, C = 10,
   m = 300, L = 1568: batched fused votes at B = 40 and at serving's 32
   lanes of B = 1, one fused epoch at S = 80 (drawing its randomness
   from the epoch's keys, against the plain coin plane), clause
   outputs at B = 1 for all 20 clients, single-model fused votes at
   B = 1, 40 and 130, one sample step's TA transitions of 20 clients,
   both roles in place, drawn from role keys, with votes at and past
   ±T) and at tile-unaligned shapes (L = 130, m = 33; the vote kernels
   also at B = 130, two passes over the samples, with weights up to
   2**15); the fused epoch's global plan (include bits in device
   memory) at 62 classes (20, 62, 300, 1568), where only it holds the
   bits, and forced at the training path's C = 10 and unaligned; the
   batched fused votes at 62 classes;
4. the data path on the card, each step timed: the 6000-sample 28x28
   pool, the offline mirror's IDX files written and read back through
   the registry (``build/chip_smoke/data``), and the full-width
   partition (20 clients of 80 / 40 / 40), whose ClientData sha256 must
   equal ``FULL_WIDTH_SHA256`` (the reference's, pinned by
   ``tests/test_torch_data.py``); then a 6-client partition drawn on
   the card and on the CPU, bit for bit;
5. the training path: the port's ``fed_train`` at full width (mnist
   28x28 through the mirror's files, 300 clauses, 20 clients, 2 rounds
   of 2 local epochs, a checkpoint after each round) with the launch
   counters set to 0 just before, printing its round lines, and check
   its output;
6. require every kernel of that path to have launched (the fused epoch
   once per local epoch);
7. path (A), serving: ``fed_serve`` publishes the newest checkpoint,
   serves 8 mixed-cluster batches of 32 and checks all 20 clients
   against ``tm.predict`` (counters zeroed just before: 8 + 1 batched
   fused-votes launches, 20 single-model ones, 0 mismatches);
8. path (B), the unit-weight TM: one round of one local epoch of a
   20-client ``weighted=False`` federation through the per-sample scan
   (clause outputs once and the keyed TA transition once per sample
   step),
   then single-model ``tm.train`` / ``accuracy`` / ``confidence_scores``
   on one client; then path (C), FedTM under partial participation:
   ``fed_train --strategy fedtm --active 10 --sampling weighted
   --dropout 0.1 --straggler 0.2 --max-staleness 2`` at the training
   path's width, 2 rounds of 2 local epochs (counters zeroed just
   before: the fused epoch once per local epoch over the 10-client
   cohort, the fused votes once per round over all 20 clients), its
   round lines and round times, and each round's active and aggregated
   counts against the scheduler's draw recomputed on the card; then
   path (D), the lossy wire: ``fed_train --codec int8 --sparse
   --index-coding vrle --error-feedback --telemetry-dir`` at the
   training path's width, 2 rounds of 2 local epochs (counters zeroed
   just before: the fused epoch once per local epoch, the fused votes
   twice a round), each round's ``up=`` / ``down_bc=`` / ``down_pc=``
   beside the training path's float32 figures and held to the frames'
   sizes, the round times and the medians of the spans recorded in
   ``events.jsonl``; then path (E), the DL baselines (``path_e``):
   ``fed_train --strategy fedavg|fedprox|ifca|flis_dc|flis_hc`` at the
   same width on the MLP 784-128-10, 2 rounds of 2 local epochs each
   (counters zeroed just before each: no kernel launches), round times,
   bytes held to the frames' sizes, accuracy and cluster counts,
   FLIS-DC's checkpoint served with ``--verify-offline`` (0
   mismatches), and a small federation of each baseline on the card
   against the CPU within ``E_TOL`` with assignments, counts and bytes
   equal, every product it dispatches on the card (forward and
   backward, watched below autograd) at float32 matmul precision
   "highest" (no TF32); then path (F), async buffered TPFL
   (``path_f``): ``fed_train --mode async --straggler 0.5
   --max-staleness 2 --dropout 0.1 --async-min-uploads 4
   --buffer-capacity 64 --staleness-discount 0.5`` at the training
   path's width, 3 rounds of 2 local epochs with a checkpoint a round
   and telemetry (counters zeroed just before: the fused epoch once per
   local epoch, the fused votes twice a round), its round lines with the
   aggregated / buffered / evicted counts, round times and the
   ``aggregate`` span's median; the same federation on the host buffer
   route against the device route, and both at ``--buffer-capacity 8``
   (eviction at full width), bit for bit (every lane, the server rows,
   every client's state); 2 rounds plus ``--resume`` against the 3
   rounds; the checkpoint served with ``--buffer-capacity 64
   --verify-offline`` (0 mismatches); a small async FLIS-DC federation
   on the card against the CPU within ``E_TOL``, labels, counts and
   bytes equal; then path (G), FEMNIST at full width (``path_g``): the
   LEAF mirror's shards written and read through the registry (28x28,
   25 writers) and the writer-natural partition, each timed, with the
   pool's and the ClientData's sha256 held to ``FEMNIST_POOL_SHA256``
   and ``FEMNIST_SHA256`` (the reference's, pinned by
   ``tests/test_torch_leaf.py``); ``fed_train --dataset femnist`` at 62
   classes, 300 clauses, 20 clients, ``--sampling weighted``, 2 rounds
   of 2 local epochs, one checkpoint after round 2 (counters zeroed
   just before: the fused epoch once per local epoch, every launch on
   the global plan, the fused votes twice a round at 62 classes), its
   round lines, round times and peak device memory; the checkpoint
   served with ``fed_serve --writers 25 --verify-offline`` (0
   mismatches); then path (H), the mmap client store (``path_h``): (H1)
   TPFL on int8 + sparse and FedTM on float32, both on 10 of 20 clients
   with dropout 0.1, and async TPFL at path (F)'s settings, each 2
   rounds at the training path's width, resident and over the store
   (chunked population eval, chunks of 8) in process, counters zeroed
   just before the store runs: mmap == resident bit for bit (reports but
   the store meters, server rows, buffer lanes, the population gathered
   back from the store) and each round's written bytes K x (row + 33);
   (H2) ``fed_train --client-store mmap --participation 0.5`` with a
   checkpoint a round, interrupted after round 1 and ``--resume``d,
   equal to the uninterrupted run (state and store files), then
   ``fed_serve --client-store mmap --verify-offline`` (0 mismatches;
   the covering batch's personalized and fallback counts printed);
   (H3) ``fed_train --dataset femnist --n-clients 1000 --active 20
   --client-store mmap --store-eval sampled --sampling weighted`` over
   path (G)'s mirror (cyclic past its 25 writers), 2 rounds: round
   times, the ``gather`` / ``spill`` spans and the store's and the
   stream's calls inside them, the store bytes (20 x
   (116,733,600 + 33) written a round), the store's apparent size
   against its ``st_blocks`` and the free space it takes (sparse files,
   checked first with a 4 GiB truncate) and peak device memory beside
   path (G)'s; then path (I), the transports (``path_i``), at the
   training path's width with 4 workers of 5 clients each: (I1) the
   loopback transport on the identity wire, 2 rounds, counters zeroed
   just before, equal to the in-process engine on the card bit for bit
   (every report field but the wire gauges, the meters, the final
   state), its wire bytes a round, the fused epoch once per worker per
   local epoch at N = 5 and the fused votes twice per worker a round, and
   one N = 5 epoch held exactly against its plain version; (I2) loopback
   on int8 + error feedback at participation 0.5, dropout 0.1,
   stragglers 0.3, bit for bit against the in-process engine; (I3) async
   loopback at path (F)'s settings, 3 rounds, each round's observed
   staleness, an injected disconnect retried (the run unperturbed) and
   one dropped upload (one arrival and one frame fewer); (I4) the card's
   compute mode (an exclusive mode stops the run with that reason), then
   ``fed_train --transport socket --workers 4`` in a subprocess at the
   training path's flags with telemetry: ``acc_per_round`` and the byte
   totals equal the in-process CLI's, every worker process on the card
   with the fused epoch launched (the ``transport worker`` line each
   writes to stderr at SHUTDOWN), the start-up (spawn to the last
   HELLO), the round times beside the in-process CLI's and each
   process's peak device memory; then path (J), the multi-device backend
   (``path_j``): (J1) ``fed_train --mesh clients:1`` on one NCCL rank on
   ``cuda:0``, ``--collective gather`` and ``psum``, each with a
   checkpoint a round and telemetry, its round lines and checkpoint
   files equal to the training path's (the in-process CLI's) byte for
   byte, its round times, the rank's launches (the fused epoch once per
   local epoch, the fused votes twice a round) and its collective bytes
   against ``collective_payload_bytes``; (J2) 4 ``gloo`` ranks all on
   ``cuda:0`` through ``mesh.run_federations`` (sync TPFL on the
   identity wire, gather and psum; TPFL on int8 + sparse on 10 of 20
   clients, the staged path; FLIS-DC, the assign stage; async TPFL at
   path (F)'s settings, psum), each against the in-process engine on
   the card (the TM runs bit for bit, FLIS-DC within ``E_TOL``), with
   each rank's device, launches and metered bytes; then path (K), the
   model scaffold (``path_k``): (K3) every ``reduced()`` architecture
   on the card against the port on the CPU within ``K3_TOL``
   (parameters bit for bit) and ``train.py --save`` / ``--restore`` on
   the card; (K1) yi-6b at its published config served through
   ``launch.serve`` (batch 4, prompt 32, 32 decode steps), full and int8
   KV cache, decode's logits against the parallel forward within
   ``K1_TOL``; (K2) granite-moe-3b-a800m at its published config, 3
   steps through ``launch.train``, finite losses, the parameters moved,
   then a second run from the same seed equal bit for bit; init
   seconds, step or decode times and peak device memory printed, and no
   TM kernel launched; the dry run's bytes against the card's tensors
   (``k_bytes``): K1's parameters and caches (full and int8) leaf for
   leaf as ``steps.input_specs`` builds them on the host mesh (1, 1),
   their storage bytes the dry run's ``argument_bytes`` less the
   token's, ``memory_allocated`` growing by the cache part across an
   ``init_cache`` (within 512 B a leaf); K2's parameters and AdamW state
   after step 3 the train ``argument_bytes`` at batch 2 x 256 less the
   batch's; and one line of the dry run of both configurations at
   16 x 16 (``train_4k``, ``decode_32k``); then path (L), the legacy
   federation loop (``path_l``), counters zeroed just before L1: (L1) at
   the training path's width, ``federation.init_state`` + ``run_round``
   x 2 against ``federation.run`` (the engine) bit for bit (mean
   accuracy within 1e-6), and one ``fed_train.make_tpfl_round`` call
   against the loop's first round, each round timed (host clock, card
   synced) beside the engine's; (L2) ``make_fedavg_tm_round`` once at
   the same width, every client's TA state and weights
   ``round(sum x f32(1/n))`` of the trained states computed apart, and
   at C = 10, m = 16, 6 clients the card against the CPU bit for bit;
   the counters read after L2 (kernel 1 twelve times, kernel 2 eleven,
   no other); (L3) ``fed_dryrun``'s analytic sections at 16 x 16 and
   2 x 16 x 16, the 16 x 16 figures held to ``L3_16X16``; (L4) the four
   ``repro_torch.examples`` on the card at small arguments, each timed;
   and path (M), run right after the build while this process holds
   nothing on the card, the model scaffold on a torch mesh (``path_m``): 4
   ``gloo`` ranks sharing the card on a (data 2, model 2) grid through
   ``model_mesh.run_steps``, the whole parameters drawn once here and
   handed over in host shared memory, each rank holding its blocks of
   the rules' specs; (M1) granite-moe-3b-a800m at its published width
   (``M_LAYERS`` of its 32 layers) trained 2 steps at 4 x 256 with
   ``REPRO_SHARDED_CE`` / ``REPRO_SHARD_MOE`` off, then on: the first
   step's cross entropy within ``K3_TOL["loss"]`` of one rank's on the
   same data blocks, each step's loss within ``M1_TOL`` of one rank's
   on the whole batch, and one step at all 32 layers (knobs on) whose
   loss is within ``K3_TOL["loss"]`` of one rank's and whose peak memory
   a rank is at most ``M1F_PEAK_GIB``; (M2) yi-6b at its published width (``M_LAYERS``
   layers) decoding a 2-token prompt and 4 greedy steps at batch 4 on
   caches held as their ``rules.cache_specs`` blocks (the sequence cut
   over ``model``: context-parallel decode), of 6 slots, and (M2L) of
   ``decode_32k``'s 32,768 slots, whose higher block holds no valid
   slot the whole run, the logits within ``M2_TOL`` of one rank's on
   whole caches and the tokens equal, and (M2F) M2 in float32, its
   logits within ``M2F_REL`` relative of one rank's in float32 and the
   tokens equal; every rank's bytes
   equal to the dry run's ``argument_bytes`` at (2, 2) and its caches'
   to the dry run's blocks (``M2_CACHE_BYTES``), its ``"context"``
   bytes to those reckoned from the shapes, each decode step's peak
   memory at most ``M2_PEAK_GIB``, its memory and seconds a step, and
   collective bytes and seconds by label beside the dry run's analytic
   ones; (M3) deepseek-v3 and jamba reduced, expert-parallel, and
   xlstm-350m reduced (mLSTM and sLSTM): the model on the grid (train,
   prefill, decode on cut caches) and, for the first two,
   ``moe_apply(impl="capacity_global")`` called on the grid, the card's
   grid against the CPU's within ``K3_TOL``; no TM kernel launched;
9. small federations (Alg. 1, the §7 variant, the unit-weight TM; TPFL
   at participation 0.5 with dropout and stragglers, with round-robin
   and with weighted sampling; FedTM; the lossy wire: TPFL int8 +
   sparse + error feedback, TPFL int4 + varint+RLE, FedTM int4 + error
   feedback on 3 of 6 clients with drops and stragglers) and a small
   checkpoint + serve on the card against the same on the CPU, bit for
   bit; ``aggregate`` of 20 non-integer uploads (10 slots of 300, one
   of 3000, 62 of 16 in four lanes) three times on the card against the
   CPU, bit for bit;
10. time each kernel at its path's shapes with CUDA events, beside its
   plain version, a one-call PyTorch yardstick where one exists, and the
   bound from bytes and operations; print each kernel's device time
   alone (profiler), without its wrapper's host work; the vote kernels
   also at a second shape each (batched at serving's 32 lanes of B = 1,
   single-model at B = 40); the fused epoch's launch plan, its time
   over 1 to 33 clients, the main path's epoch without a coin plane
   (its peak device memory), and its bound from the instructions the
   built kernel issues per coin (``cuobjdump -sass``), and the same
   numbers at path (C)'s 10-client cohort, where the kernel's TA states
   and weights are also held against the plain version's exactly (its
   plan there is one phase 3 does not take); the same for the
   TA transition at path (B)'s last step (its launch plan, its Type I
   and Type II rows, bytes against hashing, and its time with no row
   listed); the fused epoch on the global plan at path (G)'s last epoch
   (1g) and forced at the training path's epoch beside the shared plan
   (1f), the batched fused votes at path (G)'s 62 classes (2g), the
   fused epoch at path (I)'s worker block of 5 clients (1w) and at path
   (J2)'s rank block of 3 (1j, exact against its plain version), each
   by events, alone, against its plain version and its bound;
11. profile one more full-width round of the training path, one of
   path (B), one of path (C), one of path (D), one IFCA round of path
   (E), one async round of path (F) and one FEMNIST round of path (G)
   (device busy share, top ops, idle time and device operations by
   span;
   path (B)'s round also without the profiler), then print the kernel
   times as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
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
# int32 instructions: 64 lanes an SM, half the fp32 lanes, one operation
# each (the fp32 rate counts a fused multiply-add as two).  Hopper's ALU
# pipe (adds of three, logic, shifts, selects, compares) and the heavy half
# of its FMA pipe (integer multiply-adds, IMAD.IADD among them) each have
# these 64 lanes; an SM issues 128 lanes' instructions a cycle.
INT32_OPS_PER_S = FP32_OPS_PER_S / 4
ALU_PIPE = ("LOP3", "SHF", "IADD3", "SEL", "ISETP", "PLOP3", "LEA", "PRMT",
            "MOV", "FSEL", "FSETP", "P2R", "R2P", "SGXT", "BMSK", "POPC",
            "FLO", "IABS")
FMA_PIPE = ("IMAD", "IMUL", "FFMA", "FADD", "FMUL")
EITHER_PIPE = ("VIADD", "VIADDMNMX", "VIMNMX")  # sm_90 ops, pipe unstated
K1_KW = dict(n_states=63, T=40, p_inc=0.8, p_dec=0.2)

RUN_DIR = ROOT / "build" / "chip_smoke"          # checkpoints, registry
DATA_DIR = RUN_DIR / "data"                      # the IDX mirror's files
DATASET, CLAUSES, CLIENTS = "mnist", 300, 20     # the full-width scenario
SCENARIO = ["--dataset", DATASET, "--data-dir", str(DATA_DIR), "--clauses",
            str(CLAUSES), "--clients", str(CLIENTS), "--local-epochs", "2",
            "--device", "cuda"]
MAIN_ARGS = SCENARIO + ["--rounds", "2", "--ckpt-dir", str(RUN_DIR / "ckpt"),
                        "--ckpt-every", "1"]
SERVE_ARGS = SCENARIO + ["--ckpt-dir", str(RUN_DIR / "ckpt"), "--batch",
                         "32", "--requests", "8", "--verify-offline"]
PATH_C = dict(participation=10 / 20, sampling="weighted", dropout=0.1,
              straggler=0.2, max_staleness=2)
PATH_C_ARGS = SCENARIO + ["--rounds", "2", "--strategy", "fedtm",
                          "--active", "10", "--sampling", "weighted",
                          "--dropout", "0.1", "--straggler", "0.2",
                          "--max-staleness", "2"]
PATH_D_WIRE = dict(name="int8", sparse=True, index_coding="vrle",
                   error_feedback=True)
PATH_D_ARGS = SCENARIO + ["--rounds", "2", "--codec", "int8", "--sparse",
                          "--index-coding", "vrle", "--error-feedback",
                          "--telemetry-dir", str(RUN_DIR / "telemetry_d")]
# the small lossy federations held GPU == CPU: 6 clients, m = 16
SMALL_LOSSY = (
    ["--codec", "int8", "--sparse", "--error-feedback"],
    ["--codec", "int4", "--sparse", "--index-coding", "vrle"],
    ["--strategy", "fedtm", "--codec", "int4", "--error-feedback",
     "--active", "3", "--dropout", "0.2", "--straggler", "0.3"])
# path (E): the paper's DL baselines on the MLP 784-128-10
PATH_E = ("fedavg", "fedprox", "ifca", "flis_dc", "flis_hc")
PATH_E_ARGS = SCENARIO + ["--rounds", "2"]
MLP_D = 784 * 128 + 128 + 128 * 10 + 10       # 101,770 floats a vector
# the aten products path (E) watches for the float32 matmul setting
E_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv",
                        "addmv", "dot"})
# path (F): async buffered TPFL at the training path's width
PATH_F_FLAGS = ["--mode", "async", "--straggler", "0.5", "--max-staleness",
                "2", "--dropout", "0.1", "--async-min-uploads", "4",
                "--staleness-discount", "0.5"]
PATH_F_ARGS = SCENARIO + PATH_F_FLAGS + ["--rounds", "3"]
PATH_F = dict(aggregation="async", async_min_uploads=4, buffer_capacity=64,
              staleness_discount=0.5)
PATH_F_SCHED = dict(dropout=0.1, straggler=0.5, max_staleness=2)
# path (G): FEMNIST (the LEAF mirror, 28x28, 62 classes) at the training
# path's width, 25 writers (the default max(25, 20)), writer-natural
# clients; weighted sampling from the writers' real sizes; a checkpoint
# after round 2 only (20 clients of 62 x 300 x 1568 TA states are 2.3 GB)
FEMNIST_WRITERS = 25
PATH_G_SCENARIO = ["--dataset", "femnist", "--data-dir", str(DATA_DIR),
                   "--clauses", str(CLAUSES), "--clients", str(CLIENTS),
                   "--local-epochs", "2", "--device", "cuda"]
PATH_G_ARGS = PATH_G_SCENARIO + ["--rounds", "2", "--sampling", "weighted",
                                 "--ckpt-dir", str(RUN_DIR / "ckpt_g"),
                                 "--ckpt-every", "2"]
PATH_G_SERVE = PATH_G_SCENARIO + [
    "--writers", str(FEMNIST_WRITERS), "--ckpt-dir", str(RUN_DIR / "ckpt_g"),
    "--batch", "32", "--requests", "8", "--verify-offline"]
# path (H3): 1000 FEMNIST clients streamed from path (G)'s mirror (25
# writers, cyclic past 25), 20 a round by their writers' sizes, over the
# mmap store, the cohort evaluated
H3_CLIENTS, H3_K, FEMNIST_LITERALS = 1000, 20, 2 * 28 * 28
PATH_H3_ARGS = ["--dataset", "femnist", "--data-dir", str(DATA_DIR),
                "--n-clients", str(H3_CLIENTS), "--active", str(H3_K),
                "--client-store",
                "mmap", "--store-eval", "sampled", "--sampling", "weighted",
                "--rounds", "2", "--clauses", str(CLAUSES), "--local-epochs",
                "2", "--device", "cuda"]
# the small async FLIS-DC federation held GPU == CPU
SMALL_F = dict(participation=0.75, dropout=0.25, straggler=0.5,
               max_staleness=2)
# the small baseline federations held GPU == CPU, and the tolerance the
# MLP's float math is held to (cuBLAS and the CPU add in other orders)
SMALL_E = dict(n_features=144, n_classes=10, n_hidden=16, local_epochs=2,
               batch=8, ifca_k=3, max_slots=4, probe_size=16)
E_TOL = dict(atol=1e-5, rtol=1e-4)
TA_P = (0.9, 0.7)   # float32(p) < p: a float64 compare would differ
# partition.sha256 of the full-width scenario's ClientData (mnist through
# the mirror, seed 0, 20 clients, experiment 5): the reference's draw,
# pinned to the live reference by tests/test_torch_data.py
FULL_WIDTH_SHA256 = \
    "128c0854eed28842732a3466b44679a1c740d327264909df5a78b030d2e90f5c"
# path (G): FEMNIST at full width (28x28, 62 classes) through the LEAF
# mirror, 25 writers, 20 writer-natural clients of 80 / 40 / 40, seed 0:
# registry.sha256 of the pool and partition.sha256 of the ClientData, the
# reference's, pinned to the live reference by tests/test_torch_leaf.py
FEMNIST_POOL_SHA256 = \
    "4fd7dc3f9b6bb94c496390fc8dcd63f861791c199afdd362392064403cb7546b"
FEMNIST_SHA256 = \
    "63c0c244ce1e21d6426c8dd65580f49a62ca1421d382804ed8d986cfe4ccf24e"


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


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds per call of the CUDA kernels whose name
    contains ``kernel``, from a ``torch.profiler`` trace of ``reps``
    calls of ``fn()``: the kernel alone, without the wrapper's host work
    and small torch ops that ``cuda_ms`` also sees when the device waits
    for the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and kernel in e.key)
    return us / reps / 1e3


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 library_ms, n_bytes, n_ops, ops_per_s) -> dict:
    """One kernel's record for the ``kernels`` JSON line.  Its bound is
    the larger of its bytes over the memory rate and its operations over
    the peak rate for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def vote_inputs(gen, N, C, m, L, B, device, wmax=7):
    import torch
    include = torch.rand((N, C, m, L), generator=gen, device=device) < 2.0 / L
    include[:, :, ::5] = False                     # empty clauses
    lits = torch.randint(0, 2, (N, B, L), generator=gen, device=device,
                         dtype=torch.int32)
    wpol = torch.randint(-wmax, wmax + 1, (N, C, m), generator=gen,
                         device=device, dtype=torch.int32)
    return include, lits, wpol


def ptxas_lines(log: str):
    """(kernel, line) for each register / shared-memory / spill line of a
    ``ptxas -v`` log, the kernel named from its mangled symbol (template
    arguments as ``<8,1>``)."""
    func = "?"
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            sym = m.group(1)
            name = re.search(r"\d+([A-Za-z]\w*?_kernel)", sym)
            args = re.findall(r"L[ib](\d+)E", sym)
            func = (name.group(1) if name else sym) + (
                f"<{','.join(args)}>" if args else "")
        elif "registers" in line or "spill" in line:
            yield func, line.strip()


def coin_mix(sass: str, coins: int, func: str = "") -> dict:
    """The instructions a kernel issues per Type I coin, by pipe, from its
    SASS (``cuobjdump -sass``; only the function whose name holds
    ``func``): the straight-line block that holds the most funnel-shift
    rotations, which must be the ``coins`` coins of one item a lane (20
    rotations a threefry).  ``units`` is the least time of one coin in
    int32 instructions of 64 lanes an SM: the ALU pipe's count, the FMA
    pipe's, or half of all issued, whichever is largest (an op whose pipe
    is not stated may take either)."""
    import collections
    if func:
        parts = [p for p in sass.split("Function : ")[1:]
                 if func in p.split("\n", 1)[0]]
        if len(parts) != 1:
            raise SystemExit(f"coin_mix: {len(parts)} functions named like "
                             f"{func} in the SASS")
        sass = parts[0]
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")
    code = [(int(a, 16), op, args) for a, op, args in insn.findall(sass)]
    jumps = ("BRA", "BRX", "JMP", "CALL", "RET", "EXIT")
    starts = {int(t[-1], 16) for _, op, args in code
              if op.split(".")[0] in jumps + ("BSSY",)
              and (t := re.findall(r"0x([0-9a-f]+)", args))}
    blocks, cur = [], []
    for a, op, _ in code:
        if a in starts and cur:
            blocks.append(cur)
            cur = []
        cur.append(op)
        if op.split(".")[0] in jumps:
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    block = max(blocks, key=lambda b: sum(o.startswith("SHF.L.W") for o in b))
    rot = sum(o.startswith("SHF.L.W") for o in block)
    if rot != 20 * coins:
        raise SystemExit(f"coin_mix: the block with the most rotations "
                         f"holds {rot}, not the {20 * coins} of {coins} "
                         f"coins: the kernel's code changed shape")
    ops = collections.Counter(o.split(".")[0] for o in block)
    mix = {"alu": sum(v for o, v in ops.items() if o in ALU_PIPE),
           "fma": sum(v for o, v in ops.items() if o in FMA_PIPE),
           "either": sum(v for o, v in ops.items() if o in EITHER_PIPE)}
    mix["other"] = len(block) - sum(mix.values())
    mix = {k: v / coins for k, v in mix.items()}
    mix["issued"] = len(block) / coins
    mix["units"] = max(mix["alu"], mix["fma"], mix["issued"] / 2)
    return mix


def epoch_inputs(gen, N, S, C, m, L, n_states, device):
    """Near-boundary TA banks with a few included literals per clause,
    weights, literals, and one epoch's classes and role keys."""
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
    offs, role_keys = draws.epoch_keys(keys, S, C)
    cls2 = torch.stack([ys, (ys + offs) % C], -1).contiguous()
    return ta, w, lits, cls2, role_keys


def step_inputs(gen, N, C, m, L, n_states, T, device):
    """One sample step of N clients: banks near the include boundary and
    at the clamp edges, literals, clause outputs, two different classes a
    client with votes at -T - 5, -T, 0, T and T + 5 in turn (the rest of
    the classes anywhere in between), and role keys (N, 2, 3, 2)."""
    import torch
    from repro_torch import random as rnd

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    ta = ints(n_states - 2, n_states + 3, N, C, m, L)
    ta[:, :, 0, :2] = torch.tensor([1, 2 * n_states], dtype=torch.int32)
    target = ints(0, C, N)
    cls2 = torch.stack([target, (target + ints(1, C, N)) % C], -1)
    votes = ints(-T - 5, T + 6, N, C)
    edges = torch.tensor([-T - 5, -T, 0, T, T + 5], dtype=torch.int32,
                         device=device)
    n = torch.arange(N, device=device)
    votes[n, cls2[:, 0].long()] = edges[n % 5]
    votes[n, cls2[:, 1].long()] = edges[(n + 2) % 5]
    role_keys = rnd.split(rnd.split(rnd.PRNGKey(int(ints(0, 1 << 30, 1)),
                                                device), N * 2), 3)
    return (ta, ints(0, 2, N, L), ints(0, 2, N, C, m), votes,
            cls2.contiguous(), role_keys.reshape(N, 2, 3, 2))


def vote_work(include, lits, wpol) -> tuple[int, int]:
    """Bytes and {0,1} operations of one vote call: the include plane,
    the literals and wpol read once at the element sizes the kernel
    reads, the votes written once; two operations per (sample, clause,
    literal)."""
    *lead, C, m, L = include.shape
    B = lits.shape[-2]
    N = lead[0] if lead else 1
    n_bytes = (include.numel() * include.element_size()
               + lits.numel() * 4 + wpol.numel() * 4 + 4 * N * B * C)
    return n_bytes, 2 * N * B * C * m * L


def exact(name, got, want, what: str, err: dict) -> None:
    """Require ``got == want`` bit for bit; record the max |difference|."""
    import torch
    diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if want.numel() else 0
    err[name] = max(err.get(name, 0), diff)
    print(f"check {name} {what}: max_abs_err={diff}", flush=True)
    if diff != 0 or not torch.equal(got, want):
        raise SystemExit(f"{name} disagrees with its plain version at "
                         f"{what}")


class Capture:
    """Record the arguments of the last (or the first) call of
    ``ops.<fn>`` while a path runs, so a kernel is timed on the inputs
    that path gave it."""

    def __init__(self, ops, fn: str, first: bool = False):
        self.ops, self.fn, self.orig = ops, fn, getattr(ops, fn)
        self.args, self.first = None, first

    def __enter__(self):
        def call(*a, **kw):
            if self.args is None or not self.first:
                self.args = (a, kw)
            return self.orig(*a, **kw)
        setattr(self.ops, self.fn, call)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.fn, self.orig)
        return False


def profile_round(engine, state, key, label: str) -> None:
    """Run one round under torch.profiler, the engine's spans and the
    spans below them named to it, and print what the benchmark's reducer
    (``bench/attribution.py`` over ``bench/trace.py``) makes of it: the
    device's busy time as a union over the round's wall, the device
    operations with the most time, and the idle time, the device
    operations and their device time by the span that was open.  The
    profiler's own overhead lengthens the wall time, so the busy share
    is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import attribution, trace
    spans, obs0 = trace.Spans(fenced=False), engine.obs
    engine.obs = spans
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with record_function(trace.CYCLE):
                engine.run_round(state, key)
                torch.cuda.synchronize()
    finally:
        engine.obs = obs0
    p = attribution.reduce_profile(prof, set(spans.totals))
    by, dev_s = p["launches_by_span"], p["device_s_by_span"]
    print(f"profiled {label}: wall {1e3 * p['window_s']:.1f} ms, device "
          f"busy {1e3 * p['busy_s']:.1f} ms "
          f"({100 * p['busy_s'] / p['window_s']:.1f} %) in "
          f"{sum(by.values())} device operations", flush=True)
    for name, t in p["device_ops"][:8]:
        print(f"  {1e3 * t:9.2f} ms  {name[:70]}", flush=True)
    print("  idle by span (ms): " + ", ".join(
        f"{n} {1e3 * t:.2f}" for n, t in p["idle_gaps"]), flush=True)
    print("  device operations (device ms) by span: " + ", ".join(
        f"{n} {c} ({1e3 * dev_s[n]:.2f})"
        for n, c in sorted(by.items(), key=lambda kv: -kv[1])), flush=True)


def path_e(dev, x, y):
    """Path (E), the DL baselines: each of ``PATH_E`` through the CLI at
    full width, launch counters zeroed just before each run; round
    times, metered bytes against the frames' arithmetic sizes, mean
    accuracy and cluster counts; FLIS-DC's checkpoint served with
    ``--verify-offline``; then a small federation of each baseline on
    the card against the CPU within ``E_TOL``, every product it
    dispatches on the card at full float32 precision (no TF32).  Returns the IFCA run's
    engine and state for the profiled round."""
    import torch
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.data import partition
    from repro_torch.fl.runtime import (Engine, RuntimeConfig,
                                        SchedulerConfig,
                                        build_baseline_strategy)
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_serve, fed_train

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise SystemExit("path (E): TF32 is on; the MLP's float32 products "
                         "must run at full precision")
    from torch.utils._python_dispatch import TorchDispatchMode

    precisions = set()
    products = [0]

    class ProductWatch(TorchDispatchMode):
        """Reads the float32 matmul setting at every product the card is
        asked for, forward and backward alike (below autograd, so the
        Gram product, the einsum means and the gradients' products are
        seen as well as ``torch.matmul``)."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in E_PRODUCTS:
                products[0] += 1
                precisions.add(
                    (torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
            return func(*args, **(kwargs or {}))

    run_round = Engine.run_round
    ck = RUN_DIR / "ckpt_e"
    shutil.rmtree(ck, ignore_errors=True)
    out_e = {}
    for name in PATH_E:
        rounds = []

        def timed(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_round(self, *a, **kw)
            torch.cuda.synchronize()
            rounds.append(time.perf_counter() - t)
            return out

        args = PATH_E_ARGS + ["--strategy", name]
        if name == "flis_dc":
            args += ["--ckpt-dir", str(ck), "--ckpt-every", "2"]
        Engine.run_round = timed
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        try:
            out = fed_train.main(args)
            torch.cuda.synchronize()
        finally:
            Engine.run_round = run_round
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        print(f"path (E) {name}: {wall:.2f}s wall for 2 rounds (rounds "
              f"{[round(t, 4) for t in rounds]} s), kernel launches "
              f"{launches}", flush=True)
        if any(launches.values()):
            raise SystemExit(f"path (E) {name} launched a TM kernel")
        n_slots = out["state"].server.slots.shape[0]
        for rep in out["reports"]:
            arrived = int((rep.participation.active
                           & (rep.participation.staleness == 0)).sum())
            populated = int((rep.cluster_counts > 0).sum())
            applied = int((rep.assignment >= 0).sum())
            down_pc = (arrived * n_slots if name == "ifca" else applied) \
                * 4 * MLP_D
            acc = rep.per_client_accuracy
            print(f"path (E) {name} round {rep.round_idx}: "
                  f"acc={float(rep.mean_accuracy):.4f} "
                  f"up={rep.upload_bytes}B "
                  f"down_bc={rep.download_bytes_broadcast}B "
                  f"down_pc={rep.download_bytes_per_client}B clusters "
                  f"{populated} counts "
                  f"{rep.cluster_counts.cpu().numpy().astype(int).tolist()}",
                  flush=True)
            if rep.upload_bytes != 20 * (4 + 4 * MLP_D) \
                    or rep.download_bytes_broadcast != populated * 4 * MLP_D \
                    or rep.download_bytes_per_client != down_pc:
                raise SystemExit(f"path (E) {name} round {rep.round_idx}: "
                                 f"metered bytes are not the frames' sizes")
            if acc.shape != (20,) or not bool(((acc >= 0)
                                                & (acc <= 1)).all()):
                raise SystemExit(f"path (E) {name}: bad accuracies {acc}")
        st = out["state"]
        if st.server.slots.shape != (n_slots, MLP_D) \
                or not bool(torch.isfinite(st.server.slots).all()) \
                or st.server.slots.device.type != torch.device(dev).type:
            raise SystemExit(f"path (E) {name}: bad server state")
        out_e[name] = out
    t0 = time.perf_counter()
    served = fed_serve.main(SCENARIO + ["--strategy", "flis_dc",
                                        "--ckpt-dir", str(ck), "--batch",
                                        "32", "--requests", "8",
                                        "--verify-offline"])
    torch.cuda.synchronize()
    print(f"path (E) serving flis_dc: {time.perf_counter() - t0:.2f}s wall, "
          f"{served['requests_per_s']:.1f} req/s, p50="
          f"{served['p50_s'] * 1e6:.0f}us p99={served['p99_s'] * 1e6:.0f}us "
          f"per batch of 32, {served['mismatches']} mismatches over "
          f"{served['verified_clients']} clients", flush=True)
    if served["mismatches"] or served["verified_clients"] != 20:
        raise SystemExit("path (E): served != offline")

    # small federations of each baseline: the card against the CPU, the
    # card's products watched (not the timed runs above: the watch runs
    # every op through Python)
    for name in PATH_E:
        for sched in ({}, dict(participation=0.5, dropout=0.3)):
            runs = []
            for d in ("cpu", dev):
                part = partition.partition(x, y, 10, n_clients=6,
                                           experiment=5,
                                           key=rnd.PRNGKey(1, d),
                                           n_train=16, n_test=8, n_conf=8)
                with (ProductWatch() if d == dev
                      else contextlib.nullcontext()):
                    st, reps = Engine(
                        build_baseline_strategy(name, **SMALL_E), part,
                        RuntimeConfig(rounds=2, scheduler=SchedulerConfig(
                            **sched))).run(rnd.PRNGKey(3, d))
                runs.append((convert.to_numpy(
                    [st.server.slots, *st.client_state.values()]
                    if isinstance(st.client_state, dict) else
                    [st.server.slots, *st.client_state.params.values()]),
                    convert.to_numpy([(r.assignment, r.cluster_counts,
                                       r.participation.idx,
                                       r.participation.active)
                                      for r in reps]),
                    [(r.upload_bytes, r.download_bytes_broadcast,
                      r.download_bytes_per_client) for r in reps],
                    convert.to_numpy([r.per_client_accuracy
                                      for r in reps])))
            (fc, ic, bc, ac), (fg, ig, bg, ag) = runs
            same_ints = bc == bg and all(
                np.array_equal(a, b) for ra, rb in zip(ic, ig)
                for a, b in zip(ra, rb))
            err = max(float(np.abs(a - b).max()) for a, b in zip(fc, fg))
            close = all(np.allclose(b, a, **E_TOL) for a, b in zip(fc, fg))
            acc_gap = max(float(np.abs(a - b).max()) for a, b in zip(ac, ag))
            print(f"check small {name} {sched or 'full'}: assignments, "
                  f"counts, bytes GPU == CPU: {same_ints}; state max |GPU - "
                  f"CPU| {err:.3e} (tolerance {E_TOL}); per-client "
                  f"accuracy max gap {acc_gap:.4f}", flush=True)
            if not (same_ints and close):
                raise SystemExit(f"small {name} federation {sched}: GPU and "
                                 f"CPU runs disagree")
    if not products[0] or precisions != {("highest", False)}:
        raise SystemExit(f"path (E): {products[0]} products ran at float32 "
                         f"matmul (precision, allow_tf32) "
                         f"{sorted(precisions)}, not ('highest', False)")
    print(f"path (E): all {products[0]} products of the small federations "
          f"on the card (forward and backward) at float32 matmul precision "
          f"'highest' (no TF32)", flush=True)
    ifca = out_e["ifca"]
    data, _, _, strat = fed_train.build_scenario(
        dataset="mnist", data_dir=str(DATA_DIR), clients=20,
        strategy="ifca", device=dev)
    return Engine(strat, data, RuntimeConfig(rounds=1)), ifca["state"]


def path_f(dev, x, y):
    """Path (F), async buffered TPFL at full width through the CLI: the
    device route with telemetry and a checkpoint a round (launch
    counters zeroed just before), the host route and capacity 8 on both
    routes held bit for bit, resume, serving, and a small async FLIS-DC
    federation GPU == CPU (on the small federations' pool ``x, y``).
    Returns the engine, its state and the launch counts."""
    import torch
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.data import partition
    from repro_torch.fl import obs
    from repro_torch.fl.runtime import (Engine, RuntimeConfig,
                                        SchedulerConfig,
                                        build_baseline_strategy)
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_serve, fed_train

    run_round = Engine.run_round

    def run(args, count=False):
        rounds = []

        def timed(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_round(self, *a, **kw)
            torch.cuda.synchronize()
            rounds.append(time.perf_counter() - t)
            return out

        Engine.run_round = timed
        if count:
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
        try:
            out = fed_train.main(args)
            torch.cuda.synchronize()
        finally:
            Engine.run_round = run_round
        return out, rounds, dict(ops.LAUNCHES)

    def lanes(out):
        st = out["state"]
        return convert.to_numpy(
            [*st.client_state, st.server.slots, st.buf_vecs, st.buf_slots,
             st.buf_ready, st.buf_weight, st.buf_valid, st.buf_seq]) + [
            [(r.upload_bytes, r.download_bytes_per_client,
              r.aggregated_uploads, r.buffered_uploads, r.evicted_uploads)
             for r in out["reports"]],
            convert.to_numpy([r.per_client_accuracy for r in out["reports"]])]

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(lanes(a), lanes(b)))

    ck = RUN_DIR / "ckpt_f"
    shutil.rmtree(ck, ignore_errors=True)
    spans = {}
    t0 = time.perf_counter()
    dev_out, rounds, launches = run(
        PATH_F_ARGS + ["--buffer-capacity", "64", "--ckpt-dir", str(ck),
                       "--ckpt-every", "1", "--telemetry-dir",
                       str(RUN_DIR / "telemetry_f")], count=True)
    print(f"path (F) async TPFL: {time.perf_counter() - t0:.2f}s wall for "
          f"3 rounds (rounds {[round(t, 4) for t in rounds]} s), launches "
          f"{launches}", flush=True)
    if launches["train_epoch_fused"] != 3 * 2 \
            or launches["fused_votes_batched"] != 3 * 2:
        raise SystemExit("path (F) did not launch the fused epoch once per "
                         "local epoch and the fused votes twice a round")
    for rep in dev_out["reports"]:
        part = rep.participation
        acc = rep.per_client_accuracy
        print(f"path (F) round {rep.round_idx}: active "
              f"{int(part.active.sum())}/{CLIENTS}, late "
              f"{int((part.active & (part.staleness > 0)).sum())}, agg "
              f"{rep.aggregated_uploads} buf {rep.buffered_uploads} evict "
              f"{rep.evicted_uploads}, up={rep.upload_bytes}B "
              f"down_pc={rep.download_bytes_per_client}B "
              f"acc={float(rep.mean_accuracy):.4f}", flush=True)
        if acc.shape != (CLIENTS,) \
                or not bool(((acc >= 0) & (acc <= 1)).all()) \
                or rep.upload_bytes != int(part.active.sum()) \
                * (4 + 4 * CLAUSES):
            raise SystemExit(f"path (F) round {rep.round_idx}: bad "
                             f"accuracies or bytes")
    sent = sum(int(r.participation.active.sum()) for r in dev_out["reports"])
    if sum(r.aggregated_uploads for r in dev_out["reports"]) == 0 \
            or sum(r.aggregated_uploads for r in dev_out["reports"]) \
            + dev_out["reports"][-1].buffered_uploads != sent:
        raise SystemExit("path (F): the uploads sent are not those "
                         "aggregated and still buffered")
    st = dev_out["state"]
    if st.buf_vecs.shape != (64, CLAUSES) \
            or st.buf_vecs.device.type != torch.device(dev).type \
            or not bool(torch.isfinite(st.server.slots).all()):
        raise SystemExit("path (F): bad buffer or server state")
    spans["device"] = obs.phase_medians(obs.read_events(
        RUN_DIR / "telemetry_f" / "events.jsonl"))
    host_out, host_rounds, _ = run(
        PATH_F_ARGS + ["--buffer-capacity", "64", "--async-buffer", "host",
                       "--telemetry-dir", str(RUN_DIR / "telemetry_f_host")])
    spans["host"] = obs.phase_medians(obs.read_events(
        RUN_DIR / "telemetry_f_host" / "events.jsonl"))
    print(f"path (F) host route: rounds "
          f"{[round(t, 4) for t in host_rounds]} s", flush=True)
    for route, med in spans.items():
        print(f"path (F) {route} route span medians (ms): " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in sorted(
                med.items(), key=lambda kv: -kv[1])), flush=True)
    if not same(dev_out, host_out):
        raise SystemExit("path (F): the host route differs from the device "
                         "route")
    print("check path (F) host route == device route bit for bit (every "
          "lane, server rows, client state, counts)", flush=True)
    small_cap = []
    for route in ("device", "host"):
        out, r8, _ = run(PATH_F_ARGS + ["--buffer-capacity", "8",
                                        "--async-buffer", route])
        small_cap.append(out)
        print(f"path (F) capacity 8, {route} route: rounds "
              f"{[round(t, 4) for t in r8]} s, evicted "
              f"{[r.evicted_uploads for r in out['reports']]}", flush=True)
    if not same(*small_cap) \
            or not sum(r.evicted_uploads for r in small_cap[0]["reports"]):
        raise SystemExit("path (F) at capacity 8: no eviction, or the host "
                         "route differs from the device route")
    print("check path (F) capacity 8: eviction fired, host route == device "
          "route bit for bit", flush=True)
    ck2 = RUN_DIR / "ckpt_f_resume"
    shutil.rmtree(ck2, ignore_errors=True)
    part_args = SCENARIO + PATH_F_FLAGS + [
        "--buffer-capacity", "64", "--ckpt-dir", str(ck2), "--ckpt-every",
        "1"]
    run(part_args + ["--rounds", "2"])
    resumed, _, _ = run(part_args + ["--rounds", "3", "--resume"])
    resumed["reports"] = dev_out["reports"][:2] + resumed["reports"]
    if len(resumed["reports"]) != 3 or not same(dev_out, resumed):
        raise SystemExit("path (F): 2 rounds + --resume differ from 3 rounds")
    print("check path (F) 2 rounds + --resume == 3 rounds bit for bit",
          flush=True)
    served = fed_serve.main(SCENARIO + ["--ckpt-dir", str(ck),
                                        "--buffer-capacity", "64",
                                        "--batch", "32", "--requests", "8",
                                        "--verify-offline"])
    print(f"path (F) serving: {served['requests_per_s']:.1f} req/s, "
          f"{served['mismatches']} mismatches over "
          f"{served['verified_clients']} clients", flush=True)
    if served["mismatches"] or served["verified_clients"] != CLIENTS \
            or served["version"] != 3:
        raise SystemExit(f"path (F): served != offline: {served}")
    runs = []
    for d in ("cpu", dev):
        part = partition.partition(x, y, 10, n_clients=6, experiment=5,
                                   key=rnd.PRNGKey(1, d), n_train=16,
                                   n_test=8, n_conf=8)
        st_s, reps = Engine(
            build_baseline_strategy("flis_dc", **SMALL_E), part,
            RuntimeConfig(rounds=3, scheduler=SchedulerConfig(**SMALL_F),
                          aggregation="async", async_min_uploads=2,
                          buffer_capacity=5)).run(rnd.PRNGKey(3, d))
        runs.append((convert.to_numpy(
            [st_s.server.slots, *st_s.client_state.params.values(),
             st_s.buf_vecs, st_s.buf_weight]),
            convert.to_numpy([(r.assignment, r.cluster_counts)
                              for r in reps]
                             + [(st_s.buf_slots, st_s.buf_valid,
                                 st_s.buf_seq)]),
            [(r.upload_bytes, r.download_bytes_broadcast,
              r.download_bytes_per_client, r.aggregated_uploads,
              r.buffered_uploads, r.evicted_uploads) for r in reps]))
    (fc, ic, bc), (fg, ig, bg) = runs
    same_ints = bc == bg and all(np.array_equal(a, b) for ra, rb in zip(
        ic, ig) for a, b in zip(ra, rb))
    err = max(float(np.abs(a - b).max()) for a, b in zip(fc, fg))
    close = all(np.allclose(b, a, **E_TOL) for a, b in zip(fc, fg))
    print(f"check small async flis_dc: labels, counts, buffer integers, "
          f"bytes GPU == CPU: {same_ints}; state max |GPU - CPU| {err:.3e} "
          f"(tolerance {E_TOL}); aggregated "
          f"{[b[3] for b in bg]}", flush=True)
    if not (same_ints and close) or not sum(b[3] for b in bg):
        raise SystemExit("small async flis_dc federation: GPU and CPU runs "
                         "disagree, or nothing was aggregated")
    data, _, _, strat = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, device=dev)
    eng = Engine(strat, data, RuntimeConfig(
        rounds=1, scheduler=SchedulerConfig(**PATH_F_SCHED), **PATH_F))
    return eng, st, launches


def path_g(dev):
    """Path (G), FEMNIST at full width: the LEAF mirror written and read
    through the registry and the writer-natural partition, each timed,
    the pool and the ClientData held to the reference's digests; then
    ``fed_train --dataset femnist`` (62 classes, 300 clauses, 20
    writer-natural clients, weighted sampling, 2 rounds of 2 local
    epochs, one checkpoint after round 2) with the launch counters zeroed
    just before: the fused epoch once per local epoch on the global plan,
    the fused votes twice a round at C = 62; its round lines, round
    times and peak device memory; then ``fed_serve --writers 25
    --verify-offline`` over that checkpoint (0 mismatches).  Returns the
    engine's pieces for phases 10 and 11 and the captured kernel
    arguments."""
    import torch
    from repro_torch import random as rnd
    from repro_torch.data import partition
    from repro_torch.data.ingest import mirror, natural, registry
    from repro_torch.fl.runtime import Engine
    from repro_torch.kernels import ops, train_epoch
    from repro_torch.launch import fed_serve, fed_train

    root = DATA_DIR / "femnist"
    shutil.rmtree(root, ignore_errors=True)
    setup = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t
        return out

    timed("leaf_mirror_write", lambda: mirror.write_leaf_mirror(
        root, "synthfemnist", 6000, 28, 0, n_writers=FEMNIST_WRITERS,
        device=dev))
    pool = timed("leaf_read_encode", lambda: registry.load(
        "femnist", DATA_DIR, n_samples=6000, side=12, seed=0,
        n_writers=FEMNIST_WRITERS, device=dev))
    data = timed("writer_partition", lambda: natural.partition_pool(
        pool, n_clients=CLIENTS, n_train=80, n_test=40, n_conf=40,
        key=rnd.PRNGKey(1, dev), experiment=5))
    mb = sum(f.stat().st_size for f in root.iterdir()) / 1e6
    print(f"path (G) data set-up (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in setup.items())
        + f"; {len(list(root.glob('all_data_*.json')))} shards, {mb:.1f} MB",
        flush=True)
    digests = (registry.sha256(pool), partition.sha256(data))
    print(f"check path (G) pool and partition: sha256 {digests} (reference "
          f"{(FEMNIST_POOL_SHA256, FEMNIST_SHA256)})", flush=True)
    if digests != (FEMNIST_POOL_SHA256, FEMNIST_SHA256):
        raise SystemExit("the FEMNIST pool or writer partition drawn on the "
                         "card is not the reference's")
    del pool, data

    rounds = []
    run_round = Engine.run_round

    def timed_round(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_round(self, *a, **kw)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t)
        return out

    shutil.rmtree(RUN_DIR / "ckpt_g", ignore_errors=True)
    Engine.run_round = timed_round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    for k in train_epoch.PLAN_LAUNCHES:
        train_epoch.PLAN_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    try:
        with Capture(ops, "train_epoch_fused") as cap1, \
                Capture(ops, "fused_votes_batched") as cap2:
            result = fed_train.main(PATH_G_ARGS)
            torch.cuda.synchronize()
    finally:
        Engine.run_round = run_round
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    plans = dict(train_epoch.PLAN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"path (G) FEMNIST: {wall:.2f}s wall for 2 rounds (rounds "
          f"{[round(t, 4) for t in rounds]} s), peak device memory "
          f"{peak / 2**30:.2f} GiB, launches {launches}, fused epoch by "
          f"plan {plans}", flush=True)
    if launches["train_epoch_fused"] != 2 * 2 or plans["global"] != 2 * 2 \
            or launches["fused_votes_batched"] != 2 * 2:
        raise SystemExit("path (G) did not launch the fused epoch once per "
                         "local epoch on the global plan and the fused "
                         "votes twice a round")
    if tuple(cap1.args[0][0].shape) != (CLIENTS, 62, CLAUSES, 1568) \
            or cap2.args[0][0].shape[1] != 62:
        raise SystemExit("path (G)'s kernels did not run at 62 classes")
    for rep in result["reports"]:
        acc = rep.per_client_accuracy
        if acc.shape != (CLIENTS,) \
                or not bool(((acc >= 0) & (acc <= 1)).all()) \
                or rep.upload_bytes != int(rep.participation.active.sum()) \
                * (4 + 4 * CLAUSES):
            raise SystemExit(f"path (G) round {rep.round_idx}: bad "
                             f"accuracies or bytes")
    state = result["state"]
    ta, w = state.client_state
    if ta.shape != (CLIENTS, 62, CLAUSES, 1568) or int(ta.min()) < 1 \
            or int(ta.max()) > 126 or int(w.min()) < 0 \
            or state.server.slots.shape != (62, CLAUSES):
        raise SystemExit("path (G): final state out of range")
    ckpts = sorted((RUN_DIR / "ckpt_g").glob("round_*.msgpack"))
    if len(ckpts) != 1:
        raise SystemExit(f"path (G): expected one checkpoint, found {ckpts}")
    print(f"path (G) checkpoint {ckpts[0].name}: "
          f"{ckpts[0].stat().st_size / 1e9:.3f} GB", flush=True)

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    served = fed_serve.main(PATH_G_SERVE)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    launches_s = dict(ops.LAUNCHES)
    print(f"path (G) serving: {serve_wall:.2f}s wall, launches "
          f"{launches_s}, result "
          f"{ {k: v for k, v in served.items() if k != 'latencies_s'} }",
          flush=True)
    if served["mismatches"] != 0 or served["verified_clients"] != CLIENTS \
            or launches_s["fused_votes_batched"] != 8 + 1 \
            or launches_s["fused_votes"] != CLIENTS:
        raise SystemExit(f"path (G) serving failed: {served}, launches "
                         f"{launches_s}")
    data, cfg, _, strategy = fed_train.build_scenario(
        dataset="femnist", data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, device=dev)
    return dict(state=state, data=data, cfg=cfg, strategy=strategy,
                epoch=cap1.args, votes=cap2.args, launches=launches,
                plans=plans, peak=peak)


def _sparse_bytes(root: Path) -> tuple[int, int]:
    """(apparent, allocated) bytes of the files under ``root``: their
    sizes and their allocated blocks (``st_blocks`` x 512)."""
    st = [p.stat() for p in root.iterdir() if p.is_file()]
    return sum(s.st_size for s in st), sum(s.st_blocks * 512 for s in st)


def path_h(dev, g_peak: int):
    """Path (H), the mmap client store on the card.  (H1) in process at
    the training path's width, three configurations each run resident
    and over the store (``store_eval="full"``, chunks of 8), launch
    counters zeroed just before the store runs: every report field but
    the store meters, the server rows, the buffer's lanes and the
    population gathered back from the store equal the resident run's
    bit for bit, and each round writes K x (row + 33) bytes.  (H2) the
    CLI: ``fed_train --client-store mmap`` with a checkpoint a round,
    interrupted after round 1 and resumed, equal to the uninterrupted
    run (state and store files), then ``fed_serve --client-store mmap
    --verify-offline`` (0 mismatches, personalized and fallback rows in
    the covering batch).  (H3) FEMNIST streamed: ``fed_train --n-clients
    1000 --active 20 --client-store mmap --store-eval sampled`` over
    path (G)'s mirror: round times, the ``gather`` / ``spill`` spans
    and the store's and the stream's calls inside them, the store bytes, the store's apparent and allocated sizes and peak
    device memory beside path (G)'s ``g_peak`` (20 resident clients)."""
    import torch
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.fl import obs
    from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                        SchedulerConfig)
    from repro_torch.fl.store import StreamingClientData, client_store
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_serve, fed_train

    def zero_launches():
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0

    def bits(a):
        a = convert.to_numpy(a) if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        return a.view(np.int32) if a.dtype == np.float32 else a

    def same(a, b) -> bool:
        a, b = bits(a), bits(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and np.array_equal(a, b)

    fields = ("assignment", "cluster_counts", "per_client_accuracy",
              "mean_accuracy")
    counts = ("upload_bytes", "download_bytes_broadcast",
              "download_bytes_per_client", "aggregated_uploads",
              "buffered_uploads", "evicted_uploads")

    # (H1) mmap == resident on the card, in process
    data, _, _, tpfl = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, device=dev)
    _, _, _, fedtm = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, strategy="fedtm", device=dev)
    cohort = dict(participation=0.5, dropout=0.1)
    configs = {
        "tpfl_int8_sparse": (tpfl, dict(
            scheduler=SchedulerConfig(**cohort),
            codec=CodecConfig("int8", sparse=True))),
        "fedtm_f32": (fedtm, dict(scheduler=SchedulerConfig(**cohort))),
        "async_tpfl": (tpfl, dict(scheduler=SchedulerConfig(**PATH_F_SCHED),
                                  **PATH_F)),
    }
    launches_h1 = {}
    for name, (strat, kw) in configs.items():
        root = RUN_DIR / f"store_h1_{name}"
        shutil.rmtree(root, ignore_errors=True)
        runs = {}
        for store in ("resident", "mmap"):
            cfg = RuntimeConfig(rounds=2, client_store=store,
                                store_dir=str(root), store_eval="full",
                                store_eval_chunk=8, **kw)
            eng = Engine(strat, data, cfg)
            if store == "mmap":
                zero_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, reps = eng.run(rnd.PRNGKey(3, dev))
            torch.cuda.synchronize()
            runs[store] = (eng, state, reps, time.perf_counter() - t)
        launches_h1[name] = dict(ops.LAUNCHES)
        (_, rstate, rreps, rwall), (eng, state, reps, wall) = \
            runs["resident"], runs["mmap"]
        pop = eng.store.gather(np.arange(CLIENTS))
        ok = all(same(getattr(a, f), getattr(b, f))
                 for a, b in zip(rreps, reps) for f in fields)
        ok &= all(getattr(a, f) == getattr(b, f)
                  for a, b in zip(rreps, reps) for f in counts)
        ok &= all(same(a, b) for a, b in zip(
            [rstate.server.slots, *rstate[3:9]],
            [state.server.slots, *state[3:9]]))
        ok &= all(same(a, b) for a, b in zip(
            client_store.flatten(rstate.client_state)[0],
            client_store.flatten(pop["cs"])[0]))
        if "ref_vecs" in pop:
            ok &= same(rstate.ref_vecs, pop["ref_vecs"]) \
                and same(rstate.ref_round, pop["ref_round"])
        row = eng.store.row_nbytes
        written = [r.store_written_bytes for r in reps]
        want = [int(r.participation.idx.numel()) * (row + 33) for r in reps]
        on_card = all(a.device.type == torch.device(dev).type for a in [
            state.server.slots, *client_store.flatten(state.client_state)[0]])
        print(f"path (H1) {name}: mmap == resident {ok}; wall resident "
              f"{rwall:.3f} s, mmap {wall:.3f} s; store read "
              f"{[r.store_read_bytes for r in reps]} B, written {written} B "
              f"(K x (row {row} + 33) = {want}); launches "
              f"{launches_h1[name]}", flush=True)
        votes = 3 + (0 if name == "fedtm_f32" else 1)     # 3 eval chunks
        if not ok or written != want or not on_card \
                or launches_h1[name]["train_epoch_fused"] != 2 * 2 \
                or launches_h1[name]["fused_votes_batched"] != 2 * votes:
            raise SystemExit(f"path (H1) {name}: the mmap engine is not the "
                             f"resident engine on the card")
        del runs, pop
        shutil.rmtree(root, ignore_errors=True)

    # (H2) the CLI: train over the store, interrupt and resume, serve
    def flags(tag, rounds, *extra):
        return SCENARIO + ["--client-store", "mmap", "--participation",
                           "0.5", "--rounds", str(rounds), "--store-dir",
                           str(RUN_DIR / f"store_h2{tag}"), "--ckpt-dir",
                           str(RUN_DIR / f"ckpt_h2{tag}"), "--ckpt-every",
                           "1", *extra]

    for tag in ("", "_resumed"):
        shutil.rmtree(RUN_DIR / f"store_h2{tag}", ignore_errors=True)
        shutil.rmtree(RUN_DIR / f"ckpt_h2{tag}", ignore_errors=True)
    t = time.perf_counter()
    full = fed_train.main(flags("", 2))
    fed_train.main(flags("_resumed", 1))
    resumed = fed_train.main(flags("_resumed", 2, "--resume"))
    torch.cuda.synchronize()
    a, b = full["state"], resumed["state"]
    files = [p.name for p in sorted((RUN_DIR / "store_h2").iterdir())]
    same_files = all(
        (RUN_DIR / "store_h2" / f).read_bytes()
        == (RUN_DIR / "store_h2_resumed" / f).read_bytes() for f in files)
    same_state = all(same(x, y) for x, y in zip(
        [a.round_idx, a.server.slots], [b.round_idx, b.server.slots])) \
        and resumed["acc_per_round"] == full["acc_per_round"][1:]
    print(f"path (H2) train, interrupt, resume: "
          f"{time.perf_counter() - t:.2f}s wall; resumed == uninterrupted: "
          f"state {same_state}, store files {same_files} ({len(files)} "
          f"files); store bytes read {full['store_read_bytes']} written "
          f"{full['store_written_bytes']}", flush=True)
    if not (same_state and same_files):
        raise SystemExit("path (H2): the resumed mmap run is not the "
                         "uninterrupted run")
    tel = RUN_DIR / "telemetry_h2"
    shutil.rmtree(tel, ignore_errors=True)
    zero_launches()
    t = time.perf_counter()
    served = fed_serve.main(SCENARIO + [
        "--client-store", "mmap", "--store-dir", str(RUN_DIR / "store_h2"),
        "--ckpt-dir", str(RUN_DIR / "ckpt_h2"), "--batch", "32",
        "--requests", "8", "--verify-offline", "--telemetry-dir", str(tel)])
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t
    last = json.loads((tel / "serve_events.jsonl").read_text()
                      .splitlines()[-1])
    print(f"path (H2) serving from the store: {serve_wall:.2f}s wall, "
          f"{served['requests_per_s']:.1f} req/s, p50="
          f"{served['p50_s'] * 1e6:.0f}us p99={served['p99_s'] * 1e6:.0f}us; "
          f"mismatches {served['mismatches']} of "
          f"{served['verified_clients']}; covering batch personalized "
          f"{last['personalized']}, fallback {last['fallback']}; launches "
          f"{dict(ops.LAUNCHES)}", flush=True)
    if served["mismatches"] != 0 or served["verified_clients"] != CLIENTS \
            or last["batch"] != CLIENTS or not last["personalized"] \
            or not last["fallback"]:
        raise SystemExit(f"path (H2) serving failed: {last}")
    for tag in ("", "_resumed"):
        shutil.rmtree(RUN_DIR / f"store_h2{tag}", ignore_errors=True)

    # (H3) FEMNIST streamed over path (G)'s mirror, 1000 clients; the
    # store is 116.7 GB apparent, so first make sure files here are sparse
    store = RUN_DIR / "store_h3"
    tel = RUN_DIR / "telemetry_h3"
    shutil.rmtree(store, ignore_errors=True)
    shutil.rmtree(tel, ignore_errors=True)
    # a file system may report st_blocks = size for a hole: the free
    # space it loses is what a truncate really allocates
    probe = RUN_DIR / "sparse_probe.bin"
    free0 = shutil.disk_usage(RUN_DIR).free
    with open(probe, "wb") as f:
        f.truncate(4 * 2**30)
    blocks = probe.stat().st_blocks * 512
    taken = free0 - shutil.disk_usage(RUN_DIR).free
    probe.unlink()
    print(f"path (H3) a 4 GiB truncated file here: st_blocks x 512 = "
          f"{blocks} B, free space taken {taken} B, "
          f"{free0} B free", flush=True)
    if taken >= 2**30:
        raise SystemExit("path (H3): a truncate allocates its bytes here; "
                         "the store's files would not be sparse")
    free0 = shutil.disk_usage(RUN_DIR).free
    # synced host clocks around the round and, inside its gather and
    # spill spans, the store's and the stream's calls: where the host
    # I/O goes
    clocks = {}
    clocked = [(Engine, "run_round", "round"),
               (client_store.ClientStore, "gather", "store.gather"),
               (client_store.ClientStore, "spill", "store.spill"),
               (StreamingClientData, "gather_clients", "stream.gather")]
    originals = [getattr(owner, attr) for owner, attr, _ in clocked]

    def clock(fn, label):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            clocks.setdefault(label, []).append(time.perf_counter() - t)
            return out
        return timed

    for (owner, attr, label), fn in zip(clocked, originals):
        setattr(owner, attr, clock(fn, label))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t = time.perf_counter()
    try:
        out = fed_train.main(PATH_H3_ARGS + ["--store-dir", str(store),
                                             "--telemetry-dir", str(tel)])
        torch.cuda.synchronize()
    finally:
        for (owner, attr, _), fn in zip(clocked, originals):
            setattr(owner, attr, fn)
    wall = time.perf_counter() - t
    rounds = clocks["round"]
    launches_h3 = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    apparent, allocated = _sparse_bytes(store)
    taken = free0 - shutil.disk_usage(RUN_DIR).free
    events = obs.read_events(tel / "events.jsonl")
    reps = out["reports"]
    print(f"path (H3) FEMNIST streamed, {H3_CLIENTS} clients, K = {H3_K}: "
          f"{wall:.2f}s "
          f"wall for 2 rounds (rounds {[round(x, 4) for x in rounds]} s), "
          f"peak device memory {peak / 2**30:.2f} GiB (path G, {CLIENTS} "
          f"resident clients: {g_peak / 2**30:.2f} GiB); store read "
          f"{[r.store_read_bytes for r in reps]} B, written "
          f"{[r.store_written_bytes for r in reps]} B; store files "
          f"{apparent} B apparent, {allocated} B in st_blocks, {taken} B "
          f"of free space taken; launches "
          f"{launches_h3}", flush=True)
    for e in events:
        print(f"path (H3) round {e['round']} spans (ms): " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in e["phases"].items()),
            flush=True)
    print("path (H3) calls inside the spans, a round (ms): " + ", ".join(
        f"{k} {[round(v * 1e3, 3) for v in clocks[k]]}" for k in
        ("store.gather", "store.spill", "stream.gather")), flush=True)
    row = 62 * CLAUSES * FEMNIST_LITERALS * 4 + 62 * CLAUSES * 4
    if [r.store_written_bytes for r in reps] != [H3_K * (row + 33)] * 2 \
            or apparent < H3_CLIENTS * row or taken >= apparent // 10 \
            or launches_h3["train_epoch_fused"] != 2 * 2 \
            or launches_h3["fused_votes_batched"] != 2 * 2 \
            or any(r.per_client_accuracy.shape != (H3_K,) for r in reps):
        raise SystemExit("path (H3): unexpected store bytes, sizes or "
                         "launches")
    shutil.rmtree(store, ignore_errors=True)


# path (I): the transports at the training path's width; 4 worker peers
# or processes own 5 clients each
I_WORKERS = 4
PATH_I2_SCHED = dict(participation=0.5, dropout=0.1, straggler=0.3)
PATH_I4_ARGS = SCENARIO + ["--rounds", "2", "--transport", "socket",
                           "--workers", str(I_WORKERS)]
# the socket CLI in a subprocess: fed_train's main, its transport's
# launch (start-up: spawn to the last HELLO) clocked, the result printed
I4_CODE = """
import json, os, subprocess, sys, time
import torch
from repro_torch.fl.transport.runner import TransportEngine
from repro_torch.fl.transport.socket_transport import SocketTransport
launch = SocketTransport.launch.__func__
def timed(cls, *a, **kw):
    t = time.perf_counter()
    out = launch(cls, *a, **kw)
    print('I4_STARTUP ' + repr(time.perf_counter() - t), flush=True)
    return out
SocketTransport.launch = classmethod(timed)
shutdown = TransportEngine._shutdown
def probed(self, transport):
    # each process's device memory, contexts included, while all live
    apps = subprocess.run(
        ['nvidia-smi', '--query-compute-apps=pid,used_memory',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print('I4_APPS ' + json.dumps({
        'server': os.getpid(), 'workers': [p.pid for p in transport.procs],
        'apps': apps}), flush=True)
    return shutdown(self, transport)
TransportEngine._shutdown = probed
from repro_torch.launch.fed_train import main
out = main(sys.argv[1:])
torch.cuda.synchronize()
print('I4_RESULT ' + json.dumps({
    'acc_per_round': out['acc_per_round'],
    'upload_bytes': out['upload_bytes'],
    'download_bytes_broadcast': out['download_bytes_broadcast'],
    'download_bytes_per_client': out['download_bytes_per_client'],
    'wire': [[r.wire_tx_bytes, r.wire_rx_bytes] for r in out['reports']],
    'server_peak_bytes': torch.cuda.max_memory_allocated()}), flush=True)
"""


def path_i(dev, main_result, main_rounds, err):
    """Path (I), the transports on the card at the training path's width.
    (I1) loopback, ``I_WORKERS`` worker peers, identity wire, 2 rounds,
    counters zeroed just before: every report field but the wire gauges,
    the meters and the final state equal the in-process engine's bit for
    bit (``mean_accuracy`` within 1e-6); the wire bytes a round; kernel 1
    once per worker per local epoch at the worker's block (N = 5), kernel
    2 twice per worker a round; one N = 5 epoch of kernel 1 held exactly
    against its plain version.  (I2) loopback on int8 + error feedback,
    participation 0.5, dropout 0.1, stragglers 0.3, against the
    in-process engine bit for bit.  (I3) async loopback at path (F)'s
    settings, 3 rounds: the observed staleness of each round; an
    injected disconnect (retried: the run unperturbed) and one dropped
    upload (one arrival and one frame fewer).  (I4) ``fed_train
    --transport socket --workers 4`` in a subprocess at the training
    path's flags: metrics and bytes equal the in-process CLI's
    (``main_result``), every worker on the card with kernel 1 launched;
    start-up, round times beside ``main_rounds`` and each process's peak
    device memory.  Returns the captured N = 5 epoch's arguments."""
    import torch
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.fl import obs
    from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                        SchedulerConfig)
    from repro_torch.fl.transport import FaultPlan, RetryPolicy, \
        TransportEngine
    from repro_torch.kernels import ops, train_epoch
    from repro_torch.launch import fed_train

    data, _, _, tpfl = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, device=dev)

    def bits(a):
        a = convert.to_numpy(a)
        return a.view(np.int32) if a.dtype == np.float32 else a

    def same(a, b) -> bool:
        a, b = bits(a), bits(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and np.array_equal(a, b)

    def same_runs(ref, ours, wire=False) -> bool:
        (rst, rreps), (st, reps) = ref, ours
        ok = len(rreps) == len(reps)
        for a, b in zip(rreps, reps):
            ok &= all(same(getattr(a, f), getattr(b, f)) for f in (
                "assignment", "cluster_counts", "per_client_accuracy"))
            ok &= all(same(x, y) for x, y in zip(a.participation,
                                                 b.participation))
            ok &= all(getattr(a, f) == getattr(b, f) for f in (
                "round_idx", "upload_bytes", "download_bytes_broadcast",
                "download_bytes_per_client", "aggregated_uploads",
                "buffered_uploads", "evicted_uploads") + ((
                    "wire_tx_bytes", "wire_rx_bytes", "observed_staleness")
                    if wire else ()))
            ok &= abs(float(a.mean_accuracy) - float(b.mean_accuracy)) \
                <= 1e-6
        ok &= all(same(x, y) for x, y in zip(
            [*rst.client_state, rst.server.slots, *rst[3:]],
            [*st.client_state, st.server.slots, *st[3:]]))
        return bool(ok)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    epochs_n = []
    orig = ops.train_epoch_fused
    loop_rounds = []
    run_round = TransportEngine._round

    def timed_round(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_round(self, *a, **kw)
        torch.cuda.synchronize()
        loop_rounds.append(time.perf_counter() - t)
        return out

    def watch(*a, **kw):
        epochs_n.append(int(a[0].shape[0]))
        return orig(*a, **kw)

    # (I1) loopback, identity wire, against the in-process engine
    key = rnd.PRNGKey(3, dev)
    ref, ref_s = timed(lambda: Engine(tpfl, data, RuntimeConfig(
        rounds=2)).run(key))
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    ops.train_epoch_fused = watch
    TransportEngine._round = timed_round
    try:
        with Capture(ops, "train_epoch_fused") as cap:
            loop, loop_s = timed(lambda: TransportEngine(
                tpfl, data, RuntimeConfig(rounds=2, transport="loopback",
                                          workers=I_WORKERS)).run(key))
    finally:
        ops.train_epoch_fused = orig
        TransportEngine._round = run_round
    launches = dict(ops.LAUNCHES)
    ok = same_runs(ref, loop)
    wire = [(r.wire_tx_bytes, r.wire_rx_bytes) for r in loop[1]]
    print(f"path (I1) loopback, {I_WORKERS} worker peers, identity wire: "
          f"== in-process {ok}; wall in-process {ref_s:.3f} s, loopback "
          f"{loop_s:.3f} s (rounds {[round(x, 4) for x in loop_rounds]} "
          f"s; in-process CLI {[round(x, 4) for x in main_rounds]} s); "
          f"wire (tx, rx) a round {wire} B; launches "
          f"{launches}; kernel 1 clients a launch {epochs_n}", flush=True)
    per_worker = CLIENTS // I_WORKERS
    if not ok or epochs_n != [per_worker] * (I_WORKERS * 2 * 2) \
            or launches["fused_votes_batched"] != I_WORKERS * 2 * 2 \
            or any(tx <= 0 or rx <= 0 for tx, rx in wire):
        raise SystemExit("path (I1): the loopback transport is not the "
                         "in-process engine on the card, or its kernels "
                         "did not launch once per worker per epoch")
    a1w, kw1w = cap.args
    got = ops.train_epoch_fused(*a1w, **kw1w)
    want = train_epoch.train_epoch_plain(*a1w, **kw1w)
    what = (f"a worker's block N={a1w[0].shape[0]} plan "
            f"{train_epoch.plan(*a1w[0].shape)}")
    moved = int((want[0] != a1w[0]).sum())
    exact("train_epoch_fused", got[0], want[0],
          f"{what} TA states ({moved} changed)", err)
    exact("train_epoch_fused", got[1], want[1], f"{what} weights", err)
    if moved == 0:
        raise SystemExit("train_epoch_fused changed nothing at N = 5")
    del got, want, ref, loop

    # (I2) loopback on int8 + error feedback, partial participation
    cfg2 = dict(rounds=2, codec=CodecConfig("int8", error_feedback=True),
                scheduler=SchedulerConfig(**PATH_I2_SCHED))
    key = rnd.PRNGKey(4, dev)
    ref, ref_s = timed(lambda: Engine(tpfl, data, RuntimeConfig(
        **cfg2)).run(key))
    loop, loop_s = timed(lambda: TransportEngine(tpfl, data, RuntimeConfig(
        **cfg2, transport="loopback", workers=I_WORKERS)).run(key))
    ok = same_runs(ref, loop)
    print(f"path (I2) loopback, int8 + error feedback, 10 of 20, dropout "
          f"0.1, stragglers 0.3: == in-process {ok}; wall in-process "
          f"{ref_s:.3f} s, loopback {loop_s:.3f} s; up "
          f"{[r.upload_bytes for r in loop[1]]} B, wire (tx, rx) "
          f"{[(r.wire_tx_bytes, r.wire_rx_bytes) for r in loop[1]]} B, "
          f"active {[int(r.participation.active.sum()) for r in loop[1]]}",
          flush=True)
    if not ok:
        raise SystemExit("path (I2): the lossy loopback run is not the "
                         "in-process engine's on the card")
    del ref, loop

    # (I3) async loopback at path (F)'s settings, with faults
    cfg3 = RuntimeConfig(rounds=3, transport="loopback", workers=I_WORKERS,
                         scheduler=SchedulerConfig(**PATH_F_SCHED),
                         **PATH_F)
    key = rnd.PRNGKey(5, dev)
    clean, clean_s = timed(lambda: TransportEngine(tpfl, data, cfg3).run(
        key))
    for r in clean[1]:
        print(f"path (I3) async round {r.round_idx}: agg "
              f"{r.aggregated_uploads} buf {r.buffered_uploads} evict "
              f"{r.evicted_uploads}, up={r.upload_bytes}B, observed "
              f"{r.observed_staleness}", flush=True)
    part0 = clean[1][0].participation
    on_time = (part0.active & (part0.staleness == 0)).cpu().numpy()
    victim = int(part0.idx.cpu().numpy()[np.nonzero(on_time)[0][0]])
    faulty = TransportEngine(tpfl, data, cfg3,
                             faults=FaultPlan(disconnect=((1, 0),)),
                             retry=RetryPolicy(attempts=2, backoff=0.001)
                             ).run(key)
    dropped = TransportEngine(tpfl, data, cfg3,
                              faults=FaultPlan(drop=((0, victim),))).run(key)
    c0, d0 = clean[1][0], dropped[1][0]
    ok_fault = same_runs(clean, faulty, wire=True)
    ok_drop = (d0.observed_staleness["sampled"]
               == c0.observed_staleness["sampled"] - 1
               and d0.upload_bytes == c0.upload_bytes - (4 + 4 * CLAUSES))
    print(f"path (I3) async loopback, 3 rounds: wall {clean_s:.3f} s; "
          f"observed stragglers "
          f"{[r.observed_staleness['stragglers'] for r in clean[1]]}; an "
          f"injected disconnect retried, run unperturbed: {ok_fault}; "
          f"client {victim}'s round-0 upload dropped: arrivals "
          f"{c0.observed_staleness['sampled']} -> "
          f"{d0.observed_staleness['sampled']}, up {c0.upload_bytes} -> "
          f"{d0.upload_bytes} B: {ok_drop}", flush=True)
    if not (ok_fault and ok_drop) or not any(
            r.observed_staleness["stragglers"] for r in clean[1]) \
            or not sum(r.aggregated_uploads for r in clean[1]):
        raise SystemExit("path (I3): the async transport lost, or let in, "
                         "an upload it should not have")
    del clean, faulty, dropped, data, tpfl

    # (I4) the socket transport: worker processes on this card
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"path (I4) compute mode: {mode}", flush=True)
    if mode.lower().startswith("exclusive"):
        raise SystemExit(f"path (I4): compute mode {mode}: a second CUDA "
                         f"context cannot open, so {I_WORKERS} socket "
                         f"worker processes cannot share this card")
    tel = RUN_DIR / "telemetry_i4"
    shutil.rmtree(tel, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", I4_CODE, *PATH_I4_ARGS, "--telemetry-dir",
         str(tel)], capture_output=True, text=True, env=env, timeout=900)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"path (I4): the socket run exited "
                         f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith(("round ", "totals:")):
            print(f"path (I4) {line}", flush=True)
    out = json.loads(next(x for x in lines if x.startswith("I4_RESULT "))
                     .split(" ", 1)[1])
    startup = float(next(x for x in lines if x.startswith("I4_STARTUP "))
                    .split(" ", 1)[1])
    workers = [json.loads(x.split("transport worker ", 1)[1])
               for x in proc.stderr.splitlines()
               if x.startswith("transport worker ")]
    apps = json.loads(next(x for x in lines if x.startswith("I4_APPS "))
                      .split(" ", 1)[1])
    roles = {str(apps["server"]): "server"} | {
        str(pid): f"worker {r}" for r, pid in enumerate(apps["workers"])}

    def app(line):
        pid, _, used = (x.strip() for x in line.partition(","))
        return f"{roles.get(pid, 'pid ' + pid)} {used}"

    print("path (I4) device memory by process before SHUTDOWN "
          "(nvidia-smi, contexts included): "
          + ("; ".join(map(app, apps["apps"])) or "none listed"), flush=True)
    rounds = [e["phases"]["round"] for e in obs.read_events(
        tel / "events.jsonl")]
    print(f"path (I4) socket, {I_WORKERS} worker processes: {wall:.2f} s "
          f"wall; start-up (spawn to the last HELLO) {startup:.3f} s; "
          f"rounds {[round(x, 4) for x in rounds]} s (in-process CLI "
          f"{[round(x, 4) for x in main_rounds]} s); wire (tx, rx) "
          f"{out['wire']} B; peak device memory server "
          f"{out['server_peak_bytes'] / 2**20:.1f} MiB, workers "
          + ", ".join(f"{w['rank']} {w['peak_bytes'] / 2**20:.1f} MiB"
                      for w in sorted(workers, key=lambda w: w["rank"])),
          flush=True)
    for w in sorted(workers, key=lambda w: w["rank"]):
        print(f"path (I4) worker {w['rank']}: device {w['device']}, "
              f"launches {w['launches']}", flush=True)
    same_cli = (out["acc_per_round"] == main_result["acc_per_round"]
                and all(out[k] == main_result[k] for k in (
                    "upload_bytes", "download_bytes_broadcast",
                    "download_bytes_per_client")))
    print(f"check path (I4) socket CLI == in-process CLI "
          f"(acc_per_round, bytes): {same_cli}", flush=True)
    if not same_cli or sorted(w["rank"] for w in workers) \
            != list(range(I_WORKERS)) or any(
            not w["device"].startswith("cuda")
            or w["launches"]["train_epoch_fused"] != 2 * 2
            or w["launches"]["fused_votes_batched"] == 0 for w in workers):
        raise SystemExit("path (I4): the socket run differs from the "
                         "in-process CLI, or a worker ran no kernel 1 on "
                         "the card")
    return a1w, kw1w


# path (J): the multi-device backend (a clients mesh) at the training
# path's width: (J1) the CLI on one NCCL rank, (J2) 4 gloo ranks sharing
# cuda:0 through the library
J1_ARGS = SCENARIO + ["--rounds", "2", "--ckpt-every", "1", "--mesh",
                      "clients:1"]
J_RANKS = 4
CKPT_NAMES = ("round_000001.msgpack", "round_000002.msgpack")


def _meter(out: dict, rounds: int) -> tuple[str, bool]:
    """The collective bytes (and seconds: host clock, card synced) each
    rank metered, and whether every rank's aggregation moved
    ``collective_payload_bytes`` a round."""
    payload = out["collective_payload_bytes"]
    ok = True
    parts = []
    for rank, m in enumerate(out["meter"]):
        agg = m["bytes"]["aggregate"] - m["pad"]["aggregate"]
        ok &= agg == rounds * payload
        parts.append(f"rank {rank}: " + ", ".join(
            f"{k} {v} B in {m['seconds'][k]:.4f} s ({m['calls'][k]} calls"
            + (f", {m['pad'][k]} B padding" if m["pad"][k] else "") + ")"
            for k, v in sorted(m["bytes"].items())))
    return (f"aggregate {agg} B = {rounds} x collective_payload_bytes "
            f"{payload} B: {ok}; " + "; ".join(parts)), bool(ok)


def path_j(dev, main_result):
    """Path (J), the shard-mapped backend over ``torch.distributed`` at
    the training path's width.  (J1) ``fed_train --mesh clients:1`` on
    NCCL, ``cuda:0``, with ``--collective gather`` and ``psum``: each run's
    round lines and checkpoint files equal the in-process CLI's
    (``main_result``, ``RUN_DIR / "ckpt"``) byte for byte; its round times
    (telemetry), the rank's launches (kernel 1 once per local epoch,
    kernel 2 twice a round) and collective bytes against
    ``collective_payload_bytes``.  (J2) 4 ``gloo`` ranks all on ``cuda:0``
    through ``mesh.run_federations``: sync TPFL on the identity wire (the
    fused round), gather and psum; TPFL on int8 + sparse, 10 of 20 clients
    (the staged path, kernel 1 at each rank's block of 3); FLIS-DC (the
    assign stage); async TPFL at path (F)'s settings, psum.  Each run
    against the in-process engine on the card: the TM runs bit for bit,
    FLIS-DC's integers exact and its floats within ``E_TOL``; each
    rank's launches, devices and metered bytes (the mesh builder has
    checked that gloo runs every collective on the card's tensors).
    Returns J2's round times."""
    import torch
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.fl import obs
    from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                        SchedulerConfig)
    from repro_torch.launch import fed_train
    from repro_torch.launch import mesh as mesh_lib

    # (J1) the CLI on one NCCL rank
    for coll in ("gather", "psum"):
        ck, tel = RUN_DIR / f"ckpt_j1_{coll}", RUN_DIR / f"telemetry_j1_{coll}"
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(tel, ignore_errors=True)
        t = time.perf_counter()
        out = fed_train.main(J1_ARGS + ["--collective", coll, "--ckpt-dir",
                                        str(ck), "--telemetry-dir",
                                        str(tel)])
        wall = time.perf_counter() - t
        ran = out["mesh"]
        rounds = [e["phases"]["round"]
                  for e in obs.read_events(tel / "events.jsonl")]
        same_lines = out["round_lines"] == main_result["round_lines"]
        same_ckpt = all((ck / n).read_bytes()
                        == (RUN_DIR / "ckpt" / n).read_bytes()
                        for n in CKPT_NAMES)
        line, ok_bytes = _meter(ran, 2)
        launches = ran["launches"][0]
        print(f"path (J1) fed_train --mesh clients:1 --collective {coll}: "
              f"{wall:.2f} s wall (spawn, scenario, 2 rounds); rounds "
              f"{[round(x, 4) for x in rounds]} s; {ran['backend']} on "
              f"{ran['devices']}; launches "
              f"{launches}; round lines == in-process CLI {same_lines}; "
              f"checkpoints == in-process CLI's bytes {same_ckpt}",
              flush=True)
        print(f"path (J1) {coll} collectives: {line}", flush=True)
        if not (same_lines and same_ckpt and ok_bytes) \
                or ran["backend"] != "nccl" or ran["devices"] != ["cuda:0"] \
                or launches["train_epoch_fused"] != 2 * 2 \
                or launches["fused_votes_batched"] != 2 * 2:
            raise SystemExit(f"path (J1): the {coll} mesh CLI is not the "
                             f"in-process CLI on the card, or its rank ran "
                             f"off the card or without its kernels")

    # (J2) 4 gloo ranks sharing cuda:0, through the library
    data, _, _, tpfl = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, device=dev)
    _, _, _, flis = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, strategy="flis_dc", device=dev)
    lossy = dict(codec=CodecConfig("int8", sparse=True),
                 scheduler=SchedulerConfig(participation=10 / 20))
    runs = {  # name: (strategy, runtime settings, launches a rank)
        "sync TPFL, identity wire (fused round), gather":
            (tpfl, dict(rounds=2), (4, 4)),
        "sync TPFL, identity wire (fused round), psum":
            (tpfl, dict(rounds=2, mesh_collective="psum"), (4, 4)),
        "TPFL int8 + sparse, 10 of 20 (staged, N = 3 a rank), gather":
            (tpfl, dict(rounds=2, **lossy), (4, 4)),
        "FLIS-DC (assign stage), gather":
            (flis, dict(rounds=2), (0, 0)),
        "async TPFL at path (F)'s settings, psum":
            (tpfl, dict(rounds=3, mesh_collective="psum",
                        scheduler=SchedulerConfig(**PATH_F_SCHED),
                        **PATH_F), (6, 6)),
    }
    host_data = tree.map(lambda a: a.cpu(), data)
    jobs = [dict(strategy=st, data=host_data, seed=7, config=RuntimeConfig(
        backend="shardmap", **kw)) for st, kw, _ in runs.values()]
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = mesh_lib.spawn(mesh_lib.run_federations, J_RANKS, jobs,
                             device="cuda", shared_device=True)
    world = time.perf_counter() - t
    print(f"path (J2) {J_RANKS} gloo ranks on cuda:0: {world:.2f} s wall "
          f"(spawn, the ranks' start-up, {len(jobs)} runs)", flush=True)

    def bits(a):
        a = np.ascontiguousarray(convert.to_numpy(a))
        return a.view(np.int32) if a.dtype == np.float32 else a

    def same(a, b, tol=False) -> bool:
        a, b = convert.to_numpy(a), convert.to_numpy(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if tol and a.dtype == np.float32:
            return bool(np.allclose(b, a, **E_TOL))
        return bool(np.array_equal(bits(a), bits(b)))

    times = {}
    for (name, (st, kw, (k1, k2))), res in zip(runs.items(), results):
        ref_kw = {k: v for k, v in kw.items() if k != "mesh_collective"}
        torch.cuda.synchronize()
        t = time.perf_counter()
        rstate, rreps = Engine(st, data, RuntimeConfig(**ref_kw)).run(
            rnd.PRNGKey(7, dev))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t
        mlp = st is flis
        ok = len(rreps) == len(res["reports"])
        for a, b in zip(rreps, res["reports"]):
            ok &= all(same(getattr(a, f), getattr(b, f), tol=mlp) for f in (
                "assignment", "cluster_counts", "per_client_accuracy"))
            ok &= all(same(x, y) for x, y in zip(a.participation,
                                                  b.participation))
            ok &= all(getattr(a, f) == getattr(b, f) for f in (
                "upload_bytes", "download_bytes_broadcast",
                "download_bytes_per_client", "aggregated_uploads",
                "buffered_uploads", "evicted_uploads"))
            ok &= abs(float(a.mean_accuracy) - float(b.mean_accuracy)) \
                <= (1e-5 if mlp else 1e-6)
        la = tree.leaves(tuple(rstate))
        lb = tree.leaves(tuple(res["state"]))
        ok &= len(la) == len(lb) and all(
            same(x, y, tol=mlp) for x, y in zip(la, lb))
        exact_bits = len(la) == len(lb) and all(
            same(x, y) for x, y in zip(la, lb))
        rounds = [e["phases"]["round"] for e in res["events"]]
        times[name] = rounds
        line, ok_bytes = _meter(res, kw["rounds"])
        launched = [(r["train_epoch_fused"], r["fused_votes_batched"])
                    for r in res["launches"]]
        print(f"path (J2) {name}: == in-process on the card {ok} "
              f"(state bit for bit {exact_bits}); rounds "
              f"{[round(x, 4) for x in rounds]} s (run {res['seconds']:.3f}"
              f" s; in process {ref_s:.3f} s); devices {res['devices']}; "
              f"(kernel 1, kernel 2) launches a rank {launched}", flush=True)
        print(f"path (J2) {name} collectives: {line}", flush=True)
        if not (ok and ok_bytes) or (not mlp and not exact_bits) \
                or res["backend"] != "gloo" \
                or res["devices"] != ["cuda:0"] * J_RANKS \
                or launched != [(k1, k2)] * J_RANKS:
            raise SystemExit(f"path (J2) {name}: the mesh run is not the "
                             f"in-process engine on the card, or a rank ran "
                             f"off the card or without its kernels")
    return times


# path (K): the model scaffold.  K1 serves yi-6b and K2 trains
# granite-moe-3b-a800m (twice, bit for bit) at their full published
# configs (random weights from seed 0); K3 holds every architecture's reduced() variant on the
# card against the port on the CPU.  Bounds on max |card − CPU| (bf16
# parameters: cuBLAS and the CPU round the bf16 activations in other
# orders), each at most 4x the largest difference measured on the H100.
K1_SERVE = ["--arch", "yi-6b", "--batch", "4", "--prompt-len", "32",
            "--decode-steps", "32"]
K2_TRAIN = ["--arch", "granite-moe-3b-a800m", "--batch", "2", "--seq",
            "256", "--steps", "3"]
# K1: decode's logits against the parallel forward over the same tokens
# at full width (the reference's test_decode_matches_forward), full and
# int8 KV cache; greedy tokens compared where the forward's top-2 margin
# exceeds the bound
K1_TOL = {"full": 0.44, "int8": 0.64}      # measured 0.110 / 0.160
K3_TOL = {"logits": 0.078, "decode": 0.078, "loss": 0.0016,
          "step_loss": 0.0016, "step_params": 0.0039}
# measured: logits 0.0197, decode 0.0197, loss 4.04e-4, step loss 4.04e-4,
# parameters after one AdamW step 9.77e-4 (one bf16 ulp at 0.125–0.25)
K3_T = 12


def _same_bits(a, b) -> bool:
    """Two tensors (either device) with the same dtype, shape and bits."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.is_floating_point():
        word = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(word[a.element_size()]), b.view(word[a.element_size()])
    return bool((a == b).all())


def _keyed(tree) -> dict:
    """A tree's leaves by their checkpoint keys."""
    from repro_torch.checkpoint import ckpt
    out: dict = {}
    ckpt._map(lambda k, v: out.__setitem__(k, v), tree)
    return out


def _maxdiff(a, b) -> float:
    """max |a − b| over the finite columns (padded vocab: −1e30)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    keep = b > -1e29
    if not bool((keep == (a > -1e29)).all()):
        raise SystemExit("path (K): padded-vocab masks differ")
    return float((a - b).abs()[keep].max()) if bool(keep.any()) else 0.0


def _k_decode_check(name, logits, full, tol) -> tuple[float, float]:
    """Decode's logits against the forward's: max |Δ| within ``tol`` and
    the greedy tokens equal where the forward's top-2 margin exceeds it.
    Returns (max |Δ|, share of positions compared)."""
    d = _maxdiff(logits, full)
    top = full.float().topk(2, dim=-1).values
    sure = (top[..., 0] - top[..., 1]) > tol
    agree = logits.argmax(-1) == full.argmax(-1)
    print(f"path (K1) {name}: decode vs forward max |d| {d:.4f} "
          f"(bound {tol}), greedy equal at {int(agree[sure].sum())} of "
          f"{int(sure.sum())} positions with margin > {tol} "
          f"({float(agree.float().mean()):.3f} of all)", flush=True)
    if d > tol or not bool(agree[sure].all()):
        raise SystemExit(f"path (K1) {name}: decode disagrees with forward")
    return d, float(sure.float().mean())


def k3_run(cfg, dev) -> dict:
    """One reduced() architecture on ``dev``: its parameters from key 0,
    forward and decode logits and the loss on two rows of ``K3_T``
    tokens, one train step from fresh AdamW moments."""
    import torch
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    p = transformer.init(rnd.PRNGKey(0, dev), cfg)
    toks = rnd.randint(rnd.PRNGKey(1, dev), (2, K3_T), 0, cfg.vocab)
    labels = rnd.randint(rnd.PRNGKey(2, dev), (2, K3_T), 0, cfg.vocab)
    with torch.no_grad():
        logits, _ = transformer.forward(p, cfg, tokens=toks, remat=False)
        loss, _ = transformer.lm_loss(p, cfg, toks, labels)
        caches = transformer.init_cache(cfg, 2, K3_T, device=dev)
        dec = []
        for t in range(K3_T):
            lg, caches = transformer.decode_step(p, cfg, toks[:, t:t + 1],
                                                 caches)
            dec.append(lg)
    new_p, _, metrics = steps.make_train_step(cfg)(
        tree.map(torch.clone, p), adamw.init(p),
        {"tokens": toks, "labels": labels})
    return dict(params=tree.leaves(p), logits=logits, loss=loss,
                decode=torch.cat(dec, 1), new=tree.leaves(new_p),
                step_loss=metrics["loss"])


def k3_diffs(gpu: dict, cpu: dict) -> dict:
    """Two :func:`k3_run` results' differences, the keys of ``K3_TOL``;
    ``None`` where the parameters are not the same bits."""
    pc, pg = cpu["params"], gpu["params"]
    if len(pc) != len(pg) or not all(_same_bits(a, b)
                                     for a, b in zip(pc, pg)):
        return None
    return {"logits": _maxdiff(gpu["logits"], cpu["logits"]),
            "decode": _maxdiff(gpu["decode"], cpu["decode"]),
            "loss": abs(float(gpu["loss"]) - float(cpu["loss"])),
            "step_loss": abs(float(gpu["step_loss"])
                             - float(cpu["step_loss"])),
            "step_params": max(_maxdiff(a, b)
                               for a, b in zip(gpu["new"], cpu["new"]))}


def _storage_bytes(t) -> int:
    """Bytes of the distinct storages behind a tree's tensors."""
    from repro_torch import tree
    held = {}
    for x in tree.leaves(t):
        st = x.untyped_storage()
        held[st.data_ptr()] = st.nbytes()
    return sum(held.values())


def _same_leaves(name: str, real, abstract) -> None:
    """The card's tensors have the dry run's abstract leaves' paths,
    shapes and dtypes."""
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.sharding import rules
    got, want = {}, {}
    tree.map_with_path(lambda p, x: got.__setitem__(
        rules._path_str(p), (tuple(x.shape), x.dtype)), real)
    tree.map_with_path(lambda p, a: want.__setitem__(
        rules._path_str(p), (a.shape, a.dtype)), abstract,
        is_leaf=steps.is_abstract)
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise SystemExit(f"path (K) {name}: the card's leaves are not the "
                         f"dry run's input_specs: {bad[:5]}")


def k_bytes_k1(dev, cfg, params, batch: int, max_len: int) -> dict:
    """K1's parameters and decode caches (full, then int8) against the dry
    run on the host mesh: leaves, storage bytes, and the allocator's
    growth across ``init_cache``."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    shape = steps.ShapeSpec("k1", max_len, batch, "decode")
    out = {}
    for kv in ("full", "int8"):
        if kv == "int8":
            os.environ["REPRO_QUANT_KV"] = "1"
        try:
            ins = steps.input_specs(cfg, shape, make_host_mesh())
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(dev)
            caches = transformer.init_cache(cfg, batch, max_len, device=dev)
            torch.cuda.synchronize(dev)
            grown = torch.cuda.memory_allocated(dev) - before
        finally:
            os.environ.pop("REPRO_QUANT_KV", None)
        _same_leaves(f"K1 params ({kv})", params, ins["params"])
        _same_leaves(f"K1 caches ({kv})", caches, ins["caches"])
        arg = dryrun.argument_bytes(ins, "decode")
        token = dryrun.device_bytes(ins["token"])
        cache = dryrun.device_bytes(ins["caches"])
        held = _storage_bytes(params) + _storage_bytes(caches)
        slack = 512 * len(tree.leaves(caches))
        print(f"path (K1) dry run, {kv} cache at batch {batch} x {max_len} "
              f"on the host mesh: argument_bytes {arg} less the token's "
              f"{token} = {arg - token}, the card's parameters and caches "
              f"hold {held}; init_cache grew memory_allocated by {grown} "
              f"(the dry run's cache part {cache}, bound +-{slack})",
              flush=True)
        if held != arg - token or abs(grown - cache) > slack:
            raise SystemExit(f"path (K1) dry run, {kv} cache: the card's "
                             f"bytes are not the dry run's")
        out[kv] = dict(argument_bytes=arg, held=held, grown=grown,
                       cache=cache)
        del caches
    return out


def k_bytes_k2(cfg, params, opt, batch: int, seq: int) -> dict:
    """K2's parameters and AdamW state after its steps against the dry
    run's train inputs on the host mesh."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    ins = steps.input_specs(cfg, steps.ShapeSpec("k2", seq, batch, "train"),
                            make_host_mesh())
    _same_leaves("K2 params", params, ins["params"])
    _same_leaves("K2 AdamW state", opt, ins["opt_state"])
    arg = dryrun.argument_bytes(ins, "train")
    tokens = dryrun.device_bytes(ins["batch"])
    held = _storage_bytes(params) + _storage_bytes(opt)
    print(f"path (K2) dry run at batch {batch} x {seq} on the host mesh: "
          f"argument_bytes {arg} less the batch's {tokens} = "
          f"{arg - tokens}, the card's parameters and AdamW state after "
          f"step {int(opt.step)} hold {held}", flush=True)
    if held != arg - tokens:
        raise SystemExit("path (K2) dry run: the card's bytes are not the "
                         "dry run's")
    return dict(argument_bytes=arg, held=held)


def k_dryrun_line() -> dict:
    """The dry run of K1's and K2's configurations at 16 x 16."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rows = {}
    for arch in ("yi-6b", "granite-moe-3b-a800m"):
        for shape in ("train_4k", "decode_32k"):
            r = dryrun.dryrun(arch, shape)
            rf = r["roofline"]
            rows[f"{arch}/{shape}"] = {
                "argument_bytes": r["memory"]["argument_bytes"],
                "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
                "collective_s": rf["collective_s"],
                "bottleneck": rf["bottleneck"]}
    print(f"path (K) dry run at 16x16 (analytic, H100 constants, "
          f"{time.perf_counter() - t0:.1f}s): {json.dumps(rows)}",
          flush=True)
    return rows


def path_k3(dev) -> dict:
    """Every architecture's reduced() variant on the card against the port
    on the CPU (:func:`k3_run`): parameters bit for bit, forward and
    decode logits, the loss, one train step; ``train.py --save`` then
    ``--restore`` on the card."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import config as mcfg
    worst = dict.fromkeys(K3_TOL, 0.0)
    t_all = time.perf_counter()
    for arch in registry.ARCHS:
        t0 = time.perf_counter()
        cfg = mcfg.reduced(registry.get(arch))
        got = k3_diffs(k3_run(cfg, dev), k3_run(cfg, "cpu"))
        if got is None:
            raise SystemExit(f"path (K3) {arch}: parameters differ from "
                             f"the CPU's")
        for k, v in got.items():
            worst[k] = max(worst[k], v)
            if not v <= K3_TOL[k]:
                raise SystemExit(f"path (K3) {arch}: {k} {v} > {K3_TOL[k]}")
        # the CLI's checkpoint on the card: --save, then --restore
        path = RUN_DIR / "ckpt_k" / f"{arch}.msgpack"
        argv = ["--arch", arch, "--reduced", "--steps", "1", "--seq", "16"]
        saved = train.main(argv + ["--save", str(path)])
        back = train.main(argv + ["--restore", str(path), "--steps", "0"])
        ck_w = _keyed({"params": saved["params"], "opt": saved["opt"]})
        ck_g = _keyed({"params": back["params"], "opt": back["opt"]})
        if list(ck_w) != list(ck_g) or not all(
                _same_bits(ck_w[k], ck_g[k]) for k in ck_w) \
                or tree.leaves(back["params"])[0].device.type \
                != torch.device(dev).type:
            raise SystemExit(f"path (K3) {arch}: --restore on the card "
                             f"differs from --save")
        print(f"path (K3) {arch}: params bit for bit, " + ", ".join(
            f"{k} {v:.3g}" for k, v in got.items())
            + f", --save/--restore bit for bit; "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    shutil.rmtree(RUN_DIR / "ckpt_k", ignore_errors=True)
    print(f"path (K3): all {len(registry.ARCHS)} reduced architectures "
          f"within {K3_TOL}; worst {worst}; "
          f"{time.perf_counter() - t_all:.1f}s", flush=True)
    return worst


def path_k(dev) -> dict:
    """(K3), then (K1) serving yi-6b and (K2) training
    granite-moe-3b-a800m (twice, bit for bit) at their full published
    configs, each with the dry run's bytes held to the card's tensors;
    then the dry run of both at 16 x 16."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.models import layers
    from repro_torch import random as rnd
    launches = dict(ops.LAUNCHES)
    out = {"k3": path_k3(dev)}

    # K1: serve yi-6b, full cache then the int8 cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    os.environ.pop("REPRO_QUANT_KV", None)
    res = serve.main(K1_SERVE)
    cfg, params = res["cfg"], res["params"]
    n = sum(x.numel() for x in tree.leaves(params))
    with torch.no_grad():
        full, _ = transformer.forward(params, cfg, tokens=res["tokens"],
                                      remat=False)
    _k_decode_check("full cache", res["logits"], full, K1_TOL["full"])
    os.environ["REPRO_QUANT_KV"] = "1"
    try:
        q = serve.run(cfg, params, 4, 32, 32, device=dev)
    finally:
        os.environ.pop("REPRO_QUANT_KV", None)
    with torch.no_grad():
        full_q, _ = transformer.forward(params, cfg, tokens=q["tokens"],
                                        remat=False)
    _k_decode_check("int8 cache", q["logits"], full_q, K1_TOL["int8"])
    peak1 = torch.cuda.max_memory_allocated(dev)
    del q["logits"], full_q
    out["k1_bytes"] = k_bytes_k1(dev, cfg, params, 4, 32 + 32)
    tok_s = {"full": 32 * 4 / res["decode_s"], "int8": 32 * 4 / q["decode_s"]}
    print(f"path (K1) yi-6b serve: {n / 1e9:.3f}B parameters, init "
          f"{res['init_s']:.2f}s, prefill (32 decode steps) "
          f"{res['prefill_s']:.2f}s full / {q['prefill_s']:.2f}s int8, "
          f"decode {tok_s['full']:.1f} / {tok_s['int8']:.1f} tok/s "
          f"(batch 4), peak device memory {peak1 / 2**30:.2f} GiB",
          flush=True)
    out["k1"] = dict(init_s=res["init_s"], prefill_s=res["prefill_s"],
                     tok_s=tok_s, peak=peak1, params=n)
    del res, q, params, full
    torch.cuda.empty_cache()

    # K2: train granite-moe-3b-a800m, 3 steps, no checkpoint
    torch.cuda.reset_peak_memory_stats()
    res = train.main(K2_TRAIN)
    losses = [m["loss"] for m in res["metrics"]]
    if not all(np.isfinite(losses)) or int(res["opt"].step) != 3:
        raise SystemExit(f"path (K2): losses {losses}, step "
                         f"{int(res['opt'].step)}")
    k_emb = rnd.split(rnd.PRNGKey(0, dev), 3)[0]
    cfg = res["cfg"]
    emb0 = layers.embed_init(k_emb, cfg.padded_vocab, cfg.d_model)
    moved = float((res["params"]["embed"].float() - emb0.float()).abs().max())
    m_abs = max(float(m.abs().max()) for m in tree.leaves(res["opt"].m))
    if not moved > 0 or not m_abs > 0:
        raise SystemExit("path (K2): the parameters did not move")
    peak2 = torch.cuda.max_memory_allocated(dev)
    print(f"path (K2) granite-moe-3b-a800m train: {res['n_params'] / 1e9:.3f}"
          f"B parameters, init {res['init_s']:.2f}s, losses "
          f"{[round(x, 4) for x in losses]}, s/step "
          f"{[round(x, 3) for x in res['step_s']]}, embedding moved by up to "
          f"{moved:.3g}, peak device memory "
          f"{peak2 / 2**30:.2f} GiB", flush=True)
    out["k2"] = dict(init_s=res["init_s"], step_s=res["step_s"],
                     losses=losses, peak=peak2)
    out["k2_bytes"] = k_bytes_k2(cfg, res["params"], res["opt"], 2, 256)
    # the same run again from the same seed: the same losses and
    # parameters, bit for bit (no backward adds with atomics)
    first = tree.leaves(res["params"])
    del res, emb0
    torch.cuda.empty_cache()
    again = train.main(K2_TRAIN)
    if [m["loss"] for m in again["metrics"]] != losses or not all(
            _same_bits(a, b) for a, b in zip(
                first, tree.leaves(again["params"]), strict=True)):
        raise SystemExit("path (K2): a second run from the same seed "
                         "differs from the first")
    print(f"path (K2) granite-moe-3b-a800m train: a second run repeats "
          f"the losses and parameters bit for bit, s/step "
          f"{[round(x, 3) for x in again['step_s']]}", flush=True)
    del again, first
    torch.cuda.empty_cache()
    out["dryrun"] = k_dryrun_line()
    if dict(ops.LAUNCHES) != launches:
        raise SystemExit("path (K) launched a TM kernel")
    return out


# path (L): the legacy federation loop, the round constructors, the federated
# dry run's sections and the examples
L_TPFL_LAUNCHES = {"train_epoch_fused": 2 * 2 * 2 + 2 + 2,
                   "fused_votes_batched": 2 * 2 * 2 + 2 + 1}
L2_SMALL_TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63,
                   s=5.0, T=40)
# the 16 x 16 figures at paper width (C = 10, m = 300, L = 1568, 256
# clients, a 512-row buffer): the psum of the (C, m) accumulator and its
# totals, the async update's all-gather of 256 x 1,213 upload bytes, and
# FedAvg-TM's all-reduce of the f32 state and weights (+ 4 B: the
# accuracy mean)
L3_16X16 = {"tpfl": {"all-reduce": 4 * 10 * 301},
            "tpfl_async": {"all-gather": 256 * (4 * 300 + 13),
                           "all-reduce": 4 * 10 * 301},
            "fedavg_tm": {"all-reduce": 10 * 300 * 1568 * 4 + 10 * 300 * 4
                          + 4}}
L4_EXAMPLES = (
    ("quickstart", []),
    ("federated_training", ["--rounds", "1", "--clients", "6", "--dataset",
                            "synthmnist"]),
    ("multiarch_train", ["--steps", "1"]),
    ("serve_decode", ["--batch", "2", "--prompt-len", "8",
                      "--decode-steps", "8"]))


def path_l(dev) -> dict:
    """(L1) the legacy loop at the training path's width, (L2) one
    FedAvg-TM round, (L3) the federated dry run's sections, (L4) the four
    examples.  Returns the launches of L1 and L2 (kernels 1 and 2)."""
    import importlib

    import torch
    from repro_torch import random as rnd
    from repro_torch.core import federation, tm
    from repro_torch.data import partition, synthetic
    from repro_torch.fl.runtime import Engine
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_dryrun, fed_train

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    def same(a, b) -> bool:
        return all(_same_bits(x, y) for x, y in zip(a, b, strict=True))

    data, tm_cfg, fed_cfg, _ = fed_train.build_scenario(
        dataset=DATASET, data_dir=str(DATA_DIR), clients=CLIENTS,
        clauses=CLAUSES, rounds=2, device=dev)
    n = fed_cfg.n_clients
    key = rnd.PRNGKey(0, dev)
    k_init, k_rounds = rnd.split(key).unbind(0)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0

    # L1: init_state + run_round x 2, then federation.run (the engine)
    st0 = federation.init_state(tm_cfg, fed_cfg, k_init)
    states, legacy, legacy_s = [st0], [], []
    for r in range(fed_cfg.rounds):
        t = clock()
        st, m = federation.run_round(states[-1], data,
                                     rnd.fold_in(k_rounds, r), tm_cfg,
                                     fed_cfg)
        legacy_s.append(clock() - t)
        states.append(st)
        legacy.append(m)
    engine_s = []
    run_round = Engine.run_round

    def timed_round(self, *a, **kw):
        t = clock()
        out = run_round(self, *a, **kw)
        engine_s.append(clock() - t)
        return out

    Engine.run_round = timed_round
    try:
        end, hist = federation.run(data, tm_cfg, fed_cfg, key)
    finally:
        Engine.run_round = run_round
    t = clock()
    p1, cw1, met1 = fed_train.make_tpfl_round(tm_cfg, fed_cfg)(
        st0.client_params, st0.cluster_weights, data,
        rnd.fold_in(k_rounds, 0))
    tpfl_round_s = clock() - t

    # L2: FedAvg over the full TM state, once
    k_avg = rnd.fold_in(k_rounds, 7)
    t = clock()
    avg, avg_met = fed_train.make_fedavg_tm_round(tm_cfg, fed_cfg)(
        st0.client_params, data, k_avg)
    fedavg_s = clock() - t
    launches = dict(ops.LAUNCHES)
    print(f"path (L1) legacy loop at C = {tm_cfg.n_classes}, m = "
          f"{tm_cfg.n_clauses}, L = {tm_cfg.n_literals}, {n} "
          f"clients: run_round {[round(s, 4) for s in legacy_s]} s, the "
          f"engine's rounds (federation.run) "
          f"{[round(s, 4) for s in engine_s]} s, one make_tpfl_round "
          f"{tpfl_round_s:.4f} s, mean accuracy "
          f"{[round(float(m.mean_accuracy), 4) for m in legacy]}; (L2) "
          f"make_fedavg_tm_round {fedavg_s:.4f} s, mean accuracy "
          f"{float(avg_met['mean_accuracy']):.4f}; launches {launches}",
          flush=True)

    for r, (a, b) in enumerate(zip(legacy, hist, strict=True)):
        if not same([a.per_client_accuracy, a.assignment, a.cluster_counts],
                    [b.per_client_accuracy, b.assignment, b.cluster_counts]) \
                or [a.upload_bytes, a.download_bytes_broadcast,
                    a.download_bytes_per_client] != [
                    b.upload_bytes, b.download_bytes_broadcast,
                    b.download_bytes_per_client] \
                or abs(float(a.mean_accuracy) - float(b.mean_accuracy)) \
                > 1e-6:
            raise SystemExit(f"path (L1) round {r}: run_round and "
                             f"federation.run disagree")
    last = states[-1]
    if not same([*last.client_params, last.cluster_weights],
                [*end.client_params, end.cluster_weights]):
        raise SystemExit("path (L1): the legacy loop's state is not "
                         "federation.run's")
    one = states[1]
    if not same([*one.client_params, one.cluster_weights,
                 legacy[0].cluster_counts],
                [*p1, cw1, met1["cluster_counts"]]) \
            or abs(float(met1["mean_accuracy"])
                   - float(legacy[0].mean_accuracy)) > 1e-6:
        raise SystemExit("path (L1): make_tpfl_round is not run_round's "
                         "round")
    for name, want in L_TPFL_LAUNCHES.items():
        if launches[name] != want:
            raise SystemExit(f"path (L): {name} launched {launches[name]} "
                             f"times, not {want}")
    if any(v for k, v in launches.items() if k not in L_TPFL_LAUNCHES):
        raise SystemExit(f"path (L): other kernels launched: {launches}")
    print("check path (L1): init_state + run_round x 2 == federation.run "
          "bit for bit (mean accuracy within 1e-6), make_tpfl_round == "
          "run_round's first round", flush=True)

    # L2: every client holds round(sum x f32(1/n)) of the trained states
    trained = tm.train_batched(st0.client_params, data.x_train,
                               data.y_train, rnd.split(k_avg, n), tm_cfg,
                               epochs=fed_cfg.local_epochs)
    inv_n = float(np.float32(1) / np.float32(n))
    want = [torch.round(a.to(torch.float32).sum(0) * inv_n).to(torch.int32)
            for a in trained]
    if not all(bool((a == w).all()) for a, w in zip(avg, want, strict=True)):
        raise SystemExit("path (L2): the FedAvg-TM state is not the "
                         "rounded mean of the trained states")
    del trained, want, states, end, p1, avg
    small = []
    for d in ("cpu", dev):
        x, y, _ = synthetic.make_dataset("synthmnist", 600,
                                         rnd.PRNGKey(0, d), side=12)
        part = partition.partition(x, y, 10, n_clients=6, experiment=5,
                                   key=rnd.PRNGKey(1, d), n_train=24,
                                   n_test=12, n_conf=12)
        cfg = tm.TMConfig(**L2_SMALL_TM)
        fed = federation.FedConfig(n_clients=6, local_epochs=2)
        p0 = federation.init_state(cfg, fed, rnd.PRNGKey(2, d)).client_params
        small.append(fed_train.make_fedavg_tm_round(cfg, fed)(
            p0, part, rnd.PRNGKey(3, d)))
    (cpu_p, cpu_m), (gpu_p, gpu_m) = small
    if not same(cpu_p, gpu_p) or abs(float(cpu_m["mean_accuracy"])
                                     - float(gpu_m["mean_accuracy"])) > 1e-6:
        raise SystemExit("path (L2): the reduced FedAvg-TM round differs "
                         "between the card and the CPU")
    print("check path (L2): every client holds round(sum x f32(1/n)) of "
          "the trained states; C = 10, m = 16, 6 clients: GPU == CPU bit "
          "for bit", flush=True)

    # L3: the federated dry run's sections (analytic, no card needed)
    t = clock()
    secs = {mp: fed_dryrun.run(multi_pod=mp) for mp in (False, True)}
    print(f"path (L3) fed_dryrun sections ({time.perf_counter() - t:.2f}s): "
          + json.dumps({s["mesh"]: {k: {c: b for c, b in s[k][
              "breakdown"].items() if b} for k in fed_dryrun.SECTIONS}
                        | {"fedavg_over_tpfl": s["fedavg_over_tpfl"]}
                        for s in secs.values()}), flush=True)
    for name, want in L3_16X16.items():
        got = {k: v for k, v in secs[False][name]["breakdown"].items() if v}
        if got != want:
            raise SystemExit(f"path (L3) {name} at 16x16: {got}, not {want}")
    if secs[False]["fedavg_tm"]["payload_bytes"] != 18_828_000:
        raise SystemExit("path (L3): FedAvg-TM's payload at 16x16 is not "
                         "18,828,000 B")

    # L4: the examples on the card
    example_s = {}
    for name, argv in L4_EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        t = clock()
        module.main(argv + ["--device", "cuda"])
        example_s[name] = clock() - t
    print("path (L4) examples on the card (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in example_s.items()), flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "legacy_s": legacy_s,
            "engine_s": engine_s, "tpfl_round_s": tpfl_round_s,
            "fedavg_s": fedavg_s, "examples_s": example_s}


# path (M): the model scaffold on a torch mesh of 4 gloo ranks on this card
M_GRID = (("data", "model"), (2, 2))
M_KNOBS = {0: {"REPRO_SHARDED_CE": None, "REPRO_SHARD_MOE": None},
           1: {"REPRO_SHARDED_CE": "1", "REPRO_SHARD_MOE": "1"}}
# M1: granite-moe-3b-a800m at its published width, 2 steps at 4 x 256,
# knobs off then on; M2, M2L: yi-6b at its published width, a 2-token
# prompt fed a token a step then 4 greedy steps.  Depth cut to M_LAYERS of 32
# (every step gathers every layer through gloo's host staging);
# ``path_m(dev, layers=32)`` runs them whole.
M_LAYERS = 4
M1_BATCH, M1_SEQ, M2_BATCH, M2_PROMPT, M2_DECODE = 4, 256, 4, 2, 4
# M1 against one rank on the whole batch, bounds on each step's loss: the
# grid computes each data block's bf16 products at half the rows (other
# cuBLAS tilings) and rounds each block's bf16 weight gradients before
# summing them, so the two runs drift apart; the first step's cross
# entropy is held within K3_TOL["loss"] to one rank's on the same data
# blocks, the products the grid computes
# 4x the differences measured on an H100 at 4 layers (0.00227, 0.00362)
M1_TOL = (0.0091, 0.0145)
# M1F: one step at all 32 layers, knobs on, in M1's world: its loss
# within K3_TOL["loss"] of one rank's on the whole batch (measured on an
# H100: 2.4e-5), its peak device memory a rank at most M1F_PEAK_GIB
# (measured 16.20 GiB: a stacked leaf's gradients are restacked at the
# end of the backward)
M1F_PEAK_GIB = 18.0
# M2 decodes on caches held as rules.cache_specs' blocks: a rank's bytes
# are the dry run's, reckoned from the shapes at M_LAYERS layers (batch
# 2 of 4, sequence 3 of 6, bf16 K and V, int32 pos); M2L the same model
# on caches of decode_32k's length, 16,384 slots of 32,768 a rank, whose
# higher block along ``model`` holds no valid slot the whole run
M2L_SLOTS = 32768
M2_CACHE_BYTES = {"M2": 49_184, "M2L": 268_435_488}
# M2 and M2L in bf16 against one rank on whole caches at M_LAYERS
# layers: 2x the larger difference measured on an H100 (0.0333, M2; M2L
# 0.0325): a block's float32 attention output, its sums in another
# order, is cast to bf16 and a value at a rounding boundary moves one
# ulp, which the next layers carry (at 32 layers 0.0749 and 0.0887, so
# only the tokens are held in bf16 at another depth)
M2_TOL = 0.067
# M2F: M2 with float32 parameters and caches, its logits against one
# rank's in float32 within M2F_REL relative (max |d| over max |one
# rank's|; measured on an H100: 1.13e-6 at M_LAYERS), as
# tests/test_torch_gpu.py holds the reduced models on the card: in
# float32 the context-parallel combine is all that differs, at any depth
M2F_REL = 1e-4
# a rank's peak device memory in any decode step of M2 and M2L at
# M_LAYERS layers (measured on an H100: 2.31 and 2.57 GiB, flat over the
# steps; 2.58 -> 8.29 GiB over 6 steps before the gathers' reassembly
# stopped holding each gathered buffer in a reference cycle)
M2_PEAK_GIB = 3.0
M3_T = 8


def _m_cut(arch: str, layers: int):
    """``arch``'s published config, its (one-segment) stack cut to
    ``layers`` layers."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    (repeat, pattern), = cfg.segments
    if layers >= repeat * len(pattern):
        return cfg
    return dataclasses.replace(cfg, n_layers=layers,
                               segments=((layers // len(pattern), pattern),))


def _m3_cfgs() -> dict:
    """M3's reduced configs: deepseek-v3 with one dense and one MoE layer
    (its first three are dense) and jamba, expert-parallel; xlstm-350m
    with an mLSTM and its sLSTM layer (its first two are mLSTM)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import config as mcfg
    ds = mcfg.reduced(registry.get("deepseek-v3-671b"))
    ds = dataclasses.replace(ds, segments=((1, (
        mcfg.LayerSpec("attn", "dense"), mcfg.LayerSpec("attn", "moe"))),))
    xl = mcfg.reduced(registry.get("xlstm-350m"))
    xl = dataclasses.replace(xl, segments=((1, (
        mcfg.LayerSpec("mlstm", "none"), mcfg.LayerSpec("slstm", "none"))),))
    return {"deepseek-v3": ds,
            "jamba": mcfg.reduced(registry.get("jamba-1.5-large-398b")),
            "xlstm-350m": xl}


def _m3_jobs(dev) -> list:
    """M3's jobs, their inputs drawn on ``dev`` (the parameters on the CPU
    and moved, so the card and the CPU worlds start from the same
    bits)."""
    import torch
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.models import transformer
    jobs = []
    for name, cfg in _m3_cfgs().items():
        params = tree.map(lambda a: a.to(dev), transformer.init(
            rnd.PRNGKey(0, "cpu"), cfg))
        toks = rnd.randint(rnd.PRNGKey(1, "cpu"), (4, M3_T), 0,
                           cfg.vocab).to(torch.int32).to(dev)
        labels = torch.roll(toks, -1, 1)
        jobs.append(dict(
            name=name, mesh=M_GRID, cfg=cfg, params=params, env=M_KNOBS[1],
            prefill=toks, decode={"prompt": toks[:, :2], "steps": 2},
            train={"tokens": toks, "labels": labels, "steps": 1},
            gather_params=True))
    return jobs


def _m3_global(mesh) -> dict:
    """M3's other dispatcher, which no layer calls:
    ``moe_apply(impl="capacity_global")`` of each config's MoE layer
    (float32, seed 5) called on the grid with ``REPRO_SHARD_MOE=1``,
    each rank its batch block and its experts' banks; the output, the
    aux loss and the gradients of ``sum(y * r) + aux``, whole."""
    import torch
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.launch import model_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import mesh_ops, rules
    out, spec = {}, rules.batch_spec(mesh, 4)
    for name, cfg in _m3_cfgs().items():
        if cfg.moe is None:
            continue
        p = tree.map(lambda a: a.float().to(mesh.device),
                     moe.moe_init(rnd.PRNGKey(5, "cpu"), cfg))
        g = torch.Generator().manual_seed(7)
        x, r = (torch.randn(4, M3_T, cfg.d_model, generator=g)
                .to(mesh.device) for _ in range(2))
        with model_mesh._environ(M_KNOBS[1]), \
                mesh_ops.use_mesh(mesh, spec[0]):
            axes = mesh_ops.batch_axes()
            ep = moe._constrain_ep(cfg)
            per = cfg.moe.n_experts // ep[0]
            mine = tree.map(lambda a: a.clone().requires_grad_(), p)
            for k in ("gate", "up", "down"):
                mine[k] = p[k][ep[1] * per:(ep[1] + 1) * per].clone() \
                    .requires_grad_()
            xl = mesh_ops.cut_tree(x, spec, mesh).requires_grad_()
            y, aux = moe.moe_apply(mine, xl, cfg, impl="capacity_global")
            loss = mesh_ops.reduce_sum(
                (y * mesh_ops.cut_tree(r, spec, mesh)).sum(), axes,
                "t") + aux
            loss.backward()
            grads = tree.map(
                lambda a: mesh_ops.reduce_plain(a.grad, axes, "t"), mine)
            for k in ("gate", "up", "down"):
                grads[k] = mesh_ops.gather_plain(grads[k], 0, ("model",),
                                                 "t")
            out[name] = dict(
                y=mesh_ops.gather_plain(y.detach(), 0, axes, "t").cpu(),
                aux=float(aux.detach()),
                grads=tree.map(lambda a: a.cpu(), grads),
                dx=mesh_ops.gather_plain(xl.grad, 0, axes, "t").cpu())
    return out


def _m_rank(world, jobs):
    """A rank of M1's and M3's worlds: the jobs, then
    :func:`_m3_global` on the grid."""
    from repro_torch.launch import model_mesh
    results = model_mesh.run_steps(world, jobs)
    glob = _m3_global(model_mesh.make_model_mesh(*M_GRID, world.device))
    return (results, glob) if world.rank == 0 else None


def _m_ranks(name: str, res: dict, dryrun_check: bool = True) -> None:
    """Print each rank's peak memory, seconds and metered collective bytes
    a step, beside the dry run's analytic ones; hold its bytes to the dry
    run's ``argument_bytes``."""
    for i, r in enumerate(res["ranks"]):
        line = {"device": r["device"], "peak_GiB": r.get("peak", 0) / 2**30}
        if "bytes" in r:
            b = r["bytes"]
            held = b["params"] + b["opt"] + b["batch"]
            line.update(held=held, dryrun_argument_bytes=b["dryrun"],
                        step_s=r["step_s"],
                        analytic_collectives={k: v for k, v in r[
                            "analytic_collectives"].items() if v})
            if dryrun_check and held != b["dryrun"]:
                raise SystemExit(f"path ({name}) rank {i}: holds {held} B, "
                                 f"the dry run {b['dryrun']} B")
        if "cache_bytes" in r:
            c = r["cache_bytes"]
            line.update(cache=c, cache_shapes=r["cache_shapes"],
                        decode_s=r["decode_s"])
            if "decode_memory" in r:
                line["decode_allocated_GiB"], line["decode_peak_GiB"] = (
                    [round(m[k] / 2**30, 4) for m in r["decode_memory"]]
                    for k in (0, 1))
            if c["held"] != c["dryrun"]:
                raise SystemExit(f"path ({name}) rank {i}: holds "
                                 f"{c['held']} B of caches, the dry run's "
                                 f"blocks {c['dryrun']} B")
        line["collective_bytes"] = {
            ph: m["bytes"] for ph, m in r["meter"].items() if m["bytes"]}
        line["collective_s"] = {
            ph: {k: round(v, 4) for k, v in m["seconds"].items()}
            for ph, m in r["meter"].items() if m["bytes"]}
        print(f"path ({name}) rank {i}: {json.dumps(line)}", flush=True)


def _m1_init(dev, layers: int, clock):
    """granite-moe-3b-a800m cut to ``layers`` layers, drawn here and
    moved to the host: the ranks cut their blocks from the host copy
    (shared memory through spawn's arguments), so the card is theirs
    while they run."""
    import torch
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.models import transformer
    torch.cuda.empty_cache()
    t = clock()
    cfg = _m_cut("granite-moe-3b-a800m", layers)
    p = transformer.init(rnd.PRNGKey(0, dev), cfg)
    print(f"path (M1) init: granite-moe-3b-a800m {layers} layers "
          f"{sum(x.numel() for x in tree.leaves(p)) / 1e9:.3f}B "
          f"parameters, {clock() - t:.2f}s", flush=True)
    host = tree.map(lambda a: a.cpu(), p)
    del p
    torch.cuda.empty_cache()
    return cfg, host


def _m1_ref(dev, cfg, host, toks, labels, n_steps: int, clock):
    """One rank's reference here: the first step's cross entropy on each
    of the grid's data blocks (their mean), then ``n_steps`` train steps
    on the whole batch; (that mean, the losses)."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    p = tree.map(lambda a: a.to(dev), host)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        half = M1_BATCH // M_GRID[1][0]
        ce_blocks = sum(float(transformer.lm_loss(
            p, cfg, toks[i:i + half], labels[i:i + half])[1]["ce"])
            for i in range(0, M1_BATCH, half)) / M_GRID[1][0]
    opt = adamw.init(p)
    step = steps.make_train_step(cfg)
    ref, ref_s = [], []
    for _ in range(n_steps):
        t = clock()
        p, opt, m = step(p, opt, {"tokens": toks, "labels": labels})
        ref_s.append(clock() - t)
        ref.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    print(f"path (M1) one rank, {cfg.n_layers} layers: losses {ref}, "
          f"s/step {[round(x, 3) for x in ref_s]}, peak "
          f"{peak / 2**30:.2f} GiB; first-step cross entropy on the grid's "
          f"data blocks {ce_blocks}", flush=True)
    del p, opt
    torch.cuda.empty_cache()
    return ce_blocks, ref


def _m1_check(name: str, r: dict, ce_blocks: float, ref: list,
              bounds: tuple, knobs: int) -> None:
    """A grid run's losses against one rank's: the first step's cross
    entropy on the same data blocks within ``K3_TOL["loss"]``, each
    step's loss on the whole batch within its bound."""
    got = [m["loss"] for m in r["metrics"]]
    d = [abs(a - b) for a, b in zip(got, ref, strict=True)]
    d_ce = abs(r["metrics"][0]["ce"] - ce_blocks)
    print(f"path ({name}) granite-moe-3b-a800m on the grid, "
          f"REPRO_SHARDED_CE / REPRO_SHARD_MOE {'on' if knobs else 'off'}: "
          f"losses {got}, first-step cross entropy against one rank's "
          f"on the data blocks |d| {d_ce:.3g} (bound {K3_TOL['loss']}); "
          f"against one rank on the whole batch |d| "
          f"{', '.join(f'{x:.3g}' for x in d)} (bounds {bounds})",
          flush=True)
    _m_ranks(name, r)
    if not (d_ce <= K3_TOL["loss"]
            and all(x <= b for x, b in zip(d, bounds))) \
            or not all(np.isfinite(got)):
        raise SystemExit(f"path ({name}): the grid's losses differ from "
                         f"one rank's")


def _m1(dev, layers: int, clock) -> tuple[tuple, float]:
    """(M1) and (M3) on the card: granite-moe-3b-a800m drawn here at
    ``layers`` and at all 32 layers, trained on the grid (``layers``:
    knobs off, then on, 2 steps; 32: knobs on, 1 step) beside M3's jobs,
    then one rank's references here.  Returns M3's results on the card
    and the world's seconds."""
    import torch
    from repro_torch import random as rnd
    from repro_torch.launch import mesh as mesh_lib
    cfg, host = _m1_init(dev, layers, clock)
    cfg_f, host_f = _m1_init(dev, 32, clock)
    toks = rnd.randint(rnd.PRNGKey(1, dev), (M1_BATCH, M1_SEQ), 0,
                       cfg.vocab).to(torch.int32)
    labels = torch.roll(toks, -1, 1)
    jobs = [dict(name="M1F", mesh=M_GRID, cfg=cfg_f, params=host_f,
                 env=M_KNOBS[1], train={"tokens": toks, "labels": labels,
                                        "steps": 1})]
    jobs += [dict(name=f"M1 knobs {k}", mesh=M_GRID, cfg=cfg, params=host,
                  env=M_KNOBS[k], train={"tokens": toks, "labels": labels,
                                         "steps": 2})
             for k in (0, 1)] + _m3_jobs(dev)
    t = time.perf_counter()
    world, glob = mesh_lib.spawn(_m_rank, 4, jobs, device="cuda",
                                 shared_device=True)
    world_s = time.perf_counter() - t
    res = {j["name"]: r for j, r in zip(jobs, world, strict=True)}
    print(f"path (M1, M3) world of 4 gloo ranks on {dev}: {world_s:.1f}s "
          f"for {len(jobs)} jobs", flush=True)

    ce_blocks, ref = _m1_ref(dev, cfg_f, host_f, toks, labels, 1, clock)
    del host_f
    _m1_check("M1F", res["M1F"], ce_blocks, ref, (K3_TOL["loss"],), 1)
    peak = max(r["peak"] for r in res["M1F"]["ranks"]) / 2**30
    print(f"path (M1F) all 32 layers: peak {peak:.2f} GiB a rank (bound "
          f"{M1F_PEAK_GIB})", flush=True)
    if not peak <= M1F_PEAK_GIB:
        raise SystemExit(f"path (M1F): peak {peak:.2f} GiB a rank > "
                         f"{M1F_PEAK_GIB}")
    ce_blocks, ref = _m1_ref(dev, cfg, host, toks, labels, 2, clock)
    del host
    for k in (0, 1):
        _m1_check(f"M1 knobs {k}", res[f"M1 knobs {k}"], ce_blocks, ref,
                  M1_TOL, k)
    return ({n: r for n, r in res.items() if not n.startswith("M1")},
            glob), world_s


def _context_bytes(cfg, b_loc: int) -> int:
    """The ``"context"`` bytes a rank meters a decode step of a GQA model
    whose caches' sequence is cut over ``model``, from the shapes: a layer
    reduces its float32 maxima (b_loc, H) with MAX, then its sums
    (b_loc, H) and unnormalized outputs (b_loc, H, d_head) in one SUM."""
    return cfg.n_layers * b_loc * cfg.n_heads * (2 + cfg.d_head) * 4


def _m2_ref(dev, cfg, p, prompt, max_len: int, clock, dtype=None):
    """One rank's decode here on whole caches of ``max_len`` slots, their
    floating leaves cast to ``dtype`` where it is given: (its logits,
    tokens, seconds a step)."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    t = clock()
    caches = transformer.init_cache(cfg, M2_BATCH, max_len, device=dev)
    if dtype is not None:
        caches = tree.map(lambda a: a.to(dtype) if a.is_floating_point()
                          else a, caches)
    fed, logits, tokens = prompt[:, :1], [], []
    for i in range(M2_PROMPT + M2_DECODE):
        with torch.no_grad():
            lg, nxt, caches = steps.serve_logits(cfg, p, fed, caches)
        logits.append(lg[:, 0])
        if i + 1 < M2_PROMPT:
            fed = prompt[:, i + 1:i + 2]
        else:
            fed = nxt.to(prompt.dtype)
            tokens.append(nxt)
    step_s = (clock() - t) / (M2_PROMPT + M2_DECODE)
    del caches
    return torch.stack(logits, 1), torch.cat(tokens, 1), step_s


def _m2(dev, layers: int, clock, long: bool = True) -> float:
    """(M2), (M2F) and (M2L): yi-6b drawn here once, decoding on the
    grid on caches held as ``rules.cache_specs``' blocks of 6 slots (M2,
    and M2F in float32) and, with ``long``, of ``M2L_SLOTS`` (M2L), in
    one world; then one rank's references here on whole caches, the
    tokens equal and the logits within ``M2F_REL`` relative (float32)
    and, at ``M_LAYERS`` layers, within ``M2_TOL`` (bfloat16).  Each
    rank's cache bytes the dry run's (``M2_CACHE_BYTES`` at ``M_LAYERS``
    for M2 and M2L), its ``"context"`` bytes those reckoned from the
    shapes, its peak a bf16 decode step at most ``M2_PEAK_GIB``.
    Returns the world's seconds."""
    import torch
    from repro_torch import random as rnd
    from repro_torch import tree
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import model_mesh
    from repro_torch.models import transformer
    torch.cuda.empty_cache()
    t = clock()
    cfg = _m_cut("yi-6b", layers)
    p = transformer.init(rnd.PRNGKey(0, dev), cfg)
    prompt = rnd.randint(rnd.PRNGKey(1, dev), (M2_BATCH, M2_PROMPT), 0,
                         cfg.vocab).to(torch.int32)
    init_s = clock() - t
    print(f"path (M2) init: yi-6b {layers} layers "
          f"{sum(x.numel() for x in tree.leaves(p)) / 1e9:.3f}B "
          f"parameters, {init_s:.2f}s", flush=True)
    host = tree.map(lambda a: a.cpu(), p)
    del p
    torch.cuda.empty_cache()
    six = M2_PROMPT + M2_DECODE
    lens = {"M2": (six, None), "M2F": (six, torch.float32)}
    if long:
        lens["M2L"] = (M2L_SLOTS, None)
    jobs = [dict(name=name, mesh=M_GRID, cfg=cfg, params=host, dtype=dt,
                 decode={"prompt": prompt, "steps": M2_DECODE,
                         "max_len": n}) for name, (n, dt) in lens.items()]
    t = time.perf_counter()
    got = mesh_lib.spawn(model_mesh.run_steps, 4, jobs, device="cuda",
                         shared_device=True)
    world_s = time.perf_counter() - t
    p = tree.map(lambda a: a.to(dev), host)
    del host, jobs
    b_loc = M2_BATCH // M_GRID[1][0]
    context = _context_bytes(cfg, b_loc) * six
    for (name, (n, dt)), res in zip(lens.items(), got, strict=True):
        ref_p = p if dt is None else tree.map(lambda a: a.to(dt), p)
        logits, tokens, ref_s = _m2_ref(dev, cfg, ref_p, prompt, n, clock,
                                        dt)
        del ref_p
        d = _maxdiff(res["decode_logits"], logits)
        if dt is None:
            what, bound = "max |d|", M2_TOL if layers == M_LAYERS \
                else float("inf")
        else:
            d /= float(logits.float().abs().max())
            what, bound = "max |d| / max |one rank's|", M2F_REL
        same = torch.equal(res["tokens"].cpu(), tokens.cpu())
        print(f"path ({name}) yi-6b decode on the grid, caches of {n} "
              f"slots held as their rules.cache_specs blocks, "
              f"{dt or 'bfloat16'} ({world_s:.1f}s world with its start): "
              f"logits against one rank on whole caches {what} {d:.4g} "
              f"(bound {bound}), tokens equal: {same} "
              f"({res['tokens'].tolist()}); one rank {ref_s:.3f}s a step; "
              f"\"context\" bytes a rank reckoned from the shapes "
              f"{context}", flush=True)
        _m_ranks(name, res)
        if not d <= bound or not same:
            raise SystemExit(f"path ({name}): the grid's decode differs "
                             f"from one rank's")
        for i, r in enumerate(res["ranks"]):
            metered = r["meter"]["decode"]["bytes"].get("context", 0)
            if metered != context:
                raise SystemExit(f"path ({name}) rank {i}: {metered} "
                                 f"\"context\" bytes metered, {context} "
                                 f"reckoned")
            if layers != M_LAYERS or name not in M2_CACHE_BYTES:
                continue
            held = r["cache_bytes"]["held"]
            if held != M2_CACHE_BYTES[name]:
                raise SystemExit(f"path ({name}) rank {i}: {held} B of "
                                 f"caches, not {M2_CACHE_BYTES[name]}")
            peak = max(m[1] for m in r["decode_memory"]) / 2**30
            if not peak <= M2_PEAK_GIB:
                raise SystemExit(f"path ({name}) rank {i}: a decode step "
                                 f"peaks at {peak:.2f} GiB > {M2_PEAK_GIB}")
    del p, logits
    torch.cuda.empty_cache()
    return world_s


def path_m(dev, layers: int = M_LAYERS) -> dict:
    """(M1) granite-moe-3b-a800m trained and (M2, M2L) yi-6b decoding on
    caches cut over ``model``, both at their published widths
    (``layers`` of their 32 layers) on a (data 2, model 2) grid of 4
    gloo ranks on this card, against the one-rank port in this process,
    each model in a world of its own (one model's parameters held here
    at a time); (M3) deepseek-v3 and jamba reduced, expert-parallel, and
    xlstm-350m reduced, on the card's grid (M1's world) against the
    same grid on the CPU: the model, and, for the first two,
    ``moe_apply(impl="capacity_global")`` called on the grid."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    launches = dict(ops.LAUNCHES)
    t_all = time.perf_counter()

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    (m3, m3_glob), world1_s = _m1(dev, layers, clock)
    world2_s = _m2(dev, layers, clock)

    # M3: the card's grid against the CPU's, expert-parallel
    t = time.perf_counter()
    cpu, cpu_glob = mesh_lib.spawn(_m_rank, 4, _m3_jobs("cpu"),
                                   device="cpu")
    cpu_s = time.perf_counter() - t
    worst = dict.fromkeys(("step_loss", "logits", "decode", "step_params"),
                          0.0)
    for job, want in zip(_m3_jobs("cpu"), cpu):
        got = m3[job["name"]]
        diff = {"step_loss": abs(got["metrics"][0]["loss"]
                                 - want["metrics"][0]["loss"]),
                "logits": _maxdiff(got["prefill"], want["prefill"]),
                "decode": _maxdiff(got["decode_logits"],
                                   want["decode_logits"]),
                "step_params": max(_maxdiff(a, b) for a, b in zip(
                    tree.leaves(got["params"][0]),
                    tree.leaves(want["params"][0])))}
        r0 = got["ranks"][0]
        calls = sum(sum(m["calls"].values()) for m in r0["meter"].values())
        print(f"path (M3) {job['name']}: card grid against CPU grid "
              + ", ".join(f"{k} {v:.3g}" for k, v in diff.items())
              + f"; rank 0 on the card: prefill {r0['prefill_s']:.2f}s, "
                f"decode {sum(r0['decode_s']):.2f}s, step "
                f"{r0['step_s'][0]:.2f}s, {calls} collectives", flush=True)
        for k, v in diff.items():
            worst[k] = max(worst[k], v)
            if not v <= K3_TOL[k]:
                raise SystemExit(f"path (M3) {job['name']}: {k} {v} > "
                                 f"{K3_TOL[k]}")
    # the dispatcher no layer calls, float32: output and gradients held
    # as logits, the aux loss as a loss
    bound = {"y": K3_TOL["logits"], "dx": K3_TOL["logits"],
             "grads": K3_TOL["logits"], "aux": K3_TOL["loss"]}
    for name, want in cpu_glob.items():
        got = m3_glob[name]
        diff = {"y": _maxdiff(got["y"], want["y"]),
                "dx": _maxdiff(got["dx"], want["dx"]),
                "grads": max(_maxdiff(a, b) for a, b in zip(
                    tree.leaves(got["grads"]), tree.leaves(want["grads"]),
                    strict=True)),
                "aux": abs(got["aux"] - want["aux"])}
        print(f"path (M3) {name} moe_apply(impl='capacity_global') on the "
              f"grid: card against CPU "
              + ", ".join(f"{k} {v:.3g}" for k, v in diff.items()),
              flush=True)
        for k, v in diff.items():
            if not v <= bound[k]:
                raise SystemExit(f"path (M3) {name} capacity_global: {k} "
                                 f"{v} > {bound[k]}")
    print(f"path (M3): within {K3_TOL}; CPU grid {cpu_s:.1f}s", flush=True)
    if dict(ops.LAUNCHES) != launches:
        raise SystemExit("path (M) launched a TM kernel")
    total = time.perf_counter() - t_all
    print(f"path (M): {total:.1f}s", flush=True)
    return {"world_s": (world1_s, world2_s), "total_s": total, "m3": worst}


def main(argv: list[str]) -> int:
    if argv and (len(argv) != 2 or argv[0] != "--path-m"
                 or not argv[1].isdigit()):
        print("usage: python3 chip_smoke.py [--path-m LAYERS]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.core import tm
    from repro_torch.data import partition, synthetic
    from repro_torch.data.ingest import mirror, natural, registry
    from repro_torch.core import clustering
    from repro_torch.fl import obs
    from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                        RuntimeConfig, Scheduler,
                                        SchedulerConfig, TPFLStrategy)
    from repro_torch.fl.serve import ModelRegistry, ServingPlane
    from repro_torch.kernels import (_build, clause_eval, draws, ops, ref,
                                     ta_update, train_epoch)
    from repro_torch.launch import fed_serve, fed_train

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
    if argv:
        path_m(dev, layers=int(argv[1]))
        print(smi, flush=True)
        return 0

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    for name, info in built.items():
        for func, line in ptxas_lines(info["log"]):
            print(f"  ptxas {name} {func}: {line}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in ((20, 10, 300, 1568, 40), (32, 10, 300, 1568, 1),
                  (1, 10, 300, 1568, 1), (1, 10, 300, 1568, 40)):
        print(f"  votes plan (N, C, m, L, B)={shape} on {sms} SMs: "
              f"{clause_eval.plan(*shape, sms=sms)}", flush=True)

    # path (M): the model scaffold on a torch mesh, 4 gloo ranks on this
    # card: granite-moe-3b-a800m trained and yi-6b decoding at their
    # published widths, deepseek-v3 and jamba expert-parallel.  First,
    # while this process holds nothing on the card: at all 32 layers the
    # four ranks take about 70 of its 80 GB
    path_m(dev)

    # 3. kernels against their plain versions, exactly
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err: dict = {}
    for shape, wmax in (((20, 10, 300, 1568, 40), 7), ((3, 3, 33, 130, 7), 7),
                        ((32, 10, 300, 1568, 1), 7),
                        ((2, 3, 33, 130, 130), 1 << 15)):
        args = vote_inputs(gen, *shape, dev, wmax)
        for predict in (True, False):
            exact("fused_votes_batched",
                  ops.fused_votes_batched(*args, predict),
                  ref.fused_votes_batched_ref(*args, predict),
                  f"(N, C, m, L, B)={shape} predict={predict}", err)
    for N, S, C, m, L in ((20, 80, 10, 300, 1568), (4, 17, 3, 33, 130)):
        args = epoch_inputs(gen, N, S, C, m, L, 63, dev)
        got = ops.train_epoch_fused(*args, **K1_KW)
        want = train_epoch.train_epoch_plain(*args, **K1_KW)
        what = (f"N={N} S={S} C={C} m={m} L={L} plan "
                f"{train_epoch.plan(N, C, m, L)}")
        moved = int((want[0] != args[0]).sum())
        exact("train_epoch_fused", got[0], want[0],
              f"{what} TA states ({moved} changed)", err)
        exact("train_epoch_fused", got[1], want[1], f"{what} weights", err)
        if moved == 0:
            raise SystemExit("train_epoch_fused changed nothing")
        del args, got, want

    # the global plan (include bits in device memory): at 62 classes, the
    # only plan that holds FEMNIST's width, and forced where the shared
    # plan holds the shape (the training path's C = 10, and unaligned)
    for N, S, C, m, L, forced in ((20, 80, 62, 300, 1568, False),
                                  (20, 80, 10, 300, 1568, True),
                                  (4, 17, 3, 33, 130, True)):
        args = epoch_inputs(gen, N, S, C, m, L, 63, dev)
        plan = train_epoch.plan(N, C, m, L, inc_global=forced)
        if not plan.inc_global or (not forced and train_epoch.plan(
                N, C, m, L).inc_global != 1):
            raise SystemExit(f"no global plan at {(N, C, m, L)}")
        got = train_epoch.train_epoch_fused(*args, **K1_KW,
                                            inc_global=forced)
        want = train_epoch.train_epoch_plain(*args, **K1_KW)
        what = f"N={N} S={S} C={C} m={m} L={L} global plan {plan}"
        moved = int((want[0] != args[0]).sum())
        exact("train_epoch_fused", got[0], want[0],
              f"{what} TA states ({moved} changed)", err)
        exact("train_epoch_fused", got[1], want[1], f"{what} weights", err)
        if moved == 0:
            raise SystemExit("train_epoch_fused changed nothing")
        del args, got, want
    args = vote_inputs(gen, 20, 62, 300, 1568, 40, dev, 7)
    for predict in (True, False):
        exact("fused_votes_batched", ops.fused_votes_batched(*args, predict),
              ref.fused_votes_batched_ref(*args, predict),
              f"(N, C, m, L, B)=(20, 62, 300, 1568, 40) predict={predict}",
              err)
    del args

    for N, C, m, L, B in ((20, 10, 300, 1568, 1), (3, 3, 33, 130, 7)):
        include, lits, _ = vote_inputs(gen, N, C, m, L, B, dev)
        inc = include.reshape(N, C * m, L)
        for predict in (True, False):
            exact("clause_outputs", ops.clause_outputs(inc, lits, predict),
                  ref.clause_outputs_ref(inc, lits, predict),
                  f"N={N} B={B} CM={C * m} L={L} predict={predict}", err)
    for C, m, L, B in ((10, 300, 1568, 1), (10, 300, 1568, 40),
                       (3, 33, 130, 7), (10, 300, 1568, 130),
                       (3, 33, 130, 130)):
        include, lits, wpol = (a[0] for a in vote_inputs(
            gen, 1, C, m, L, B, dev, 7 if B < 130 else 1 << 15))
        for predict in (True, False):
            exact("fused_votes", ops.fused_votes(include, lits, wpol,
                                                 predict),
                  ref.fused_votes_ref(include, lits, wpol, predict),
                  f"C={C} m={m} L={L} B={B} predict={predict}", err)
    kw_step = dict(T=40, p_inc=TA_P[0], p_dec=TA_P[1], n_states=63)
    for N, C, m, L in ((20, 10, 300, 1568), (3, 3, 33, 130)):
        ta, *args = step_inputs(gen, N, C, m, L, 63, 40, dev)
        got, want, stats = ta.clone(), ta.clone(), {}
        ops.ta_update_(got, *args, **kw_step)
        ta_update.ta_update_plain(want, *args, **kw_step, stats=stats)
        exact("ta_update", got, want,
              f"N={N} C={C} m={m} L={L} plan "
              f"{ta_update.plan(N, C, m, L)} (moved "
              f"{int((want != ta).sum())} states; rows {stats})", err)
        if stats["type1_rows"] == 0 or stats["type2_rows"] == 0:
            raise SystemExit("ta_update: a check without Type I or Type II "
                             "rows")
    torch.cuda.synchronize()
    del include, lits, wpol, inc, args, want, ta, got

    # 4. the data path, each step timed on the card
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    setup = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t
        return out

    timed("pool_draw", lambda: synthetic.make_dataset(
        "synthmnist", 6000, rnd.PRNGKey(0, dev), side=28))
    timed("mirror_write", lambda: mirror.write_idx_mirror(
        DATA_DIR / "mnist", "synthmnist", 6000, 28, 0, device=dev))
    pool = timed("mirror_read_encode", lambda: registry.load(
        "mnist", DATA_DIR, n_samples=6000, side=12, seed=0, device=dev))
    full = [timed(f"partition_{i}", lambda: natural.partition_pool(
        pool, n_clients=20, n_train=80, n_test=40, n_conf=40,
        key=rnd.PRNGKey(1, dev), experiment=5)) for i in (1, 2)]
    print("data path set-up (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in setup.items()), flush=True)
    digests = {partition.sha256(d) for d in full}
    print(f"check full-width partition: sha256 {sorted(digests)} "
          f"(reference {FULL_WIDTH_SHA256})", flush=True)
    if digests != {FULL_WIDTH_SHA256}:
        raise SystemExit("the full-width partition drawn on the card is "
                         "not the reference's")
    small_parts = []
    for d in ("cpu", dev):
        x6, y6, _ = synthetic.make_dataset("synthmnist", 600,
                                           rnd.PRNGKey(0, d), side=12)
        small_parts.append(partition.sha256(partition.partition(
            x6, y6, 10, n_clients=6, experiment=3, key=rnd.PRNGKey(42, d),
            n_train=16, n_test=8, n_conf=8)))
    if small_parts[0] != small_parts[1]:
        raise SystemExit("the 6-client partition differs between the card "
                         "and the CPU")
    print("check 6-client partition: GPU == CPU bit for bit", flush=True)
    del pool, full

    # 5. the training path at full width, through the CLI entry point
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

    # 6. the path went through its kernels, and its output is sane
    for name in ("fused_votes_batched", "train_epoch_fused"):
        if launches[name] <= 0:
            raise SystemExit(f"{name} never launched on the training path")
    if launches["train_epoch_fused"] != 2 * 2:
        raise SystemExit("the fused epoch did not launch once per local "
                         "epoch (2 rounds x 2)")
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
    x, y, _ = synthetic.make_dataset("synthmnist", 400, rnd.PRNGKey(0, "cpu"),
                                     side=12)
    small_cfg = tm.TMConfig(n_classes=10, n_clauses=16, n_features=144,
                            n_states=63, s=5.0, T=40)
    for kw in ({}, dict(top_classes=2, conf_threshold=2.0,
                        weighted_confidence=True)):
        small = []
        for d in ("cpu", "cuda"):
            data = partition.partition(x, y, 10, n_clients=4, experiment=5,
                                   key=rnd.PRNGKey(1, d), n_train=16,
                                   n_test=8, n_conf=8)
            eng = Engine(TPFLStrategy(small_cfg, local_epochs=2, **kw),
                         data, RuntimeConfig(rounds=2))
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

    # 7. path (A): serve the training path's newest checkpoint
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with Capture(ops, "fused_votes") as cap4, \
            Capture(ops, "fused_votes_batched", first=True) as cap2:
        served = fed_serve.main(SERVE_ARGS)
        torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    launches_a = dict(ops.LAUNCHES)
    print(f"path (A) serving: {serve_wall:.2f}s wall, launches "
          f"{launches_a}, result "
          f"{ {k: v for k, v in served.items() if k != 'latencies_s'} }",
          flush=True)
    if launches_a["fused_votes_batched"] != 8 + 1 \
            or launches_a["fused_votes"] != 20:
        raise SystemExit("serving did not launch fused_votes_batched 8 + 1 "
                         "times and fused_votes 20 times")
    if served["mismatches"] != 0 or served["verified_clients"] != 20 \
            or served["version"] != 2:
        raise SystemExit(f"serving parity failed: {served}")
    # the same requests once more, in the same process: a slow first
    # batch is a first-call cost, slow batches in both a stall
    again = fed_serve.main(SERVE_ARGS)
    if again["mismatches"] != 0:
        raise SystemExit(f"serving parity failed: {again}")
    for i, out in enumerate((served, again)):
        print(f"path (A) serving pass {i + 1}: batch latencies in order "
              f"(us) {[round(t * 1e6) for t in out['latencies_s']]}",
              flush=True)

    # 8. path (B): the unit-weight TM through the per-sample scan, then
    # the single-model API on one client
    data, cfg, _, _ = fed_train.build_scenario(
        dataset="mnist", data_dir=str(DATA_DIR), clients=20, clauses=300,
        device=dev)
    unit = dataclasses.replace(cfg, weighted=False)
    eng_b = Engine(TPFLStrategy(unit, local_epochs=1), data,
                   RuntimeConfig(rounds=1))
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Capture(ops, "clause_outputs") as cap3, \
            Capture(ops, "ta_update_") as cap5:
        st_b, (rep_b,) = eng_b.run(rnd.PRNGKey(3, dev))
        torch.cuda.synchronize()
    unit_s = time.perf_counter() - t0
    launches_b = dict(ops.LAUNCHES)
    S = data.x_train.shape[1]
    acc = rep_b.per_client_accuracy
    print(f"path (B) unit-weight round: {unit_s:.2f}s wall, "
          f"{data.x_train.shape[0]} clients x {S} sample steps, launches "
          f"{launches_b}, mean accuracy "
          f"{float(rep_b.mean_accuracy):.4f}", flush=True)
    if launches_b["clause_outputs"] != S or launches_b["ta_update"] != S:
        raise SystemExit("the unit-weight round did not launch "
                         "clause_outputs once and ta_update once per step")
    if not bool(((acc >= 0) & (acc <= 1)).all()) \
            or not bool((st_b.client_state.weights == 1).all()) \
            or int(st_b.client_state.ta_state.min()) < 1:
        raise SystemExit("unit-weight round: bad accuracies or state")
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    one = tm.train(tm.init_params(cfg, rnd.PRNGKey(4, dev)),
                   data.x_train[0], data.y_train[0], rnd.PRNGKey(5, dev),
                   cfg, epochs=2)
    one_acc = float(tm.accuracy(one, data.x_test[0], data.y_test[0], cfg))
    conf = tm.confidence_scores(one, data.x_conf[0], cfg)
    torch.cuda.synchronize()
    launches_1 = dict(ops.LAUNCHES)
    print(f"single-model API: accuracy {one_acc:.4f}, confidence "
          f"{conf.tolist()}, launches {launches_1}", flush=True)
    if (launches_1["train_epoch_fused"], launches_1["fused_votes"],
            launches_1["clause_outputs"]) != (2, 1, 1) \
            or not 0.0 <= one_acc <= 1.0 or conf.shape != (10,):
        raise SystemExit("the single-model API did not run through its "
                         "kernels")

    # path (C): FedTM on a weighted 10-of-20 cohort with dropout and
    # stragglers, through the CLI entry point
    round_c = []

    def timed_round_c(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_round(self, *a, **kw)
        torch.cuda.synchronize()
        round_c.append(time.perf_counter() - t)
        return out

    Engine.run_round = timed_round_c
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    try:
        with Capture(ops, "train_epoch_fused") as cap1c:
            result_c = fed_train.main(PATH_C_ARGS)
            torch.cuda.synchronize()
    finally:
        Engine.run_round = run_round
    wall_c = time.perf_counter() - t0
    launches_c = dict(ops.LAUNCHES)
    print(f"path (C) FedTM, 10 of 20 clients: {wall_c:.2f}s wall for 2 "
          f"rounds (rounds {[round(t, 4) for t in round_c]} s), launches "
          f"{launches_c}", flush=True)
    if launches_c["train_epoch_fused"] != 2 * 2 \
            or launches_c["fused_votes_batched"] != 2:
        raise SystemExit("path (C) did not launch the fused epoch once per "
                         "local epoch and the fused votes once per round")
    if cap1c.args[0][0].shape[0] != 10:
        raise SystemExit("path (C)'s fused epoch did not run on the "
                         "10-client cohort")
    # the scheduler's draw, recomputed on the card from the same keys
    # (the engine's ``sample`` draws on the host)
    data_c, _, _, fedtm = fed_train.build_scenario(
        dataset="mnist", data_dir=str(DATA_DIR), clients=20, clauses=300,
        strategy="fedtm", device=dev)
    sched_c = Scheduler(SchedulerConfig(**PATH_C), 20, data_c.sizes)
    k_rounds = rnd.split(rnd.PRNGKey(0, dev))[1]
    for rep in result_c["reports"]:
        part = sched_c.draw(rep.round_idx,
                            rnd.fold_in(k_rounds, rep.round_idx))
        arrive = part.active & (part.staleness == 0)
        got = rep.participation
        print(f"path (C) round {rep.round_idx}: sampled "
              f"{got.idx.tolist()}, active {int(got.active.sum())}/10, "
              f"late {int((got.active & (got.staleness > 0)).sum())}, agg "
              f"{rep.aggregated_uploads}", flush=True)
        if not all(torch.equal(getattr(got, f), getattr(part, f))
                   for f in ("idx", "active", "staleness")) \
                or rep.aggregated_uploads != int(arrive.sum()):
            raise SystemExit(f"path (C) round {rep.round_idx}: active / "
                             f"aggregated counts differ from the scheduler's "
                             f"draw")
        acc = rep.per_client_accuracy
        if acc.shape != (20,) or not bool(((acc >= 0) & (acc <= 1)).all()):
            raise SystemExit(f"path (C) round {rep.round_idx}: bad "
                             f"accuracies {acc}")
    st_c = result_c["state"]
    if int(st_c.client_state.ta_state.min()) < 1 \
            or int(st_c.client_state.ta_state.max()) > 126 \
            or st_c.server.slots.shape != (1, 3000):
        raise SystemExit("path (C): final state out of range")

    # path (D): the lossy wire (int8, sparse delta, varint+RLE indices,
    # error feedback) at the training path's width, through the CLI entry
    # point, with telemetry recorded
    round_d = []

    def timed_round_d(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_round(self, *a, **kw)
        torch.cuda.synchronize()
        round_d.append(time.perf_counter() - t)
        return out

    Engine.run_round = timed_round_d
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    try:
        result_d = fed_train.main(PATH_D_ARGS)
        torch.cuda.synchronize()
    finally:
        Engine.run_round = run_round
    wall_d = time.perf_counter() - t0
    launches_d = dict(ops.LAUNCHES)
    print(f"path (D) lossy wire: {wall_d:.2f}s wall for 2 rounds (rounds "
          f"{[round(t, 4) for t in round_d]} s), launches {launches_d}",
          flush=True)
    if launches_d["train_epoch_fused"] != 2 * 2 \
            or launches_d["fused_votes_batched"] != 2 * 2:
        raise SystemExit("path (D) did not launch the fused epoch once per "
                         "local epoch and the fused votes twice a round")
    # a dense int8 frame is 4 (scale) + m bytes, a sparse frame 1 more
    # (its flag), an upload 4 more (its slot id); float32: 4·m
    for rep_d, rep_f in zip(result_d["reports"], result["reports"]):
        sent = int(rep_d.participation.active.sum())
        populated = int((rep_d.cluster_counts > 0).sum())
        applied = int((rep_d.assignment >= 0).sum())
        print(f"path (D) round {rep_d.round_idx}: up={rep_d.upload_bytes}B "
              f"down_bc={rep_d.download_bytes_broadcast}B "
              f"down_pc={rep_d.download_bytes_per_client}B against "
              f"float32 up={rep_f.upload_bytes}B "
              f"down_bc={rep_f.download_bytes_broadcast}B "
              f"down_pc={rep_f.download_bytes_per_client}B", flush=True)
        if not 0 < rep_d.upload_bytes <= sent * (4 + 1 + 4 + 300) \
                or rep_d.download_bytes_broadcast != populated * (4 + 300) \
                or rep_d.download_bytes_per_client != applied * (4 + 300) \
                or rep_f.upload_bytes != sent * (4 + 4 * 300):
            raise SystemExit(f"path (D) round {rep_d.round_idx}: metered "
                             f"bytes out of their frames' sizes")
        acc = rep_d.per_client_accuracy
        if acc.shape != (20,) or not bool(((acc >= 0) & (acc <= 1)).all()):
            raise SystemExit(f"path (D) round {rep_d.round_idx}: bad "
                             f"accuracies {acc}")
    st_d = result_d["state"]
    if st_d.ref_vecs.shape != (20, 10, 300) \
            or st_d.ef_residual.shape != (20, 10, 300) \
            or not bool(torch.isfinite(st_d.server.slots).all()) \
            or not bool((st_d.ef_residual != 0).any()) \
            or int((st_d.ref_round == 1).sum()) == 0:
        raise SystemExit("path (D): the wire's lanes are not as expected")
    events_d = obs.read_events(RUN_DIR / "telemetry_d" / "events.jsonl")
    if [e["bytes"]["upload"] for e in events_d] != \
            [r.upload_bytes for r in result_d["reports"]]:
        raise SystemExit("path (D): events.jsonl disagrees with the reports")
    print("path (D) span medians (ms): " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in sorted(
            obs.phase_medians(events_d).items(), key=lambda kv: -kv[1])),
        flush=True)
    for e in events_d:
        print(f"path (D) round {e['round']} spans (ms): " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in e["phases"].items()),
            flush=True)

    # path (E): the DL baselines (MLP 784-128-10) at the same width
    eng_e, st_e = path_e(dev, x, y)

    # path (F): async buffered TPFL at the same width
    eng_f, st_f, launches_f = path_f(dev, x, y)

    # path (G): FEMNIST at full width, 62 classes on the global plan
    g = path_g(dev)

    # path (H): the mmap client store, in process, through the CLIs, and
    # 1000 FEMNIST clients streamed
    path_h(dev, g["peak"])

    # path (I): the transports, loopback worker peers and socket worker
    # processes on this card
    a1w, kw1w = path_i(dev, result, round_s, err)

    # path (J): the multi-device backend, the CLI on one NCCL rank and 4
    # gloo ranks sharing this card
    path_j(dev, result)

    # path (K): the model scaffold, yi-6b served and granite-moe-3b-a800m
    # trained at full width, every reduced() architecture card == CPU
    path_k(dev)

    # path (L): the legacy federation loop and the round constructors at the
    # training path's width, the federated dry run's sections, the examples
    launches_l = path_l(dev)["launches"]

    # 9. small runs on the card against the same on the CPU: the
    # unit-weight federation, and a checkpoint and its serving
    small = []
    for d in ("cpu", "cuda"):
        part = partition.partition(x, y, 10, n_clients=4, experiment=5,
                                   key=rnd.PRNGKey(1, d), n_train=8,
                                   n_test=8, n_conf=8)
        st, reps = Engine(TPFLStrategy(dataclasses.replace(
            small_cfg, weighted=False), local_epochs=2), part,
            RuntimeConfig(rounds=2)).run(rnd.PRNGKey(5, d))
        small.append(convert.to_numpy(
            [*st.client_state, st.server.slots,
             *(r.per_client_accuracy for r in reps)]))
    if not all(np.array_equal(a, b) for a, b in zip(*small)):
        raise SystemExit("small unit-weight federation: GPU and CPU runs "
                         "disagree")
    print("check small unit-weight federation: GPU == CPU bit for bit",
          flush=True)
    for name, sched in (
            ("tpfl", dict(participation=0.5, dropout=0.3, straggler=0.3)),
            ("tpfl", dict(participation=0.5, sampling="round_robin")),
            ("tpfl", dict(participation=0.5, sampling="weighted")),
            ("fedtm", dict(participation=0.5, sampling="weighted",
                           dropout=0.3, straggler=0.3))):
        small = []
        for d in ("cpu", "cuda"):
            part = partition.partition(x, y, 10, n_clients=6, experiment=5,
                                   key=rnd.PRNGKey(1, d), n_train=16,
                                   n_test=8, n_conf=8)
            cls = FedTMStrategy if name == "fedtm" else TPFLStrategy
            rt = RuntimeConfig(rounds=2, scheduler=SchedulerConfig(**sched))
            st, reps = Engine(cls(small_cfg, local_epochs=2), part,
                              rt).run(rnd.PRNGKey(3, d))
            small.append(convert.to_numpy(
                [*st.client_state, st.server.slots,
                 *(r.per_client_accuracy for r in reps),
                 *(r.assignment for r in reps),
                 *(t for r in reps for t in r.participation)])
                + [[(r.upload_bytes, r.aggregated_uploads) for r in reps]])
        if not all(np.array_equal(a, b) for a, b in zip(*small)):
            raise SystemExit(f"small federation {name} {sched}: GPU and CPU "
                             f"runs disagree")
        print(f"check small federation {name} {sched}: GPU == CPU bit for "
              f"bit", flush=True)
    # the lossy wire: the codec on the host, non-integer aggregates in
    # XLA's order for the shape on the card
    for flags in SMALL_LOSSY:
        small = []
        for d in ("cpu", "cuda"):
            out = fed_train.main(["--clients", "6", "--clauses", "16",
                                  "--rounds", "2", "--local-epochs", "2",
                                  "--device", d, *flags])
            st = out["state"]
            small.append(convert.to_numpy(
                [*st.client_state, st.server.slots, st.ref_vecs,
                 st.ref_round, st.ef_residual,
                 *(r.per_client_accuracy for r in out["reports"]),
                 *(r.assignment for r in out["reports"])])
                + [[(r.upload_bytes, r.download_bytes_broadcast,
                     r.download_bytes_per_client, r.aggregated_uploads)
                    for r in out["reports"]]])
        if not all(np.array_equal(a, b) for a, b in zip(*small)):
            raise SystemExit(f"small lossy federation {flags}: GPU and CPU "
                             f"runs disagree")
        print(f"check small lossy federation {' '.join(flags)}: GPU == CPU "
              f"bit for bit", flush=True)
    agg_gen = np.random.default_rng(0)
    for n_slots, m in ((10, 300), (1, 3000), (62, 16)):
        up = (agg_gen.integers(-127, 128, (20, m)).astype(np.float32)
              * np.float32(0.37)).astype(np.float32)
        ids = torch.as_tensor(agg_gen.integers(-1, n_slots, 20)
                              .astype(np.int32))
        want = clustering.aggregate(torch.as_tensor(up), ids, n_slots)
        runs = [clustering.aggregate(torch.as_tensor(up, device=dev),
                                     ids.to(dev), n_slots)
                for _ in range(3)]
        if not all(torch.equal(r.cluster_weights.cpu(),
                               want.cluster_weights) for r in runs):
            raise SystemExit(f"aggregate of non-integer uploads ({n_slots} "
                             f"slots, m={m}): three runs on the card and "
                             f"the CPU disagree")
        print(f"check aggregate of 20 non-integer uploads ({n_slots} slots, "
              f"m={m}): three GPU runs == CPU bit for bit", flush=True)
    small = []
    flags = ["--clients", "4", "--clauses", "16", "--local-epochs", "1"]
    for d in ("cpu", "cuda"):
        ck = RUN_DIR / f"small_{d}"
        fed_train.main(flags + ["--device", d, "--rounds", "2",
                                "--ckpt-dir", str(ck), "--ckpt-every", "1"])
        out = fed_serve.main(flags + ["--device", d, "--ckpt-dir", str(ck),
                                      "--batch", "8", "--requests", "2",
                                      "--verify-offline"])
        part, _, _, strat = fed_train.build_scenario(
            dataset="synthmnist", clients=4, clauses=16, local_epochs=1,
            device=d)
        plane = ServingPlane(strat, ModelRegistry(ck / "registry"),
                             Engine(strat, part, RuntimeConfig()).init(
                                 rnd.split(rnd.PRNGKey(0, d))[0]))
        plane.refresh()
        ids = np.array([0, 1, 2, 3, 3, 2, 1, 0])
        preds = plane.predict(ids, torch.cat([part.x_test[:, 0],
                                              part.x_test[:, 1]]))
        small.append(([(ck / f"round_00000{r}.msgpack").read_bytes()
                       for r in (1, 2)], preds, out["mismatches"]))
    (ck_c, pr_c, mm_c), (ck_g, pr_g, mm_g) = small
    if ck_c != ck_g or not np.array_equal(pr_c, pr_g) or mm_c or mm_g:
        raise SystemExit("small checkpoint + serve: GPU and CPU disagree")
    print("check small checkpoint + serve: checkpoints byte-identical, "
          "predictions GPU == CPU", flush=True)

    # 10. times at each path's shapes
    cfg = tm.TMConfig(n_classes=10, n_clauses=300, n_features=784,
                      n_states=63, s=5.0, T=40)
    data, _, _, strategy = fed_train.build_scenario(
        dataset="mnist", data_dir=str(DATA_DIR), clients=20, clauses=300,
        device=dev)
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
    k2_bytes, k2_ops = vote_work(*votes)

    S = data.x_train.shape[1]
    W = (L + 31) // 32
    ekeys = rnd.split(rnd.split(rnd.PRNGKey(1, dev), N), 2)[:, 0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    offs, role_keys = draws.epoch_keys(ekeys, S, C)
    torch.cuda.synchronize()
    keys_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    draws.role_draws(role_keys, m, L, 0.8, 0.2)
    torch.cuda.synchronize()
    draws_ms = (time.perf_counter() - t) * 1e3
    ys = data.y_train.to(torch.int32)
    epoch = (state.client_state.ta_state, state.client_state.weights,
             tm.literals(data.x_train).contiguous(),
             torch.stack([ys, (ys + offs) % C], -1).contiguous(), role_keys)
    del offs
    k1_ms = cuda_ms(lambda: ops.train_epoch_fused(*epoch, **K1_KW), reps=5)
    # the plain version draws the coin plane; coins are hashed only for
    # the rows that take Type I feedback
    stats = {}
    k1_plain = cuda_ms(lambda: train_epoch.train_epoch_plain(
        *epoch, **K1_KW, stats=stats), reps=1, warmup=0)
    k1_plan = train_epoch.plan(N, C, m, L)
    k1_bytes = (2 * 4 * N * C * m * L + 2 * 4 * N * C * m + 4 * N * S * L
                + 4 * N * S * 2 + 8 * N * S * 2 * 3 * 2)
    # the least int32 issue time a coin takes, from the built kernel's
    # SASS (a TA-pass item holds kItemWords coins a lane); the activation
    # draws are counted at a coin's cost, and the clause outputs at one
    # AND-NOT-OR (LOP3) a word
    item = int(re.search(r"kItemWords = (\d+)", (
        _build.CSRC / "epoch_plan.h").read_text()).group(1))
    sass = subprocess.run(
        [str(Path(_build.nvcc()).with_name("cuobjdump")), "-sass",
         str(_build.library_path("train_epoch"))], capture_output=True,
        text=True, check=True, timeout=120).stdout
    mix = coin_mix(sass, item, "train_epoch_kernelILb0E")
    k1_hashes = stats["type1_rows"] * L + N * 2 * S * m
    k1_ops = mix["units"] * k1_hashes + (2 * S) * N * m * W
    print("train_epoch_fused instructions a coin (cuobjdump -sass): "
          + ", ".join(f"{k} {v:g}" for k, v in mix.items()), flush=True)
    print(f"epoch_keys (plain torch, one epoch, N={N} S={S}): "
          f"{keys_ms:.2f} ms; the plain coin plane of those keys "
          f"(draws.role_draws, no longer on the main path): {draws_ms:.1f} ms",
          flush=True)
    print(f"train_epoch_fused plan at (N, C, m, L)=({N}, {C}, {m}, {L}): "
          f"{k1_plan}: {k1_plan.cluster * N} blocks", flush=True)
    print(f"train_epoch_fused bound: {k1_bytes / 1e9:.3f} GB, "
          f"{k1_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"{stats['type1_rows']} Type I rows of {N * S * 2 * m}, "
          f"{k1_hashes} hashes, {k1_ops:.4e} int32 issue units, "
          f"{k1_ops / INT32_OPS_PER_S * 1e3:.4f} ms", flush=True)
    # one epoch of the main path (tm._epoch): one launch and no coin plane
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n1 = ops.LAUNCHES["train_epoch_fused"]
    tm._epoch(epoch[0], epoch[1], data.x_train, data.y_train, ekeys, cfg)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - base
    plane = N * S * 2 * m * L
    print(f"main-path epoch: {ops.LAUNCHES['train_epoch_fused'] - n1} "
          f"launch, peak device memory {above / 1e9:.3f} GB above its "
          f"inputs (the coin plane alone: {plane / 1e9:.3f} GB)", flush=True)
    if ops.LAUNCHES["train_epoch_fused"] != n1 + 1 or above >= plane:
        raise SystemExit("the main path's epoch did not take one launch "
                         "without a coin plane")
    # alone as the clients grow (the round's clients repeated): the
    # cluster shrinks as the clients fill the card, so each block owns
    # more clauses and hashes more coins a step
    two = tuple(torch.cat([a, a]) for a in epoch)
    sweep = {}
    for n in (1, 5, 10, 20, 33):
        k = train_epoch.plan(n, C, m, L).cluster
        sweep[n] = (k, device_ms(lambda n=n: ops.train_epoch_fused(
            *(a[:n] for a in two), **K1_KW), 3, "train_epoch_kernel"))
    del two
    print("train_epoch_fused alone by clients (blocks a client): "
          + ", ".join(f"{n} ({k}) {v:.4f} ms" for n, (k, v) in
                      sweep.items()), flush=True)
    # kernel 1 on path (C)'s last epoch: the 10-client cohort, its bound
    # counted as the main path's from this epoch's Type I rows
    a1c, kw1c = cap1c.args
    n1c = a1c[0].shape[0]
    k1c_plan = train_epoch.plan(*a1c[0].shape)
    k1c_alone = device_ms(lambda: ops.train_epoch_fused(*a1c, **kw1c), 5,
                          "train_epoch_kernel")
    k1c_ms = cuda_ms(lambda: ops.train_epoch_fused(*a1c, **kw1c), reps=5)
    stats_c, plain_c = {}, []
    k1c_plain = cuda_ms(lambda: plain_c.append(train_epoch.train_epoch_plain(
        *a1c, **kw1c, stats=stats_c)), reps=1, warmup=0)
    # the kernel at this plan, held against the plain version exactly
    got_c, (want_c,) = ops.train_epoch_fused(*a1c, **kw1c), plain_c
    what = f"path (C)'s cohort N={n1c} plan {k1c_plan}"
    moved = int((want_c[0] != a1c[0]).sum())
    exact("train_epoch_fused", got_c[0], want_c[0],
          f"{what} TA states ({moved} changed)", err)
    exact("train_epoch_fused", got_c[1], want_c[1], f"{what} weights", err)
    if moved == 0:
        raise SystemExit("train_epoch_fused changed nothing at path (C)'s "
                         "cohort")
    del got_c, want_c, plain_c
    k1c_bytes = (2 * 4 * n1c * C * m * L + 2 * 4 * n1c * C * m
                 + 4 * n1c * S * L + 4 * n1c * S * 2 + 8 * n1c * S * 2 * 3 * 2)
    k1c_ops = (mix["units"] * (stats_c["type1_rows"] * L + n1c * 2 * S * m)
               + (2 * S) * n1c * m * W)
    k1c_bound = max(k1c_bytes / HBM_BYTES_PER_S, k1c_ops / INT32_OPS_PER_S)
    print(f"train_epoch_fused at path (C)'s cohort (N={n1c}, plan "
          f"{k1c_plan}): {k1c_alone:.4f} ms alone, {k1c_ms:.4f} ms by "
          f"events, plain {k1c_plain:.1f} ms; bound "
          f"{k1c_bound * 1e3:.4f} ms ({stats_c['type1_rows']} Type I rows, "
          f"bytes {k1c_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, operations "
          f"{k1c_ops / INT32_OPS_PER_S * 1e3:.4f} ms)", flush=True)
    del a1c, cap1c
    # kernel 1 on path (I)'s last worker epoch: a worker's block of 5
    # clients (1w), and its first 3 clients, the block each rank of path
    # (J2) trains on 10 of 20 clients (1j, held exactly against its plain
    # version first); each bound counted from the epoch's Type I rows
    a1j = tuple(a[:3].contiguous() for a in a1w)
    got = ops.train_epoch_fused(*a1j, **kw1w)
    want = train_epoch.train_epoch_plain(*a1j, **kw1w)
    what = f"a rank's block N=3 plan {train_epoch.plan(*a1j[0].shape)}"
    exact("train_epoch_fused", got[0], want[0], f"{what} TA states", err)
    exact("train_epoch_fused", got[1], want[1], f"{what} weights", err)
    del got, want
    for label, a1x in (("path (I)'s worker block", a1w),
                       ("path (J2)'s rank block", a1j)):
        n1w = a1x[0].shape[0]
        k1w_plan = train_epoch.plan(*a1x[0].shape)
        k1w_alone = device_ms(lambda: ops.train_epoch_fused(*a1x, **kw1w), 5,
                              "train_epoch_kernel")
        k1w_ms = cuda_ms(lambda: ops.train_epoch_fused(*a1x, **kw1w), reps=5)
        stats_w = {}
        k1w_plain = cuda_ms(lambda: train_epoch.train_epoch_plain(
            *a1x, **kw1w, stats=stats_w), reps=1, warmup=0)
        k1w_bytes = (2 * 4 * n1w * C * m * L + 2 * 4 * n1w * C * m
                     + 4 * n1w * S * L + 4 * n1w * S * 2
                     + 8 * n1w * S * 2 * 3 * 2)
        k1w_ops = (mix["units"] * (stats_w["type1_rows"] * L
                                   + n1w * 2 * S * m)
                   + (2 * S) * n1w * m * W)
        k1w_bound = max(k1w_bytes / HBM_BYTES_PER_S,
                        k1w_ops / INT32_OPS_PER_S)
        print(f"train_epoch_fused at {label} (N={n1w}, plan "
              f"{k1w_plan}, {k1w_plan.cluster * n1w} blocks): "
              f"{k1w_alone:.4f} ms alone, {k1w_ms:.4f} ms by events, plain "
              f"{k1w_plain:.1f} ms, library none; bound "
              f"{k1w_bound * 1e3:.4f} ms ({stats_w['type1_rows']} Type I "
              f"rows, bytes {k1w_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
              f"operations {k1w_ops / INT32_OPS_PER_S * 1e3:.4f} ms)",
              flush=True)
    del a1w, a1j, kw1w
    # kernel 1 on the global plan: path (G)'s last epoch (62 classes), and
    # forced on the training path's epoch (C = 10) beside its shared plan
    a1g, kw1g = g["epoch"]
    n1g, c1g = a1g[0].shape[:2]
    k1g_plan = train_epoch.plan(*a1g[0].shape)
    k1g_ms = cuda_ms(lambda: ops.train_epoch_fused(*a1g, **kw1g), reps=5)
    k1g_alone = device_ms(lambda: ops.train_epoch_fused(*a1g, **kw1g), 5,
                          "train_epoch_kernel")
    stats_g = {}
    k1g_plain = cuda_ms(lambda: train_epoch.train_epoch_plain(
        *a1g, **kw1g, stats=stats_g), reps=1, warmup=0)
    sass_g = coin_mix(sass, item, "train_epoch_kernelILb1E")
    k1g_bytes = (2 * 4 * n1g * c1g * m * L + 2 * 4 * n1g * c1g * m
                 + 4 * n1g * S * L + 4 * n1g * S * 2 + 8 * n1g * S * 2 * 3 * 2)
    k1g_ops = (sass_g["units"] * (stats_g["type1_rows"] * L + n1g * 2 * S * m)
               + (2 * S) * n1g * m * W)
    k1g_bound = max(k1g_bytes / HBM_BYTES_PER_S, k1g_ops / INT32_OPS_PER_S)
    print(f"train_epoch_fused (1g) at path (G)'s epoch (N={n1g}, C={c1g}, "
          f"plan {k1g_plan}): {k1g_ms:.4f} ms by events, {k1g_alone:.4f} ms "
          f"alone, plain {k1g_plain:.1f} ms; bound {k1g_bound * 1e3:.4f} ms "
          f"({stats_g['type1_rows']} Type I rows; bytes "
          f"{k1g_bytes / 1e9:.3f} GB, {k1g_bytes / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms; operations {k1g_ops / INT32_OPS_PER_S * 1e3:.4f} ms, "
          f"{sass_g['units']:g} units a coin); launches on path (G) "
          f"{g['launches']['train_epoch_fused']} (global plan "
          f"{g['plans']['global']})", flush=True)
    del a1g
    forced = dict(K1_KW, inc_global=True)
    exact("train_epoch_fused",
          train_epoch.train_epoch_fused(*epoch, **forced)[0],
          ops.train_epoch_fused(*epoch, **K1_KW)[0],
          "the training path's epoch, global plan forced, against the "
          "shared plan", err)
    k1f_plan = train_epoch.plan(N, C, m, L, inc_global=True)
    k1f_ms = cuda_ms(lambda: train_epoch.train_epoch_fused(*epoch, **forced),
                     reps=5)
    k1f_alone = device_ms(lambda: train_epoch.train_epoch_fused(
        *epoch, **forced), 5, "train_epoch_kernel")
    k1_alone_again = device_ms(lambda: ops.train_epoch_fused(
        *epoch, **K1_KW), 5, "train_epoch_kernel")
    print(f"train_epoch_fused (1f) global plan forced at the training "
          f"path's epoch (plan {k1f_plan}): {k1f_ms:.4f} ms by events, "
          f"{k1f_alone:.4f} ms alone, against the shared plan's "
          f"{k1_ms:.4f} ms by events, {k1_alone_again:.4f} ms alone; bound "
          f"{max(k1_bytes / HBM_BYTES_PER_S, k1_ops / INT32_OPS_PER_S) * 1e3:.4f}"
          f" ms, plain {k1_plain:.1f} ms", flush=True)
    # kernel 2 at 62 classes: path (G)'s last confidence / evaluation call
    a2g, kw2g = g["votes"]
    n2g, c2g, m2g, l2g = a2g[0].shape
    k2g_ms = cuda_ms(lambda: ops.fused_votes_batched(*a2g, **kw2g), reps=20)
    k2g_alone = device_ms(lambda: ops.fused_votes_batched(*a2g, **kw2g), 10,
                          "votes_mma_kernel")
    k2g_plain = cuda_ms(lambda: ref.fused_votes_batched_ref(*a2g, **kw2g),
                        reps=5)
    nlit_f = (1 - a2g[1]).to(torch.float32)
    inc_f = a2g[0].reshape(n2g, c2g * m2g, l2g).to(torch.float32
                                                    ).transpose(1, 2)
    k2g_lib = cuda_ms(lambda: torch.bmm(nlit_f, inc_f), reps=20)
    del nlit_f, inc_f
    k2g_bytes, k2g_ops = vote_work(*a2g)
    print(f"fused_votes_batched (2g) at path (G)'s (N, C, m, L, B)="
          f"({n2g}, {c2g}, {m2g}, {l2g}, {a2g[1].shape[1]}): {k2g_ms:.5f} ms "
          f"by events, {k2g_alone:.5f} ms alone, plain {k2g_plain:.4f} ms, "
          f"torch.bmm {k2g_lib:.5f} ms, bound "
          f"{max(k2g_bytes / HBM_BYTES_PER_S, k2g_ops / INT8_OPS_PER_S) * 1e3:.5f}"
          f" ms ({k2g_bytes / 1e6:.3f} MB, {k2g_ops:.3e} operations); "
          f"launches on path (G) {g['launches']['fused_votes_batched']}",
          flush=True)
    del a2g
    print(f"fused_votes_batched bound: {k2_bytes / 1e9:.4f} GB, "
          f"{k2_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {k2_ops:.3e} "
          f"operations, {k2_ops / INT8_OPS_PER_S * 1e3:.4f} ms", flush=True)

    # kernel 3 on path (B)'s last sample step: 20 clients x 3000 clauses
    a3, kw3 = cap3.args
    inc3, lit3 = a3[0], a3[1]
    k3_ms = cuda_ms(lambda: ops.clause_outputs(*a3, **kw3), reps=20)
    k3_plain = cuda_ms(lambda: ref.clause_outputs_ref(*a3, **kw3), reps=5)
    nlit_f = (1 - lit3).to(torch.float32)
    inc_f = inc3.to(torch.float32).transpose(-1, -2)
    k3_lib = cuda_ms(lambda: torch.matmul(nlit_f, inc_f), reps=20)
    del nlit_f, inc_f
    n3, cm3, l3 = inc3.shape
    b3 = lit3.shape[-2]
    k3_bytes = (inc3.numel() * inc3.element_size()
                + lit3.numel() * lit3.element_size() + 4 * n3 * b3 * cm3)
    k3_ops = 2 * n3 * b3 * cm3 * l3
    # kernel 4 on path (A)'s last offline check: one model, B = 1
    a4, kw4 = cap4.args
    inc4, lit4, wpol4 = a4
    k4_ms = cuda_ms(lambda: ops.fused_votes(*a4, **kw4), reps=50)
    k4_plain = cuda_ms(lambda: ref.fused_votes_ref(*a4, **kw4), reps=20)
    c4, m4, l4 = inc4.shape
    nlit_f = (1 - lit4).to(torch.float32)
    inc_f = inc4.reshape(c4 * m4, l4).to(torch.float32).T
    k4_lib = cuda_ms(lambda: torch.matmul(nlit_f, inc_f), reps=50)
    del nlit_f, inc_f
    k4_bytes, k4_ops = vote_work(*a4)
    # kernel 2 at serving's shape: path A's first batch, 32 lanes of B = 1
    a2s, kw2s = cap2.args
    k2s_ms = cuda_ms(lambda: ops.fused_votes_batched(*a2s, **kw2s), reps=20)
    k2s_plain = cuda_ms(lambda: ref.fused_votes_batched_ref(*a2s, **kw2s),
                        reps=5)
    n2s, c2s, m2s, l2s = a2s[0].shape
    nlit_f = (1 - a2s[1]).to(torch.float32)
    inc_f = a2s[0].reshape(n2s, c2s * m2s, l2s).to(torch.float32
                                                    ).transpose(1, 2)
    k2s_lib = cuda_ms(lambda: torch.bmm(nlit_f, inc_f), reps=20)
    del nlit_f, inc_f
    k2s_bytes, k2s_ops = vote_work(*a2s)
    # kernel 4 at B = 40: the same model on its client's 40 test samples
    a4b = (inc4, tm.literals(data.x_test[0]), wpol4)
    k4b_ms = cuda_ms(lambda: ops.fused_votes(*a4b, **kw4), reps=50)
    k4b_plain = cuda_ms(lambda: ref.fused_votes_ref(*a4b, **kw4), reps=20)
    nlit_f = (1 - a4b[1]).to(torch.float32)
    inc_f = inc4.reshape(c4 * m4, l4).to(torch.float32).T
    k4b_lib = cuda_ms(lambda: torch.matmul(nlit_f, inc_f), reps=50)
    del nlit_f, inc_f
    k4b_bytes, k4b_ops = vote_work(*a4b)
    # kernel 5 on path (B)'s last sample step: both roles of 20 clients,
    # in place on a copy of the banks (each call does the same rows)
    a5, kw5 = cap5.args
    ta5 = a5[0].clone()
    n5, c5, m5, l5 = ta5.shape
    k5_ms = cuda_ms(lambda: ops.ta_update_(ta5, *a5[1:], **kw5), reps=20)
    stats5 = {}
    k5_plain = cuda_ms(lambda: ta_update.ta_update_plain(
        ta5, *a5[1:], **kw5, stats=stats5), reps=5)
    k5_plan = ta_update.plan(n5, c5, m5, l5)
    # each listed row read and written once, the literals, the two banks'
    # clause outputs and votes, the classes and the role keys read once;
    # one hash an activation and a coin a literal of every Type I row, at
    # the built kernel's instructions a coin
    rows5 = stats5["type1_rows"] + stats5["type2_rows"]
    k5_bytes = (2 * 4 * rows5 * l5 + 4 * n5 * l5 + 4 * n5 * 2 * (m5 + 1)
                + 4 * n5 * 2 + 8 * n5 * 2 * 3 * 2)
    sass5 = subprocess.run(
        [str(Path(_build.nvcc()).with_name("cuobjdump")), "-sass",
         str(_build.library_path("ta_update"))], capture_output=True,
        text=True, check=True, timeout=120).stdout
    mix5 = coin_mix(sass5, 8, "ta_update_kernelILb1E")
    k5_hashes = stats5["type1_rows"] * l5 + n5 * 2 * m5
    k5_ops = mix5["units"] * k5_hashes
    print("ta_update instructions a coin (cuobjdump -sass): "
          + ", ".join(f"{k} {v:g}" for k, v in mix5.items()), flush=True)
    # the fixed part: the same step with votes at +T on the target and -T
    # on the negative class, where no clause is active and no row listed
    idle5 = list(a5[1:])
    idle5[2] = a5[3].clone()
    n_idx = torch.arange(n5, device=dev)
    idle5[2][n_idx, a5[4][:, 0].long()] = kw5["T"]
    idle5[2][n_idx, a5[4][:, 1].long()] = -kw5["T"]
    k5_idle = device_ms(lambda: ops.ta_update_(ta5, *idle5, **kw5), 20,
                        "ta_update_kernel")
    print(f"ta_update plan at (N, C, m, L)=({n5}, {c5}, {m5}, {l5}): "
          f"{k5_plan}; alone with no row listed (votes at ±T): "
          f"{k5_idle:.4f} ms", flush=True)
    print(f"ta_update bound: {stats5['type1_rows']} Type I and "
          f"{stats5['type2_rows']} fired Type II rows of {n5 * 2 * m5}; "
          f"bytes {k5_bytes / 1e6:.3f} MB, "
          f"{k5_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms; hashing {k5_hashes} "
          f"hashes, {k5_ops:.4e} int32 issue units, "
          f"{k5_ops / INT32_OPS_PER_S * 1e3:.5f} ms", flush=True)
    print(f"clause_outputs bound: {k3_bytes / 1e9:.4f} GB, "
          f"{k3_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {k3_ops:.3e} "
          f"operations, {k3_ops / INT8_OPS_PER_S * 1e3:.4f} ms", flush=True)
    print(f"fused_votes bound: {k4_bytes / 1e6:.3f} MB, "
          f"{k4_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms; {k4_ops:.3e} "
          f"operations, {k4_ops / INT8_OPS_PER_S * 1e3:.5f} ms", flush=True)
    on_device = {
        "fused_votes_batched": device_ms(
            lambda: ops.fused_votes_batched(*votes), 10, "votes_mma_kernel"),
        "train_epoch_fused": device_ms(
            lambda: ops.train_epoch_fused(*epoch, **K1_KW), 5,
            "train_epoch_kernel"),
        "clause_outputs": device_ms(
            lambda: ops.clause_outputs(*a3, **kw3), 20,
            "clause_outputs_kernel"),
        "fused_votes": device_ms(lambda: ops.fused_votes(*a4, **kw4), 20,
                                 "votes_mma_kernel"),
        "ta_update": device_ms(lambda: ops.ta_update_(ta5, *a5[1:], **kw5),
                               20, "ta_update_kernel")}
    print("kernel alone on the device (profiler, ms per call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in on_device.items()),
          flush=True)
    for name, shape, ms, plain, lib, lib_name, nb, no, alone in (
            ("fused_votes_batched", tuple(a2s[0].shape[:1])
             + tuple(a2s[1].shape[1:2]), k2s_ms, k2s_plain, k2s_lib,
             "torch.bmm", k2s_bytes, k2s_ops, device_ms(
                 lambda: ops.fused_votes_batched(*a2s, **kw2s), 20,
                 "votes_mma_kernel")),
            ("fused_votes", (1, a4b[1].shape[0]), k4b_ms, k4b_plain,
             k4b_lib, "torch.matmul", k4b_bytes, k4b_ops, device_ms(
                 lambda: ops.fused_votes(*a4b, **kw4), 20,
                 "votes_mma_kernel"))):
        print(f"{name} at (N, B)={shape}: {ms:.5f} ms by events, "
              f"{alone:.5f} ms alone, plain {plain:.4f} ms, {lib_name} "
              f"{lib:.5f} ms, bound {max(nb / HBM_BYTES_PER_S, no / INT8_OPS_PER_S) * 1e3:.5f} "
              f"ms ({nb / 1e6:.3f} MB, {no:.3e} operations)", flush=True)
    # kernel 2 alone at B = 40 as the grid grows (10 blocks a client,
    # 132 SMs): flat from one wave to two blocks an SM means a block's
    # own chain of steps sets the time, not the card's byte rate
    two = tuple(torch.cat([a, a]) for a in votes)
    sweep = {n: device_ms(lambda n=n: ops.fused_votes_batched(
        *(a[:n] for a in two)), 10, "votes_mma_kernel")
        for n in (7, 13, 20, 26, 33)}
    del two
    print("fused_votes_batched alone at B = 40 by clients (blocks): "
          + ", ".join(f"{n} ({10 * n}) {v:.4f} ms" for n, v in
                      sweep.items()), flush=True)
    print(f"serving: {served['requests_per_s']:.1f} req/s, "
          f"p50={served['p50_s'] * 1e6:.0f}us p99={served['p99_s'] * 1e6:.0f}"
          f"us per batch of 32; unit-weight round {unit_s:.3f}s", flush=True)

    # 11. one more full-width round of the training path and of path (B)
    # under torch.profiler; path (B)'s also without it, by host clock
    del epoch
    profile_round(Engine(strategy, data, RuntimeConfig(rounds=1)), state,
                  rnd.PRNGKey(2, dev), "round")
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng_b.run_round(st_b, rnd.PRNGKey(6, dev))
    torch.cuda.synchronize()
    print(f"path (B) round without the profiler: "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
    profile_round(eng_b, st_b, rnd.PRNGKey(7, dev), "path (B) round")
    eng_c = Engine(fedtm, data_c, RuntimeConfig(
        rounds=1, scheduler=SchedulerConfig(**PATH_C)))
    profile_round(eng_c, st_c, rnd.PRNGKey(8, dev), "path (C) round")
    eng_d = Engine(strategy, data, RuntimeConfig(
        rounds=1, codec=CodecConfig(**PATH_D_WIRE)))
    profile_round(eng_d, st_d, rnd.PRNGKey(9, dev), "path (D) round")
    profile_round(eng_e, st_e, rnd.PRNGKey(10, dev),
                  "path (E) IFCA round")
    profile_round(eng_f, st_f, rnd.PRNGKey(11, dev),
                  "path (F) async round")
    print(f"path (F) launches: {launches_f}", flush=True)
    profile_round(Engine(g["strategy"], g["data"], RuntimeConfig(rounds=1)),
                  g["state"], rnd.PRNGKey(12, dev), "path (G) FEMNIST round")

    kernels = [
        kernel_entry("fused_votes_batched", "clause_eval.cu",
                     "src/repro/kernels/clause_eval.py:185",
                     launches["fused_votes_batched"]
                     + launches_l["fused_votes_batched"], err, k2_ms, k2_plain,
                     k2_lib, k2_bytes, k2_ops, INT8_OPS_PER_S),
        kernel_entry("train_epoch_fused", "train_epoch.cu",
                     "src/repro/kernels/train_epoch.py:115",
                     launches["train_epoch_fused"]
                     + launches_l["train_epoch_fused"], err, k1_ms, k1_plain,
                     None, k1_bytes, k1_ops, INT32_OPS_PER_S),
        kernel_entry("clause_outputs", "clause_eval.cu",
                     "src/repro/kernels/clause_eval.py:77",
                     launches_b["clause_outputs"], err, k3_ms, k3_plain,
                     k3_lib, k3_bytes, k3_ops, INT8_OPS_PER_S),
        kernel_entry("fused_votes", "clause_eval.cu",
                     "src/repro/kernels/clause_eval.py:130",
                     launches_a["fused_votes"], err, k4_ms, k4_plain, k4_lib,
                     k4_bytes, k4_ops, INT8_OPS_PER_S),
        kernel_entry("ta_update", "ta_update.cu",
                     "src/repro/kernels/ta_update.py:48",
                     launches_b["ta_update"], err, k5_ms, k5_plain, None,
                     k5_bytes, k5_ops, INT32_OPS_PER_S),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
