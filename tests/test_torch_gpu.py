"""The CUDA kernels against their plain PyTorch versions, and the
rounds, serving and the MLP baselines against the CPU, on the card.

Every test here needs a CUDA device and skips without one; the file
imports neither jax nor the JAX package, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

The input helpers and the ``one_torch_thread`` fixture are shared with
the other test_torch_* files, which hold the port against the JAX
package on the CPU."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import random as tr
from repro_torch import xla_f32
from repro_torch.core import tm as ttm
from repro_torch.core import clustering
from repro_torch.data import partition, synthetic
from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                    RuntimeConfig, Scheduler,
                                    SchedulerConfig, TPFLStrategy,
                                    build_baseline_strategy)
from repro_torch.kernels import draws, key_chain, ops, ref
from repro_torch.launch import fed_serve, fed_train

VOTE_SHAPES = [  # (N, C, m, L, B): test_kernels.py's, and C·m = 99, L = 130
    (3, 4, 16, 32, 8), (4, 3, 33, 130, 5), (2, 3, 33, 130, 11)]
TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers run side by side: one intra-op thread each keeps
    torch's CPU kernels from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _population(dev, n_clients, n_train, n_test=8, n_conf=8):
    """Pool seed 0 (400 synthmnist samples) split from key 1, both drawn
    on ``dev``."""
    x, y, _ = synthetic.make_dataset("synthmnist", 400, tr.PRNGKey(0, dev),
                                     side=12)
    return partition.partition(x, y, 10, n_clients=n_clients, experiment=5,
                               key=tr.PRNGKey(1, dev), n_train=n_train,
                               n_test=n_test, n_conf=n_conf)


@pytest.mark.gpu
@pytest.mark.parametrize("flavour,n_classes", [("synthmnist", 10),
                                               ("synthfemnist", 62)])
def test_gpu_data_path_matches_cpu(cuda, flavour, n_classes):
    """The pool and the Dirichlet partition (gamma loops, XLA's float32
    functions, the Gumbel row pick), drawn on the card, equal the CPU's
    draw bit for bit."""
    runs = []
    for dev in ("cpu", cuda):
        x, y, _ = synthetic.make_dataset(flavour, 600, tr.PRNGKey(0, dev),
                                         side=12)
        data = partition.partition(x, y, n_classes, n_clients=6,
                                   experiment=3, key=tr.PRNGKey(42, dev),
                                   n_train=16, n_test=8, n_conf=8)
        runs.append(partition.sha256(data))
    assert runs[0] == runs[1]


def _vote_inputs(rng, N, C, m, L, B, banks="mixed", wmax=7):
    """Sparse include planes, random literals and weights in
    [-wmax, wmax].  ``banks``: "mixed" (every fifth clause empty),
    "empty" (every clause) or "full" (none: one literal more per clause)."""
    include = (rng.random((N, C, m, L)) < 2.0 / L).astype(np.int32)
    if banks == "mixed":
        include[:, :, ::5] = 0
    elif banks == "empty":
        include[:] = 0
    else:
        idx = rng.integers(0, L, (N, C, m))
        np.put_along_axis(include, idx[..., None], 1, -1)
    lits = rng.integers(0, 2, (N, B, L)).astype(np.int32)
    wpol = rng.integers(-wmax, wmax + 1, (N, C, m)).astype(np.int32)
    return include, lits, wpol


# (N, C, m, L, B, banks, wmax): B = 1 / 24 / 40 / 130 (two passes of
# samples; B = 24 takes the 4-n-tile instantiation), the ragged L = 130, m = 33 and 300 (not a multiple of the
# 16-clause tile or of the cluster's split), a bank of empty clauses and
# one of none, weights up to 2**15
VOTE_CASES = [
    (3, 4, 33, 130, 1, "mixed", 7),
    (3, 4, 33, 130, 40, "mixed", 7),
    (2, 3, 33, 130, 24, "mixed", 7),
    (2, 3, 33, 130, 130, "mixed", 7),
    (2, 10, 300, 1568, 1, "full", 2 ** 15),
    (2, 10, 300, 1568, 40, "mixed", 2 ** 15),
    (2, 3, 300, 130, 130, "empty", 2 ** 15),
    (2, 3, 300, 256, 40, "full", 2 ** 15),
    (1, 10, 300, 1568, 130, "full", 2 ** 15),
]


def _epoch_inputs(rng, N, S, C, m, o, n_states):
    L = 2 * o
    ta = rng.integers(n_states - 3, n_states + 1, (N, C, m, L))
    inc = rng.random((N, C, m, L)) < 3.0 / L
    ta[inc] = rng.integers(n_states + 1, n_states + 4, int(inc.sum()))
    ta[:, :, 0, :2] = [1, 2 * n_states]           # clamp edges
    w = rng.integers(0, 5, (N, C, m))
    x = (rng.random((N, S, o)) < 0.4).astype(np.int32)
    lits = np.concatenate([x, 1 - x], -1)
    return ta.astype(np.int32), w.astype(np.int32), lits


def _keys(rng, N, S, C):
    """Classes (target, another class) and random role keys (N,S,2,3,2):
    uint32 words in int64, as draws.epoch_keys makes them."""
    target = rng.integers(0, C, (N, S))
    neg = (target + rng.integers(1, C, (N, S))) % C
    cls2 = np.stack([target, neg], -1).astype(np.int32)
    return cls2, rng.integers(0, 1 << 32, (N, S, 2, 3, 2), dtype=np.int64)


def _draws(rng, N, S, C, m, L):
    target = rng.integers(0, C, (N, S))
    neg = (target + rng.integers(1, C, (N, S))) % C
    cls2 = np.stack([target, neg], -1).astype(np.int32)
    u_act = (rng.integers(0, 1 << 23, (N, S, 2, m)) * 2.0 ** -23
             ).astype(np.float32)
    coin = rng.integers(0, 4, (N, S, 2, m, L)).astype(np.int8)
    return cls2, u_act, coin


# p_inc / p_dec whose float32 lies below the float64 value: a uniform equal
# to float32(p) passes a float64 compare but not the reference's float32 one
TA_P = (0.9, 0.7)


def _ta_inputs(rng, NB, m, L, n_states=63, p=TA_P):
    """Banks near the include boundary and at the clamp edges, 0/1 flags,
    and uniforms with every (row, literal) of a third of the rows set to
    exactly float32(p_inc) / float32(p_dec)."""
    ta = rng.integers(n_states - 2, n_states + 3, (NB, m, L))
    ta[:, 0, :2] = [1, 2 * n_states]
    lit = rng.integers(0, 2, (NB, 1, L))
    fired, t1, t2 = (rng.integers(0, 2, (NB, m, 1)) for _ in range(3))
    u = [rng.random((NB, m, L)).astype(np.float32) for _ in range(2)]
    for a, pv in zip(u, p):
        a[:, ::3] = np.float32(pv)
    return [ta.astype(np.int32), lit.astype(np.int32),
            fired.astype(np.int32), t1.astype(np.int32),
            t2.astype(np.int32), *u]


def _step_inputs(rng, N, C, m, L, n_states=63, T=15):
    """One sample step of N clients: banks near the include boundary and
    at the clamp edges, literals, clause outputs, votes in [-T-5, T+5]
    (past the clip both ways), two different classes a client, and the
    keys (N, 2, 2) of the two roles [k_t, k_n] (uint32 words in int64;
    ``random.split(keys, 3)`` gives the role keys)."""
    ta = rng.integers(n_states - 2, n_states + 3, (N, C, m, L))
    ta[:, :, 0, :2] = [1, 2 * n_states]
    lits = rng.integers(0, 2, (N, L))
    fired = rng.integers(0, 2, (N, C, m))
    votes = rng.integers(-T - 5, T + 6, (N, C))
    target = rng.integers(0, C, N)
    cls2 = np.stack([target, (target + rng.integers(1, C, N)) % C], -1)
    keys = rng.integers(0, 1 << 32, (N, 2, 2), dtype=np.int64)
    return (ta.astype(np.int32), lits.astype(np.int32),
            fired.astype(np.int32), votes.astype(np.int32),
            cls2.astype(np.int32), keys)


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VOTE_SHAPES + [(20, 10, 300, 1568, 40)])
@pytest.mark.parametrize("predict", [True, False])
def test_fused_votes_kernel_matches_plain_on_gpu(cuda, shape, predict):
    include, lits, wpol = _vote_inputs(np.random.default_rng(3), *shape)
    args = _t(include.astype(bool), lits, wpol, device=cuda)
    n = ops.LAUNCHES["fused_votes_batched"]
    got = ops.fused_votes_batched(*args, predict)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_votes_batched"] == n + 1
    want = ref.fused_votes_batched_ref(*args, predict)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S,C,m,L", [
    (3, 17, 3, 33, 130), (1, 40, 10, 300, 1568), (20, 8, 10, 300, 1568),
    (33, 8, 10, 300, 1568)])
def test_train_epoch_kernel_matches_plain_on_gpu(cuda, N, S, C, m, L):
    """The keyed kernel equals its plain version (the role keys' coin plane
    and train_epoch_ref) bit for bit, in one launch: unaligned, one client
    (the widest cluster), the round's 20 clients and 33 (past one block an
    SM)."""
    from repro_torch.kernels import train_epoch
    rng = np.random.default_rng(4)
    ta, w, lits = _epoch_inputs(rng, N, S, C, m, L // 2, 63)
    args = _t(ta, w, lits, *_keys(rng, N, S, C), device=cuda)
    kw = dict(n_states=63, T=15, p_inc=0.8, p_dec=0.2)
    n = ops.LAUNCHES["train_epoch_fused"]
    got = ops.train_epoch_fused(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["train_epoch_fused"] == n + 1
    want = train_epoch.train_epoch_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(want[0], args[0])
    assert torch.equal(args[0].cpu(), torch.as_tensor(ta))   # input intact


@pytest.mark.gpu
@pytest.mark.parametrize("N,S,C,m,L,forced", [
    (3, 17, 3, 33, 130, True), (20, 8, 10, 300, 1568, True),
    (4, 6, 62, 300, 1568, False), (20, 4, 62, 300, 1568, False)])
def test_train_epoch_global_plan_matches_plain_on_gpu(cuda, N, S, C, m, L,
                                                      forced):
    """The global plan (include bits in device memory) equals the plain
    version bit for bit: forced at shapes the shared plan holds, and at
    62 classes of 300 clauses (L = 1568), which only it holds; every
    shape the shared plan holds keeps it."""
    from repro_torch.kernels import train_epoch
    assert train_epoch.plan(N, C, m, L, inc_global=forced).inc_global == 1
    assert train_epoch.plan(N, C, m, L).inc_global == int(not forced)
    rng = np.random.default_rng(5)
    ta, w, lits = _epoch_inputs(rng, N, S, C, m, L // 2, 63)
    args = _t(ta, w, lits, *_keys(rng, N, S, C), device=cuda)
    kw = dict(n_states=63, T=15, p_inc=0.8, p_dec=0.2)
    n = dict(train_epoch.PLAN_LAUNCHES)
    got = train_epoch.train_epoch_fused(*args, **kw, inc_global=forced)
    torch.cuda.synchronize()
    assert train_epoch.PLAN_LAUNCHES["global"] == n["global"] + 1
    assert train_epoch.PLAN_LAUNCHES["shared"] == n["shared"]
    want = train_epoch.train_epoch_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(want[0], args[0])


@pytest.mark.gpu
def test_train_epoch_allocates_no_coin_plane(cuda):
    """An epoch of 20 clients x 80 samples at the paper's width through
    the main path's tm._epoch: one launch, and its peak device memory
    above what was allocated before stays below the (N,S,2,m,L) int8 coin
    plane's 1.5 GB."""
    N, S, C, m, o = 20, 80, 10, 300, 784
    cfg = ttm.TMConfig(n_classes=C, n_clauses=m, n_features=o, n_states=63,
                       s=5.0, T=40)
    rng = np.random.default_rng(8)
    ta, w, _ = _epoch_inputs(rng, N, 1, C, m, o, 63)
    ta, w = _t(ta, w, device=cuda)
    xs = torch.as_tensor(rng.random((N, S, o)) < 0.4, device=cuda)
    ys = torch.as_tensor(rng.integers(0, C, (N, S)), device=cuda)
    keys = tr.split(tr.PRNGKey(3, cuda), N)
    ttm._epoch(ta, w, xs, ys, keys, cfg)           # build and warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n = ops.LAUNCHES["train_epoch_fused"]
    out = ttm._epoch(ta, w, xs, ys, keys, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["train_epoch_fused"] == n + 1
    plane = N * S * 2 * m * 2 * o
    assert torch.cuda.max_memory_allocated() - base < plane
    assert not torch.equal(out[0], ta)


@pytest.mark.gpu
def test_epoch_draws_same_on_gpu_and_cpu(cuda):
    keys = tr.split(tr.PRNGKey(9, "cpu"), 3)
    a = draws.epoch_draws(keys, 6, 33, 130, 10, 0.8, 0.2)
    b = draws.epoch_draws(keys.to(cuda), 6, 33, 130, 10, 0.8, 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())


# (S, C) of the benchmark's cells: silo20, cohort20of150, cohort100of1000
KEY_CHAIN_SHAPES = [(2400, 10), (180, 62), (80, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 20, 100])
@pytest.mark.parametrize("S,C", KEY_CHAIN_SHAPES)
def test_key_chain_kernel_matches_plain_on_gpu(cuda, N, S, C):
    """One launch gives the epoch's class pairs and role keys of the CPU
    plain chain bit for bit: from the clients' keys at epochs 0 and 1, and
    from the epoch keys themselves."""
    rng = np.random.default_rng([N, S, C])
    keys = tr.split(tr.PRNGKey(S * C + N, "cpu"), N)
    ys = torch.as_tensor(rng.integers(0, C, (N, S)).astype(np.int32))
    for epoch in (0, 1, None):
        want = key_chain.key_chain_plain(keys, ys, C, epoch)
        n = ops.LAUNCHES["key_chain"]
        got = ops.key_chain(keys.to(cuda), ys.to(cuda), C, epoch)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["key_chain"] == n + 1
        assert got[0].shape == (N, S, 2) and got[1].shape == (N, S, 2, 3, 2)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_key_chain_kernel_reads_labels_and_keys_as_held(cuda):
    """int64 labels, labels and keys at other strides are read where they
    lie: the same chain, from one device kernel a call and nothing
    else."""
    keys = tr.split(tr.PRNGKey(4, cuda), 6)
    ys = torch.randint(0, 10, (6, 50), device=cuda)                # int64
    want = key_chain.key_chain_plain(keys.cpu(), ys.cpu(), 10, 1)
    spaced = torch.stack([keys[:, 0], keys[:, 0], keys[:, 1], keys[:, 1]],
                         -1)[:, ::2]                           # strides (4, 2)
    by_column = ys.to(torch.int32).t().contiguous().t()        # strides (1, 6)
    for k, y in ((keys, ys), (keys, by_column), (spaced, ys)):
        got = ops.key_chain(k, y, 10, 1)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    names = _device_ops_per_call(lambda: ops.key_chain(spaced, by_column, 10,
                                                       1))
    assert len(names) == 1 and "key_chain_kernel" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
def test_gpu_train_batched_one_key_chain_launch_an_epoch(cuda, weighted):
    """train_batched on the card launches the key chain once an epoch, on
    the clients' keys (no split of its own), and its two epochs equal the
    CPU's bit for bit, where nothing is launched."""
    cfg = ttm.TMConfig(**TM, weighted=weighted)
    N, S = 4, 12
    rng = np.random.default_rng(12)
    xs = (rng.random((N, S, cfg.n_features)) < 0.4).astype(np.int32)
    ys = rng.integers(0, cfg.n_classes, (N, S)).astype(np.int32)
    runs = []
    for dev in ("cpu", cuda):
        params = ttm.init_params(cfg, tr.split(tr.PRNGKey(2, dev), N))
        keys = tr.split(tr.PRNGKey(3, dev), N)
        n = ops.LAUNCHES["key_chain"]
        out = ttm.train_batched(params, *_t(xs, ys, device=dev), keys, cfg,
                                epochs=2)
        runs.append((out, ops.LAUNCHES["key_chain"] - n))
    (a, n_cpu), (b, n_gpu) = runs
    assert (n_cpu, n_gpu) == (0, 2)
    assert torch.equal(a.ta_state, b.ta_state.cpu())
    assert torch.equal(a.weights, b.weights.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [-1, 10, 2 ** 31 - 1])
def test_train_epoch_fused_refuses_labels_outside_classes(cuda, bad):
    """A label outside [0, C) reaches train_epoch_fused's class-id check
    through the key chain's class pairs: ValueError, no epoch launched."""
    cfg = ttm.TMConfig(**TM)
    N, S = 3, 8
    params = ttm.init_params(cfg, tr.split(tr.PRNGKey(2, cuda), N))
    xs = torch.zeros((N, S, cfg.n_features), dtype=torch.int32, device=cuda)
    ys = torch.zeros((N, S), dtype=torch.int32, device=cuda)
    ys[1, 5] = bad
    n = ops.LAUNCHES["train_epoch_fused"]
    with pytest.raises(ValueError, match="class ids outside"):
        ttm.train_batched(params, xs, ys, tr.split(tr.PRNGKey(3, cuda), N),
                          cfg, epochs=2)
    assert ops.LAUNCHES["train_epoch_fused"] == n


@pytest.mark.gpu
@pytest.mark.parametrize("strategy_kw", [
    {}, dict(top_classes=2, conf_threshold=2.0, weighted_confidence=True)])
def test_gpu_round_matches_cpu_round(cuda, strategy_kw):
    """The kernel path on the card equals the plain path on the CPU, for
    Alg. 1 as written and for the §7 multi-cluster, thresholded and
    weighted-confidence variant."""
    runs = []
    for dev in ("cpu", "cuda"):
        data = _population(dev, 4, n_train=16)
        eng = Engine(TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2,
                                  **strategy_kw),
                     data, RuntimeConfig(rounds=2))
        runs.append(eng.run(tr.PRNGKey(5, "cpu")))
    (s0, r0), (s1, r1) = runs
    for a, b in zip(convert.to_numpy([*s0.client_state, s0.server.slots]),
                    convert.to_numpy([*s1.client_state, s1.server.slots])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r0, r1):
        for f in ("per_client_accuracy", "assignment", "cluster_counts"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        assert a.upload_bytes == b.upload_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VOTE_SHAPES + [(20, 10, 300, 1568, 1)])
@pytest.mark.parametrize("predict", [True, False])
def test_clause_outputs_kernel_matches_plain_on_gpu(cuda, shape, predict):
    N, C, m, L, B = shape
    include, lits, _ = _vote_inputs(np.random.default_rng(6), *shape)
    inc, lit = _t(include.reshape(N, C * m, L).astype(bool), lits,
                  device=cuda)
    n = ops.LAUNCHES["clause_outputs"]
    got = ops.clause_outputs(inc, lit, predict)
    one = ops.clause_outputs(inc[0], lit[0], predict)     # no batch axis
    torch.cuda.synchronize()
    assert ops.LAUNCHES["clause_outputs"] == n + 2
    want = ref.clause_outputs_ref(inc, lit, predict)
    assert torch.equal(got, want) and torch.equal(one, want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VOTE_SHAPES + [(1, 10, 300, 1568, 1),
                                                 (1, 10, 300, 1568, 40)])
@pytest.mark.parametrize("predict", [True, False])
def test_single_model_fused_votes_kernel_matches_plain_on_gpu(cuda, shape,
                                                              predict):
    include, lits, wpol = _vote_inputs(np.random.default_rng(7), *shape)
    args = _t(include[0].astype(bool), lits[0], wpol[0], device=cuda)
    n = ops.LAUNCHES["fused_votes"]
    got = ops.fused_votes(*args, predict)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_votes"] == n + 1
    assert torch.equal(got, ref.fused_votes_ref(*args, predict))


def _device_ops_per_call(fn, calls: int = 3) -> list[str]:
    """The names of the device operations (kernels, memsets, copies) that
    ``calls`` calls of ``fn()`` ran, from a torch.profiler trace, with
    each name once per call it ran in.  A trace that recorded no device
    operation at all (the profiler missed its short window) is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops_ = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type != DeviceType.CPU]
        if ops_:
            break
    return [k for k, n in ops_ for _ in range(n // calls)
            if n % calls == 0] + [f"{k} x{n}" for k, n in ops_
                                  if n % calls]


@pytest.mark.gpu
@pytest.mark.parametrize("case", VOTE_CASES)
@pytest.mark.parametrize("predict", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_vote_kernels_one_launch_and_exact(cuda, case, predict, batched):
    """Both vote wrappers at the main path's dtypes (bool include, int32
    lits and wpol): equal to the plain version, one count and one device
    kernel (no memset, no conversion pass) per call."""
    *shape, banks, wmax = case
    include, lits, wpol = _vote_inputs(np.random.default_rng(10), *shape,
                                       banks=banks, wmax=wmax)
    args = _t(include.astype(bool), lits, wpol, device=cuda)
    if batched:
        name, plain = "fused_votes_batched", ref.fused_votes_batched_ref
    else:
        name, plain = "fused_votes", ref.fused_votes_ref
        args = [a[0] for a in args]
    fn = getattr(ops, name)
    n = ops.LAUNCHES[name]
    got = fn(*args, predict)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n + 1
    assert torch.equal(got, plain(*args, predict))
    names = _device_ops_per_call(lambda: fn(*args, predict))
    assert len(names) == 1 and "votes_mma_kernel" in names[0], names


@pytest.mark.gpu
def test_vote_kernels_take_other_dtypes_and_strides(cuda):
    """Other dtypes are converted and an expanded wpol (unit weights) is
    read at its strides; the result does not change."""
    include, lits, wpol = _vote_inputs(np.random.default_rng(11), 3, 4, 33,
                                       130, 9)
    inc, lit, wp = _t(include.astype(bool), lits, wpol, device=cuda)
    unit = torch.where(torch.arange(33, device=cuda) % 2 == 0, 1, -1
                       ).to(torch.int32).expand(3, 4, 33)
    strided = torch.cat([inc, inc], -1)[..., :130]        # not contiguous
    for args in ((inc.to(torch.int64), lit.to(torch.uint8),
                  wp.to(torch.int16)),
                 (inc, lit, unit), (strided, lit.to(torch.int64), unit)):
        want = ref.fused_votes_batched_ref(*args)
        assert torch.equal(ops.fused_votes_batched(*args), want)
        assert torch.equal(ops.fused_votes(*(a[1] for a in args)), want[1])
    assert _device_ops_per_call(
        lambda: ops.fused_votes_batched(inc, lit, unit)) \
        == _device_ops_per_call(lambda: ops.fused_votes_batched(inc, lit, wp))


@pytest.mark.gpu
@pytest.mark.parametrize("N,m,L", [(1, 16, 128), (3, 33, 130),
                                   (20, 300, 1568)])
def test_ta_update_kernel_matches_plain_on_gpu(cuda, N, m, L):
    """The keyed kernel equals its plain version (the role keys' uniform
    planes and ta_update_ref, target then negative bank) bit for bit, in
    place and in one launch; a second step on the same banks composes (an
    L that is not a multiple of 4 takes the 32-bit row accesses)."""
    from repro_torch.kernels import ta_update
    C = 10 if L == 1568 else 4
    rng = np.random.default_rng(8)
    kw = dict(T=15, p_inc=TA_P[0], p_dec=TA_P[1], n_states=63)
    ta, *step, keys = _step_inputs(rng, N, C, m, L)
    got = torch.as_tensor(ta, device=cuda)
    want = got.clone()
    for _ in range(2):
        args = _t(*step, device=cuda) + [tr.split(torch.as_tensor(
            keys, device=cuda), 3)]
        n = ops.LAUNCHES["ta_update"]
        assert ops.ta_update_(got, *args, **kw) is got
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ta_update"] == n + 1
        before = want.clone()
        ta_update.ta_update_plain(want, *args, **kw)
        assert torch.equal(got, want) and not torch.equal(want, before)
        *step, keys = _step_inputs(rng, N, C, m, L)[1:]
    assert ta_update.plan(N, C, m, L).grid >= 1


@pytest.mark.gpu
def test_ta_update_kernel_refuses_equal_classes(cuda):
    ta, *step, keys = _step_inputs(np.random.default_rng(9), 3, 4, 16, 128)
    step[3][2, 1] = step[3][2, 0]
    args = _t(ta, *step, device=cuda)
    n = ops.LAUNCHES["ta_update"]
    with pytest.raises(ValueError, match="same class for both roles of "
                                         "client 2"):
        ops.ta_update_(*args, tr.split(torch.as_tensor(keys, device=cuda),
                                       3), T=15, p_inc=0.9, p_dec=0.1,
                       n_states=63)
    assert ops.LAUNCHES["ta_update"] == n
    assert torch.equal(args[0].cpu(), torch.as_tensor(ta))


@pytest.mark.gpu
def test_gpu_unweighted_round_matches_cpu_round(cuda):
    """weighted=False trains through the per-sample scan: on the card it
    launches clause_outputs once and ta_update once per sample step."""
    runs = []
    for dev in ("cpu", "cuda"):
        data = _population(dev, 4, n_train=6)
        eng = Engine(TPFLStrategy(ttm.TMConfig(**TM, weighted=False),
                                  local_epochs=2),
                     data, RuntimeConfig(rounds=2))
        before = dict(ops.LAUNCHES)
        runs.append(eng.run(tr.PRNGKey(5, "cpu")))
        launched = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
    assert launched["clause_outputs"] == 2 * 2 * 6
    assert launched["ta_update"] == 2 * 2 * 6
    (s0, r0), (s1, r1) = runs
    for a, b in zip(convert.to_numpy([*s0.client_state, s0.server.slots]),
                    convert.to_numpy([*s1.client_state, s1.server.slots])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r0, r1):
        assert torch.equal(a.per_client_accuracy,
                           b.per_client_accuracy.cpu())


@pytest.mark.gpu
def test_gpu_unweighted_round_draws_no_plane(cuda, monkeypatch):
    """On the card the unit-weight round draws no (m, L) uniform plane:
    with repro_torch.random's uniform and mantissa_bits refusing any draw
    of more than m values a key, a round still runs, through one
    ta_update launch a sample step."""
    data = _population(cuda, 4, n_train=6)
    cfg = ttm.TMConfig(**TM, weighted=False)
    eng = Engine(TPFLStrategy(cfg, local_epochs=1), data,
                 RuntimeConfig(rounds=1))
    state = eng.init(tr.PRNGKey(5, cuda))

    def small_only(fn):
        def draw(key, shape=()):
            if int(np.prod(shape)) > cfg.n_clauses:
                raise AssertionError(f"a plane of {tuple(shape)} was drawn")
            return fn(key, shape)
        return draw

    for name in ("uniform", "mantissa_bits"):
        monkeypatch.setattr(tr, name, small_only(getattr(tr, name)))
    n = ops.LAUNCHES["ta_update"]
    _, rep = eng.run_round(state, tr.PRNGKey(6, cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ta_update"] == n + 6
    assert bool(((rep.per_client_accuracy >= 0)
                 & (rep.per_client_accuracy <= 1)).all())


@pytest.mark.gpu
def test_gpu_serve_matches_cpu_serve(cuda, tmp_path):
    """A CPU-trained checkpoint served on the card: the same predictions
    as on the CPU, and fed_serve's offline check passes there with one
    single-model fused-votes launch per client."""
    from repro_torch.fl.serve import ModelRegistry, ServingPlane
    from repro_torch.launch import fed_serve, fed_train
    flags = ["--clients", "4", "--clauses", "8", "--local-epochs", "1"]
    fed_train.main(flags + ["--device", "cpu", "--rounds", "2",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every",
                            "1"])
    preds = []
    for dev in ("cpu", "cuda"):
        data, _, _, strategy = fed_train.build_scenario(
            dataset="synthmnist", clients=4, clauses=8, local_epochs=1,
            device=dev)
        eng = Engine(strategy, data, RuntimeConfig())
        reg = ModelRegistry(tmp_path / f"reg_{dev}")
        reg.publish(tmp_path / "round_000002.msgpack")
        plane = ServingPlane(strategy, reg,
                             eng.init(tr.split(tr.PRNGKey(0, dev))[0]))
        plane.refresh()
        ids = np.array([0, 1, 2, 3, 3, 2, 1, 0])
        x = torch.cat([data.x_test[:, 0], data.x_test[:, 1]])
        preds.append(plane.predict(ids, x))
    np.testing.assert_array_equal(*preds)
    before = dict(ops.LAUNCHES)
    out = fed_serve.main(flags + ["--ckpt-dir", str(tmp_path), "--batch",
                                  "8", "--requests", "3",
                                  "--verify-offline"])
    assert out["mismatches"] == 0
    assert ops.LAUNCHES["fused_votes"] - before["fused_votes"] == 4
    assert ops.LAUNCHES["fused_votes_batched"] \
        - before["fused_votes_batched"] == 3 + 1


@pytest.mark.gpu
def test_xla_log_same_on_gpu_and_cpu(cuda):
    """XLA:CPU's float32 log, emulated in torch ops, gives the same bits
    on the card as on the CPU (the FMAs run in float64 there too)."""
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(np.log(1e-38), np.log(3e38), 2_000_000)
               ).astype(np.float32)
    x[:9] = [0.0, -0.0, 1e-40, -1e-40, -1.0, np.inf, np.nan,
             np.finfo(np.float32).tiny, 1.0]
    a = xla_f32.log(torch.from_numpy(x))
    b = xla_f32.log(torch.from_numpy(x).to(cuda)).cpu()
    assert torch.equal(a.isnan(), b.isnan())
    ok = ~a.isnan()
    assert torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["exp", "log1p", "sqrt", "rsqrt",
                                  "erf_inv", "reduce_sum"])
def test_xla_functions_same_on_gpu_and_cpu(cuda, name):
    """The data path's other XLA:CPU float32 functions give the same bits
    on the card as on the CPU."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1_000_000)
         * np.exp(rng.uniform(-10, 5, 1_000_000))).astype(np.float32)
    if name == "erf_inv":
        x = np.tanh(x).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-40, -1e-40, np.inf, np.nan, 1.0, -1.0]
    x = torch.from_numpy(x).reshape(-1, 40 if name == "reduce_sum" else 1)
    fn = getattr(xla_f32, name)
    a, b = fn(x), fn(x.to(cuda)).cpu()
    assert torch.equal(a.isnan(), b.isnan())
    ok = ~a.isnan()
    assert torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(participation=0.5, dropout=0.2, straggler=0.3),
    dict(participation=0.5, sampling="weighted", dropout=0.2),
    dict(participation=1.0, sampling="weighted"),
    dict(participation=0.35, sampling="round_robin", straggler=0.3)])
def test_scheduler_same_on_gpu_and_cpu(cuda, kw):
    sizes = torch.as_tensor(np.random.default_rng(1).integers(1, 900, 20),
                            dtype=torch.int32)
    cfg = SchedulerConfig(**kw)
    on_cpu = Scheduler(cfg, 20, sizes)
    on_gpu = Scheduler(cfg, 20, sizes.to(cuda))
    for r in range(50):
        key = tr.fold_in(tr.PRNGKey(7, "cpu"), r)
        a = on_cpu.sample(r, key)
        # the draw itself on the card, and the host's draw moved there
        for b in (on_gpu.draw(r, key.to(cuda)),
                  on_gpu.sample(r, key.to(cuda))):
            for f in ("idx", "active", "staleness"):
                assert getattr(b, f).is_cuda, (r, f)
                assert torch.equal(getattr(a, f), getattr(b, f).cpu()), (r, f)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", [{}, dict(name="int8", sparse=True)],
                         ids=["float32", "int8_sparse"])
def test_gpu_mmap_round_matches_resident_and_cpu(cuda, tmp_path, wire):
    """A small TPFL federation over the mmap client store (3 of 6 clients
    a round with drops, chunked population eval) on the card equals the
    resident federation on the card and the same mmap federation on the
    CPU, bit for bit: reports, server rows and the population read back
    from the store (whose files are the CPU store's bytes); the gathered
    rows land on the card."""
    sched = SchedulerConfig(participation=0.5, dropout=0.3)
    runs = {}
    for tag, dev, store in (("cpu", "cpu", "mmap"), ("gpu", "cuda", "mmap"),
                            ("resident", "cuda", "resident")):
        data = _population(dev, 6, n_train=16)
        eng = Engine(TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2), data,
                     RuntimeConfig(rounds=2, scheduler=sched,
                                   codec=CodecConfig(**wire),
                                   client_store=store, store_eval_chunk=4,
                                   store_dir=str(tmp_path / tag)))
        seen = []
        train = eng.executor.train

        def spy(strategy, sub_cs, *a, **kw):
            seen.append(sub_cs.ta_state.device)
            return train(strategy, sub_cs, *a, **kw)

        eng.executor.train = spy
        state, reps = eng.run(tr.PRNGKey(3, "cpu"))
        assert {d.type for d in seen} == {torch.device(dev).type}
        runs[tag] = (eng, state, reps)
    geng, gstate, greps = runs["gpu"]
    rows = convert.tm_params_from_numpy(
        *geng.store.gather(np.arange(6))["cs"], device=cuda)
    for other in ("cpu", "resident"):
        _, state, reps = runs[other]
        for a, b in zip(reps, greps):
            # the float32 mean's sum order is the device's own
            for f in ("per_client_accuracy", "assignment", "cluster_counts",
                      *(("mean_accuracy",) if other == "resident" else ())):
                assert torch.equal(getattr(a, f).cpu(),
                                   getattr(b, f).cpu()), (other, f)
            assert (a.upload_bytes, a.download_bytes_per_client) == \
                (b.upload_bytes, b.download_bytes_per_client)
        assert torch.equal(state.server.slots.cpu(), gstate.server.slots.cpu())
    for a, b in zip(runs["resident"][1].client_state, rows):
        assert torch.equal(a, b)
    assert [r.store_written_bytes for r in greps] == \
        [r.store_written_bytes for r in runs["cpu"][2]] == \
        [3 * (geng.store.row_nbytes + 33)] * 2
    runs["cpu"][0].store.flush()
    geng.store.flush()
    for p in sorted((tmp_path / "cpu").iterdir()):
        assert (tmp_path / "gpu" / p.name).read_bytes() == p.read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,sched", [
    ("tpfl", dict(participation=0.5, dropout=0.3, straggler=0.3)),
    ("fedtm", dict(participation=0.5, sampling="weighted", dropout=0.3))])
def test_gpu_partial_round_matches_cpu_round(cuda, strategy, sched):
    """Half the clients a round, with drops and stragglers: the cohort's
    fused epochs (one launch per local epoch) and the population's
    evaluation (one fused-votes launch; TPFL adds its confidence pass)
    on the card equal the plain path on the CPU."""
    runs = []
    for dev in ("cpu", "cuda"):
        data = _population(dev, 6, n_train=16)
        cls = FedTMStrategy if strategy == "fedtm" else TPFLStrategy
        eng = Engine(cls(ttm.TMConfig(**TM), local_epochs=2), data,
                     RuntimeConfig(rounds=2,
                                   scheduler=SchedulerConfig(**sched)))
        before = dict(ops.LAUNCHES)
        runs.append(eng.run(tr.PRNGKey(3, "cpu")))
        launched = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
    assert launched["train_epoch_fused"] == 2 * 2
    assert launched["fused_votes_batched"] == 2 * (
        1 if strategy == "fedtm" else 2)
    (s0, r0), (s1, r1) = runs
    for a, b in zip(convert.to_numpy([*s0.client_state, s0.server.slots]),
                    convert.to_numpy([*s1.client_state, s1.server.slots])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r0, r1):
        for f in ("per_client_accuracy", "assignment", "cluster_counts"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        for f in ("idx", "active", "staleness"):
            assert torch.equal(getattr(a.participation, f),
                               getattr(b.participation, f).cpu()), f
        assert (a.upload_bytes, a.aggregated_uploads) == (
            b.upload_bytes, b.aggregated_uploads)


LOSSY = {  # the chip smoke's small lossy federations
    "tpfl_int8_sparse_ef": ("tpfl", dict(name="int8", sparse=True,
                                         error_feedback=True), {}),
    "tpfl_int4_vrle": ("tpfl", dict(name="int4", sparse=True,
                                    index_coding="vrle"), {}),
    "fedtm_int4_ef_partial": ("fedtm", dict(name="int4",
                                            error_feedback=True),
                              dict(participation=0.5, dropout=0.2,
                                   straggler=0.3)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", LOSSY)
def test_gpu_lossy_round_matches_cpu_round(cuda, case):
    """Two rounds on a lossy wire: the codec runs on the host, the
    aggregate of non-integer uploads sums in row order on the card, and
    the round (client state, server rows, the reference and residual
    lanes, every report field) equals the CPU's bit for bit."""
    strategy, wire, sched = LOSSY[case]
    runs = []
    for dev in ("cpu", "cuda"):
        data = _population(dev, 6, n_train=16)
        cls = FedTMStrategy if strategy == "fedtm" else TPFLStrategy
        eng = Engine(cls(ttm.TMConfig(**TM), local_epochs=2), data,
                     RuntimeConfig(rounds=2, codec=CodecConfig(**wire),
                                   scheduler=SchedulerConfig(**sched)))
        runs.append(eng.run(tr.PRNGKey(3, "cpu")))
    (s0, r0), (s1, r1) = runs
    assert s1.server.slots.is_cuda and s1.ef_residual.is_cuda
    lanes = [(*s.client_state, s.server.slots, s.ref_vecs, s.ref_round,
              s.ef_residual) for s in (s0, s1)]
    for a, b in zip(*convert.to_numpy(lanes)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r0, r1):
        for f in ("per_client_accuracy", "assignment", "cluster_counts"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        assert (a.upload_bytes, a.download_bytes_broadcast,
                a.download_bytes_per_client, a.aggregated_uploads) == (
            b.upload_bytes, b.download_bytes_broadcast,
            b.download_bytes_per_client, b.aggregated_uploads)


@pytest.mark.gpu
@pytest.mark.parametrize("n_clusters,m", [(10, 300), (1, 3000)])
def test_aggregate_deterministic_on_gpu(cuda, n_clusters, m):
    """Non-integer uploads (decoded int8 rows, 20 of them): three runs on
    the card give the same bits, and the CPU's."""
    rng = np.random.default_rng(0)
    up = (rng.integers(-127, 128, (20, m)).astype(np.float32)
          * np.float32(0.37)).astype(np.float32)
    ids = torch.as_tensor(rng.integers(-1, n_clusters, 20).astype(np.int32))
    want = clustering.aggregate(torch.as_tensor(up), ids, n_clusters)
    for _ in range(3):
        got = clustering.aggregate(torch.as_tensor(up, device=cuda),
                                   ids.to(cuda), n_clusters)
        assert torch.equal(got.cluster_weights.cpu(), want.cluster_weights)
        assert torch.equal(got.counts.cpu(), want.counts)


# -- the DL baselines (MLP) -------------------------------------------------

BASELINE_KW = dict(n_features=144, n_classes=10, n_hidden=16,
                   local_epochs=2, batch=8, ifca_k=3, max_slots=4,
                   probe_size=16)
# the MLP is float math: cuBLAS and the CPU add in other orders
BASELINE_TOL = dict(atol=1e-5, rtol=1e-4)


def _baseline_run(name, dev, sched=None):
    data = _population(dev, 6, n_train=16)
    eng = Engine(build_baseline_strategy(name, **BASELINE_KW), data,
                 RuntimeConfig(rounds=2, scheduler=SchedulerConfig(
                     **(sched or {}))))
    return eng.run(tr.PRNGKey(3, "cpu"))


def _mlp_leaves(state):
    cs = getattr(state.client_state, "params", state.client_state)
    return [state.server.slots, *(cs[k] for k in sorted(cs))]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fedavg", "fedprox", "ifca", "flis_dc",
                                  "flis_hc"])
def test_gpu_baseline_round_matches_cpu_round(cuda, name):
    """Two rounds of each baseline at half participation with drops: on
    the card the assignments, counts, participation and bytes equal the
    CPU's, every float of the state within BASELINE_TOL, and no TM
    kernel launches."""
    before = dict(ops.LAUNCHES)
    runs = [_baseline_run(name, dev, dict(participation=0.5, dropout=0.3))
            for dev in ("cpu", "cuda")]
    assert ops.LAUNCHES == before
    (s0, r0), (s1, r1) = runs
    assert s1.server.slots.is_cuda
    for a, b in zip(convert.to_numpy(_mlp_leaves(s0)),
                    convert.to_numpy(_mlp_leaves(s1))):
        np.testing.assert_allclose(b, a, **BASELINE_TOL)
    for a, b in zip(r0, r1):
        for f in ("assignment", "cluster_counts"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        for f in ("idx", "active", "staleness"):
            assert torch.equal(getattr(a.participation, f),
                               getattr(b.participation, f).cpu()), f
        assert (a.upload_bytes, a.download_bytes_broadcast,
                a.download_bytes_per_client, a.aggregated_uploads) == (
            b.upload_bytes, b.download_bytes_broadcast,
            b.download_bytes_per_client, b.aggregated_uploads)


@pytest.mark.gpu
def test_gpu_baseline_products_run_at_full_fp32(cuda):
    """With the process's float32 matmul precision at "high" (TF32
    allowed), every product an MLP run dispatches, forward and backward
    (watched below autograd, so the Gram product and the gradients'
    products too), still runs at "highest", and the caller's setting
    comes back after the run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen, products = set(), []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv",
                        "addmv", "dot"):
                products.append(name)
                seen.add(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with Watch():
            for name in ("ifca", "flis_hc"):
                _baseline_run(name, "cuda")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert products and seen == {"highest"}


@pytest.mark.gpu
def test_gpu_baseline_served_equals_offline(cuda, tmp_path):
    """A FLIS-HC run's checkpoint served on the card: every client's
    served prediction equals its row's offline prediction."""
    flags = ["--clients", "4", "--local-epochs", "1", "--strategy",
             "flis_hc", "--max-slots", "3", "--device", "cuda"]
    fed_train.main(flags + ["--rounds", "2", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    out = fed_serve.main(flags + ["--ckpt-dir", str(tmp_path), "--batch",
                                  "8", "--requests", "2",
                                  "--verify-offline"])
    assert out["verified_clients"] == 4 and out["mismatches"] == 0


def _run_lanes(state, reps):
    """A run's final state and reports as numpy (arrays) and its counts
    (ints: meters, then the wire gauges), for GPU / CPU equality."""
    arrays = convert.to_numpy(
        [*state.client_state, state.server.slots, state.ef_residual]
        + [(r.per_client_accuracy, r.assignment, r.cluster_counts)
           for r in reps])
    ints = [(r.upload_bytes, r.download_bytes_broadcast,
             r.download_bytes_per_client, r.aggregated_uploads,
             r.wire_tx_bytes, r.wire_rx_bytes) for r in reps]
    return arrays, ints


@pytest.mark.gpu
@pytest.mark.parametrize("wire,sched", [
    ({}, {}),
    (dict(name="int8", error_feedback=True),
     dict(participation=0.75, dropout=0.25, straggler=0.3))],
    ids=["identity", "int8_ef_partial"])
def test_gpu_loopback_matches_in_process_and_cpu(cuda, wire, sched):
    """The loopback transport on the card (two worker peers, each
    launching the kernels on its block) equals the in-process engine on
    the card and the loopback on the CPU, bit for bit."""
    from repro_torch.fl.transport import TransportEngine
    cfg = RuntimeConfig(rounds=2, codec=CodecConfig(**wire),
                        scheduler=SchedulerConfig(**sched))
    loop = RuntimeConfig(rounds=2, codec=CodecConfig(**wire),
                         scheduler=SchedulerConfig(**sched),
                         transport="loopback", workers=2)
    runs = {}
    for dev in ("cpu", "cuda"):
        data = _population(dev, 4, n_train=16)
        strat = TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2)
        n = ops.LAUNCHES["train_epoch_fused"]
        runs[dev, "loopback"] = _run_lanes(*TransportEngine(
            strat, data, loop).run(tr.PRNGKey(5, dev)))
        if dev == "cuda":
            assert ops.LAUNCHES["train_epoch_fused"] > n
            runs[dev, "inprocess"] = _run_lanes(*Engine(
                strat, data, cfg).run(tr.PRNGKey(5, dev)))
    np.testing.assert_equal(runs["cpu", "loopback"],
                            runs["cuda", "loopback"])
    (arrays, ints), (ref_arrays, ref_ints) = (runs["cuda", "loopback"],
                                              runs["cuda", "inprocess"])
    np.testing.assert_equal(arrays, ref_arrays)
    assert [r[:4] for r in ints] == [r[:4] for r in ref_ints]
    assert all(r[4] > 0 and r[5] > 0 for r in ints)


@pytest.mark.gpu
def test_gpu_socket_matches_in_process(cuda, capfd):
    """``fed_train --transport socket --workers 2`` on the card: two
    worker processes, each on the card with its own kernel launches,
    print the in-process run's metrics."""
    import json
    flags = ["--clients", "4", "--rounds", "2", "--clauses", "16",
             "--local-epochs", "2", "--device", "cuda"]
    ref = fed_train.main(flags)
    out = fed_train.main(flags + ["--transport", "socket", "--workers", "2"])
    assert out["acc_per_round"] == ref["acc_per_round"]
    for k in ("upload_bytes", "download_bytes_broadcast",
              "download_bytes_per_client"):
        assert out[k] == ref[k], k
    workers = [json.loads(line.split("transport worker ", 1)[1])
               for line in capfd.readouterr().err.splitlines()
               if line.startswith("transport worker ")]
    assert sorted(w["rank"] for w in workers) == [0, 1]
    for w in workers:
        assert w["device"].startswith("cuda")
        assert w["launches"]["train_epoch_fused"] == 2 * 2
        assert w["launches"]["fused_votes_batched"] > 0


def _sharded_forms_on_the_card(mesh, kind):
    """Rank worker: each sharded form of ``masked_collectives`` on this
    rank's block, on its card; rank 0's results to the host."""
    from repro_torch.fl import masked_collectives as mc
    rng = np.random.default_rng(5)
    vals = (rng.standard_normal((12, 20)) if kind == "frac"
            else rng.integers(-8, 9, (12, 20))).astype(np.float32)
    v = torch.as_tensor(vals, device=mesh.device)
    s = torch.as_tensor(rng.integers(-1, 10, 12).astype(np.int32),
                        device=mesh.device)
    w = torch.as_tensor((0.5 ** rng.integers(0, 3, 12)).astype(np.float32),
                        device=mesh.device)
    blk = 12 // mesh.size
    mine = slice(mesh.rank * blk, (mesh.rank + 1) * blk)
    mean, counts = mc.clustered_mean_gathered(v[mine], s[mine], 10, mesh,
                                              n_valid=12)
    wmean, total = mc.clustered_weighted_mean_sharded(
        v[mine], s[mine], w[mine], 10, mesh, exact_products=True)
    bmean, _ = mc.buffered_weighted_mean_sharded(v, s, w, 10, mesh,
                                                 exact_products=True)
    one = mc.clustered_mean_sharded(v[mesh.rank], s[mesh.rank].clamp(min=0),
                                    10, mesh)
    out = {k: t.cpu().numpy() for k, t in dict(
        mean=mean, counts=counts, wmean=wmean, total=total, bmean=bmean,
        one=one).items()}
    out.update(device=str(mesh.device), backend=mesh.backend,
               meter=mesh.meter.snapshot(),
               inputs=(vals, s.cpu().numpy(), w.cpu().numpy()))
    return out


def _check_sharded_forms(out, ranks):
    from repro_torch.fl import masked_collectives as mc
    v, s, w = (torch.as_tensor(a) for a in out["inputs"])
    host = clustering.aggregate(v, s, 10)
    np.testing.assert_array_equal(out["mean"], host.cluster_weights.numpy())
    np.testing.assert_array_equal(out["counts"], host.counts.numpy())
    want = mc.clustered_weighted_mean(v, s, w, 10, exact_products=True)
    np.testing.assert_array_equal(out["wmean"], want.numpy())
    np.testing.assert_array_equal(out["bmean"], want.numpy())
    one = clustering.aggregate(v[:ranks], s[:ranks].clamp(min=0), 10)
    np.testing.assert_array_equal(
        out["one"], one.cluster_weights[max(int(s[0]), 0)].numpy())
    assert out["meter"]["bytes"]["aggregate"] - out["meter"]["pad"][
        "aggregate"] == (mc.collective_payload_bytes("gather", 12, 20, 10)
                         + 3 * mc.collective_payload_bytes("psum", 12, 20,
                                                           10))


@pytest.mark.gpu
def test_sharded_forms_on_one_nccl_rank_equal_the_host_forms(cuda):
    """A one-rank NCCL mesh on ``cuda:0``: the gathered, weighted,
    buffered and one-client-a-rank forms equal the host forms on the CPU
    bit for bit (one rank's sums are the host's row loop), every
    collective on the card."""
    from repro_torch.launch import mesh as mesh_lib
    out = mesh_lib.spawn(_sharded_forms_on_the_card, 1, "frac",
                         device="cuda")
    assert (out["backend"], out["device"]) == ("nccl", "cuda:0")
    _check_sharded_forms(out, 1)


@pytest.mark.gpu
def test_sharded_forms_on_two_gloo_ranks_sharing_the_card(cuda):
    """Two ``gloo`` ranks on ``cuda:0`` (the shared-card world of
    ``chip_smoke.py`` path J2): integer values at power-of-two weights,
    so the forms equal the host forms in any order.  The mesh builder
    checked that ``gloo`` runs each collective on the card's tensors."""
    from repro_torch.launch import mesh as mesh_lib
    out = mesh_lib.spawn(_sharded_forms_on_the_card, 2, "int",
                         device="cuda", shared_device=True)
    assert (out["backend"], out["device"]) == ("gloo", "cuda:0")
    _check_sharded_forms(out, 2)


# the model scaffold: path K3 of chip_smoke.py, whose run, differences
# and bounds (K3_TOL) these tests use
_ARCHS = ("jamba_1_5_large_398b", "qwen3_32b", "granite_20b",
          "musicgen_large", "yi_6b", "xlstm_350m", "deepseek_v3_671b",
          "phi3_medium_14b", "chameleon_34b", "granite_moe_3b_a800m")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _ARCHS)
def test_gpu_model_matches_cpu(cuda, arch):
    """A reduced() architecture on the card against the port on the CPU:
    parameters bit for bit, forward and decode logits, the loss and one
    train step within ``K3_TOL``."""
    from repro_torch.configs import registry as archs
    from repro_torch.models import config as mcfg
    smoke = _chip_smoke()
    cfg = mcfg.reduced(archs.get(arch))
    got = smoke.k3_diffs(smoke.k3_run(cfg, cuda), smoke.k3_run(cfg, "cpu"))
    assert got is not None, "parameters differ from the CPU's"
    for k, v in got.items():
        assert v <= smoke.K3_TOL[k], (k, v)


@pytest.mark.gpu
def test_gpu_moe_training_step_repeats_bit_for_bit(cuda):
    """The MoE layer's forward and backward at granite-moe-3b-a800m's
    full width, twice on the same inputs: the same bits (no backward
    adds colliding values with atomics)."""
    from repro_torch import tree
    from repro_torch.configs import registry as archs
    from repro_torch.models import moe
    cfg = archs.get("granite_moe_3b_a800m")
    p = moe.moe_init(tr.PRNGKey(0, cuda), cfg)
    x = tr.normal(tr.PRNGKey(1, cuda), (2, 256, cfg.d_model)).bfloat16()
    r = tr.normal(tr.PRNGKey(2, cuda), (2, 256, cfg.d_model))
    runs = []
    for _ in range(2):
        pg = tree.map(lambda a: a.clone().requires_grad_(True), p)
        xg = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply(pg, xg, cfg)
        (torch.sum(y.float() * r) + aux).backward()
        runs.append([y, xg.grad] + [a.grad for a in tree.leaves(pg)])
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_train_cli_save_restore(cuda, tmp_path):
    """``train.py --save`` then ``--restore`` on the card, bit for bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    argv = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "1",
            "--seq", "16"]
    saved = train.main(argv + ["--save", str(tmp_path / "c.msgpack")])
    back = train.main(argv + ["--restore", str(tmp_path / "c.msgpack"),
                              "--steps", "0"])

    def keyed(t):
        out = {}
        ckpt._map(lambda k, v: out.__setitem__(k, v), t)
        return out
    a = keyed({"params": saved["params"], "opt": saved["opt"]})
    b = keyed({"params": back["params"], "opt": back["opt"]})
    assert list(a) == list(b)
    for k in a:
        assert b[k].is_cuda and torch.equal(a[k], b[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v3_671b",
                                  "jamba_1_5_large_398b", "xlstm_350m"])
def test_model_mesh_on_the_card(cuda, arch):
    """The model mesh on 4 ``gloo`` ranks sharing the card (data 2, model
    2), ``REPRO_SHARDED_CE`` / ``REPRO_SHARD_MOE`` on: one train step,
    the prefill logits, and 4 greedy tokens decoded on caches held as
    their ``rules.cache_specs`` blocks (each rank's bytes the dry run's)
    with every decode step's logits, against the one-process port on the
    CPU on whole caches, float32 parameters, within 1e-4 relative (the
    card's and the CPU's products sum in other orders); the tokens
    equal."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import registry as archs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import model_mesh, steps
    from repro_torch.models import config as mcfg
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    cfg = mcfg.reduced(archs.get(arch))
    if arch == "deepseek_v3_671b":
        cfg = dataclasses.replace(cfg, segments=((1, (
            mcfg.LayerSpec("attn", "dense"), mcfg.LayerSpec("attn", "moe"))),))
    if arch == "xlstm_350m":
        cfg = dataclasses.replace(cfg, segments=((1, (
            mcfg.LayerSpec("mlstm", "none"),
            mcfg.LayerSpec("slstm", "none"))),))
    params = tree.map(lambda a: a.float(), transformer.init(
        tr.PRNGKey(0, "cpu"), cfg))
    toks = tr.randint(tr.PRNGKey(1, "cpu"), (4, 8), 0, cfg.vocab).int()
    labels = torch.roll(toks, -1, 1)
    env = {"REPRO_SHARDED_CE": "1", "REPRO_SHARD_MOE": "1"}
    job = dict(mesh=(("data", "model"), (2, 2)), cfg=cfg, env=env,
               params=tree.map(lambda a: a.to(cuda), params),
               dtype=torch.float32, prefill=toks.to(cuda),
               decode={"prompt": toks[:, :2].to(cuda), "steps": 4},
               train={"tokens": toks.to(cuda), "labels": labels.to(cuda),
                      "steps": 1}, gather_params=True)
    got, = mesh_lib.spawn(model_mesh.run_steps, 4, [job], device="cuda",
                          shared_device=True)
    assert {r["device"] for r in got["ranks"]} == {"cuda:0"}
    for r in got["ranks"]:
        assert r["cache_bytes"]["held"] == r["cache_bytes"]["dryrun"]
        assert r["meter"]["decode"]["bytes"]["context"] > 0
    with model_mesh._environ(env):
        pre = steps.make_prefill_step(cfg)(params, {"tokens": toks})
        caches = tree.map(lambda a: a.float() if a.is_floating_point()
                          else a, transformer.init_cache(cfg, 4, 6,
                                                         device="cpu"))
        fed, tokens, logits = toks[:, :1], [], []
        for t in range(6):
            with torch.no_grad():
                lg, nxt, caches = steps.serve_logits(cfg, params, fed,
                                                     caches)
            logits.append(lg[:, 0])
            fed = toks[:, t + 1:t + 2] if t + 1 < 2 else nxt
            if t + 1 >= 2:
                tokens.append(nxt)
        _, _, m = steps.make_train_step(cfg)(
            tree.map(torch.clone, params), adamw.init(params),
            {"tokens": toks, "labels": labels})

    def rel(a, b):
        a, b = a.detach().cpu().double(), b.detach().double()
        keep = b > -1e29
        return float((a - b).abs()[keep].max() / b.abs()[keep].max())

    assert rel(got["prefill"], pre) <= 1e-4
    assert rel(got["decode_logits"], torch.stack(logits, 1)) <= 1e-4
    assert torch.equal(got["tokens"].cpu().long(), torch.cat(tokens, 1).long())
    assert abs(got["metrics"][0]["loss"] - float(m["loss"])) \
        <= 1e-4 * float(m["loss"])
