"""Async buffered aggregation on the port against the JAX engine on the
CPU, each engine on the ClientData its own package draws from the same
seeds.

The TM strategies (TPFL, TPFL with two shared classes, FedTM) are held
bit for bit: every report field (``buffered_uploads`` and
``evicted_uploads`` included), the final client state, the server rows,
the buffer's six lanes and the wire's lanes, on both buffer routes
(``device``: tensor ops; ``host``: the reference's numpy loop) and on
the float32 and the int8 + sparse + error-feedback wires, under the
reference's conformance schedule (``ASYNC_SCHED``: capacity 5, B = 2).
``mean_accuracy`` is held within 1e-6 (ROADMAP queue C item 3).  The
MLP baselines (IFCA on the device route, FLIS-DC / HC on the host route with
``assign`` at the fold) hold their integers and bytes bit for bit and
their floats within the baselines' ``TOL``.

Also here: the port's device route against its host route, the closed
form insert against the host loop (hypothesis and the overflow cases),
the weighted mean against the reference's at the buffer's shapes, the
port's counterparts of the reference's async engine tests, the CLI's
round lines, checkpoints and resume."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl import masked_collectives as jmc
from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import SchedulerConfig as JSchedulerConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro.fl.runtime import checkpointing as jcheckpointing
from repro.fl.runtime import executors as jexecutors
from repro.fl.runtime.strategy import FedTMStrategy as JFedTMStrategy
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline_strategy
from repro.launch import fed_train as jfed_train
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.checkpoint import ckpt
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.masked_collectives import clustered_weighted_mean
from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                    RuntimeConfig, SchedulerConfig,
                                    TPFLStrategy, build_baseline_strategy,
                                    checkpointing)
from repro_torch.fl.runtime.executors import buffer_insert
from repro_torch.launch import fed_serve, fed_train
from test_torch_baselines import KW as MLP_KW
from test_torch_baselines import TOL, _close_trees
from test_torch_gpu import one_torch_thread  # noqa: F401

TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)
SPLIT = dict(n_clients=6, experiment=5, n_train=24, n_test=12, n_conf=12)
# the reference's conformance schedule: stragglers, drops, a buffer of 5
# with B = 2, so buffering, gating, aggregation and overflow all fire
ASYNC_SCHED = dict(participation=0.75, dropout=0.25, straggler=0.5,
                   max_staleness=2)
ASYNC = dict(aggregation="async", async_min_uploads=2, buffer_capacity=5)
BUF_LANES = convert.BUF_LANES
WIRES = {"float32": {},
         "int8_sparse_ef": dict(name="int8", sparse=True,
                                error_feedback=True)}
STRATEGIES = {"tpfl": {}, "tpfl_top2": dict(top_classes=2), "fedtm": None}


@pytest.fixture(scope="module")
def populations():
    x, y, _ = synthetic.make_dataset("synthmnist", 600,
                                     tr.PRNGKey(0, "cpu"), side=12)
    data = partition.partition(x, y, 10, key=tr.PRNGKey(1, "cpu"), **SPLIT)
    jx, jy, _ = jsynthetic.make_dataset("synthmnist", 600,
                                        jax.random.PRNGKey(0), side=12)
    jdata = jpartition.partition(jx, jy, 10, key=jax.random.PRNGKey(1),
                                 **SPLIT)
    return jdata, data


def _tm_strategies(name, tm_kw=TM, local_epochs=2):
    kw = STRATEGIES[name]
    if kw is None:
        return (JFedTMStrategy(jtm.TMConfig(**tm_kw),
                               local_epochs=local_epochs),
                FedTMStrategy(ttm.TMConfig(**tm_kw),
                              local_epochs=local_epochs))
    return (JTPFLStrategy(jtm.TMConfig(**tm_kw), local_epochs=local_epochs,
                          **kw),
            TPFLStrategy(ttm.TMConfig(**tm_kw), local_epochs=local_epochs,
                         **kw))


def _engines(pops, strategies, rounds=3, sched=ASYNC_SCHED, wire=None,
             **rt):
    """The JAX engine and the port's, same strategy, schedule, codec and
    async settings (``rt`` over ``ASYNC``)."""
    (jdata, data), (jstrat, tstrat) = pops, strategies
    kw = {**ASYNC, **rt}
    wire = wire or {}
    jeng = JEngine(jstrat, jdata, JRuntimeConfig(
        rounds=rounds, scheduler=JSchedulerConfig(**sched),
        codec=JCodecConfig(**wire), tm_backend="ref", **kw))
    teng = Engine(tstrat, data, RuntimeConfig(
        rounds=rounds, scheduler=SchedulerConfig(**sched),
        codec=CodecConfig(**wire), **kw))
    return jeng, teng


def _run(eng, seed=0):
    key = jax.random.PRNGKey(seed)
    if isinstance(eng, Engine):
        return eng.run(convert.key_from_numpy(key, "cpu"))
    return eng.run(key)


def _bits(a):
    a = convert.to_numpy(a) if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


REPORT_INTS = ("upload_bytes", "download_bytes_broadcast",
               "download_bytes_per_client", "aggregated_uploads",
               "buffered_uploads", "evicted_uploads")


def _same_reports(jreps, treps, exact_floats=True):
    assert len(jreps) == len(treps)
    for a, b in zip(jreps, treps):
        assert a.round_idx == b.round_idx
        for f in ("assignment", "cluster_counts", "per_client_accuracy"):
            _same(getattr(a, f), getattr(b, f), f)
        assert [getattr(a, f) for f in REPORT_INTS] == \
            [getattr(b, f) for f in REPORT_INTS]
        assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) <= 1e-6
        for f in ("idx", "active", "staleness"):
            _same(getattr(a.participation, f), getattr(b.participation, f),
                  f)


def _same_state(jstate, tstate):
    """Every leaf of the two states, bit for bit, under the same paths."""
    _close_trees(jstate, tstate, exact_floats=True)


def _assert_lanes_live(state, reps):
    """The run reached the buffer: something aggregated, something is
    still waiting."""
    assert sum(r.aggregated_uploads for r in reps) > 0
    assert bool(convert.to_numpy(state.buf_valid).any()) or any(
        r.buffered_uploads for r in reps)


# -- TM strategies against the JAX engine, bit for bit ----------------------

@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("buffer", ["device", "host"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_async_federation_bit_identical(populations, strategy, buffer,
                                        wire):
    """Three async rounds under ``ASYNC_SCHED``: every report field, the
    final state with the buffer's six lanes, bit for bit.  Two shared
    classes a client overflow the 5-entry buffer: eviction fires."""
    jeng, teng = _engines(populations, _tm_strategies(strategy),
                          wire=WIRES[wire], async_buffer=buffer)
    jstate, jreps = _run(jeng)
    tstate, treps = _run(teng)
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    _assert_lanes_live(tstate, treps)
    if strategy == "tpfl_top2":
        assert sum(r.evicted_uploads for r in treps) > 0


@pytest.mark.parametrize("buffer", ["device", "host"])
def test_async_discount_not_a_power_of_two(populations, buffer):
    """A discount of 0.7 on the int8 + sparse + error-feedback wire: the
    weights and the decoded uploads are not exact, so the fold takes the
    emulated FMA of each product (``exact_products`` off) and still
    equals the reference bit for bit."""
    jeng, teng = _engines(populations, _tm_strategies("tpfl_top2"),
                          wire=WIRES["int8_sparse_ef"], async_buffer=buffer,
                          staleness_discount=0.7)
    assert not teng._exact_products
    jstate, jreps = _run(jeng)
    tstate, treps = _run(teng)
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    weights = set(convert.to_numpy(tstate.buf_weight).tolist())
    assert weights - {0.0, 1.0}, "no discounted upload in the buffer"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_async_device_route_equals_host_route(populations, strategy):
    """The port's two buffer routes: the same reports and state, bit for
    bit, with overflow (capacity 3)."""
    runs = []
    for buffer in ("device", "host"):
        _, teng = _engines(populations, _tm_strategies(strategy),
                           buffer_capacity=3, async_buffer=buffer)
        runs.append(_run(teng, seed=5))
    (sd, rd), (sh, rh) = runs
    _same_reports(rd, rh)
    _close_trees(convert.to_numpy(sd), sh, exact_floats=True)
    assert sum(r.evicted_uploads for r in rd) > 0


# -- the insert: closed form against the host loop --------------------------

def _random_buffer(rng, cap, d=3):
    """A buffer with distinct insertion orders on its valid lanes and
    stale values on the free ones."""
    valid = rng.random(cap) < rng.random()
    seq = rng.integers(0, 50, cap).astype(np.int32)
    seq[valid] = rng.permutation(40)[:int(valid.sum())]
    return [rng.normal(size=(cap, d)).astype(np.float32),
            rng.integers(-1, 4, cap).astype(np.int32),
            rng.integers(0, 9, cap).astype(np.int32),
            rng.random(cap).astype(np.float32), valid, seq]


def _insert_both(lanes, n_up, rng, r=3, discount=0.5):
    """The closed form and the host loop on the same buffer and uploads
    (one slot a client, so the loop's (c, j) order is the upload
    order): ``(host lanes, host evicted, device lanes, device evicted,
    upload lanes)``."""
    d = lanes[0].shape[1]
    dec = rng.normal(size=(n_up, 1, d)).astype(np.float32)
    slots = rng.integers(-1, 4, (n_up, 1)).astype(np.int32)
    active = rng.random(n_up) < 0.8
    stale = rng.integers(0, 3, n_up).astype(np.int32)
    host = [a.copy() for a in lanes]
    ev_host = Engine._host_insert(*host, dec, slots, active, stale, r,
                                  discount)
    disc = np.asarray([discount ** s for s in range(3)], np.float32)
    up = (torch.as_tensor(dec[:, 0]), torch.as_tensor(slots[:, 0]),
          torch.as_tensor((r + stale).astype(np.int32)),
          torch.as_tensor(disc[stale]),
          torch.as_tensor(active & (slots[:, 0] >= 0)))
    dev, ev_dev = buffer_insert(tuple(torch.as_tensor(a) for a in lanes),
                                *up)
    return host, ev_host, dev, int(ev_dev), up


@settings(max_examples=150, deadline=None, database=None)
@given(cap=st.integers(1, 9), n_up=st.integers(1, 24),
       seed=st.integers(0, 2 ** 32 - 1))
def test_buffer_insert_matches_the_host_loop(cap, n_up, seed):
    """Random buffers (empty, partial, full) and upload lists up to
    several times the capacity: the closed form writes the host loop's
    lanes and counts its evictions."""
    rng = np.random.default_rng(seed)
    host, ev_host, dev, ev_dev, _ = _insert_both(
        _random_buffer(rng, cap), n_up, rng)
    assert ev_dev == ev_host
    for name, a, b in zip(BUF_LANES, host, dev):
        _same(a, b, name)


@pytest.mark.parametrize("cap,valid,n_up", [
    (4, [], 4),                 # fills exactly, nothing evicted
    (4, [], 11),                # wraps round the buffer twice
    (5, [0, 2, 3], 3),          # 2 free lanes, then the oldest goes
    (3, [0, 1, 2], 7),          # full: every insert evicts, wrapping
    (6, [1, 4], 16)])           # free lanes in index order, then by age
def test_buffer_insert_overflow_cases(cap, valid, n_up):
    """Each overflow case against the host loop and against the
    reference's ``lax.scan`` insert, the evictions counted."""
    rng = np.random.default_rng(cap * 100 + n_up)
    lanes = _random_buffer(rng, cap)
    lanes[4] = np.isin(np.arange(cap), valid)
    lanes[5][lanes[4]] = rng.permutation(20)[:len(valid)]
    host, ev_host, dev, ev_dev, up = _insert_both(lanes, n_up, rng)
    jbuf, jev = jexecutors._buffer_insert(
        tuple(jnp.asarray(a) for a in lanes),
        *(jnp.asarray(convert.to_numpy(u)) for u in up))
    n_ins = int(up[4].sum())
    assert ev_dev == ev_host == int(jev) == max(0, n_ins - (cap - len(valid)))
    for name, a, b, c in zip(BUF_LANES, host, dev, jbuf):
        _same(a, b, name)
        _same(c, b, name)


# -- the weighted mean ------------------------------------------------------

@pytest.mark.parametrize("n,d,c,weights", [
    (64, 300, 10, "float"), (64, 300, 10, "pow2"), (5, 16, 10, "float"),
    (33, 300, 1, "float"), (128, 64, 10, "float"), (64, 2250, 8, "float"),
    (64, 101770, 10, "float")])
def test_weighted_mean_bit_identical(n, d, c, weights):
    """``clustered_weighted_mean`` at the buffer's shapes (capacity 64,
    the TM's 300 / 2,250 and the MLP's 101,770 floats a row) on
    non-integer values, against the reference's eager and jitted forms:
    the products fused into the row-order adds, XLA's column sum of the
    weights, a true division.  Power-of-two weights are exact in any
    order, so the plain multiply-add form (``exact_products``) matches
    there too; others are not, and the emulated FMA still matches."""
    rng = np.random.default_rng(n * d + c)
    vals = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-1, c, n).astype(np.int32)
    w = (0.5 ** rng.integers(0, 3, n) if weights == "pow2"
         else rng.random(n)).astype(np.float32)
    w = np.where(ids >= 0, w, 0).astype(np.float32)
    args = (jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(w))
    want = jmc.clustered_weighted_mean(*args, c)
    _same(jax.jit(jmc.clustered_weighted_mean, static_argnums=3)(*args, c),
          want, "jit")
    for exact in ((False, True) if weights == "pow2" else (False,)):
        got = clustered_weighted_mean(torch.as_tensor(vals),
                                      torch.as_tensor(ids),
                                      torch.as_tensor(w), c,
                                      exact_products=exact)
        _same(want, got, f"exact_products={exact}")


@pytest.mark.parametrize("discount", [0.5, 0.25, 0.3, 0.7])
def test_weighted_mean_flushes_subnormals_as_xla(discount):
    """Queue C item 6: XLA:CPU runs with flush-to-zero and
    denormals-are-zero, so subnormal values count as zeros, and products,
    row sums and means that fall below the normal range are flushed.
    Tiny values (subnormal ones, and ones whose discounted products and
    means underflow) at a power-of-two discount (both forms) and at
    another (the emulated FMA): bit for bit with the reference."""
    rng = np.random.default_rng(int(discount * 100))
    n, d, c = 24, 40, 3
    vals = (rng.normal(size=(n, d)) * 1e-37).astype(np.float32)
    vals[:, :5] = (rng.normal(size=(n, 5)) * 3e-45).astype(np.float32)
    vals[:, 5:10] = (rng.normal(size=(n, 5)) * 2e-38).astype(np.float32)
    assert (np.abs(vals) < np.finfo(np.float32).tiny).any()
    ids = rng.integers(-1, c, n).astype(np.int32)
    w = np.where(ids >= 0, np.float32(discount) ** rng.integers(0, 3, n),
                 0).astype(np.float32)
    want = jmc.clustered_weighted_mean(jnp.asarray(vals), jnp.asarray(ids),
                                       jnp.asarray(w), c)
    assert (np.asarray(want) == 0).any()
    pow2 = discount in (0.5, 0.25)
    for exact in ((False, True) if pow2 else (False,)):
        got = clustered_weighted_mean(torch.as_tensor(vals),
                                      torch.as_tensor(ids),
                                      torch.as_tensor(w), c,
                                      exact_products=exact)
        _same(want, got, f"exact_products={exact}")
        sub = (got != 0) & (got.abs() < torch.finfo(torch.float32).tiny)
        assert not bool(sub.any())


# -- the MLP baselines ------------------------------------------------------

@pytest.mark.parametrize("name,buffer", [
    ("ifca", "device"), ("flis_dc", "device"), ("flis_hc", "host")])
def test_async_mlp_baselines_within_tolerance(populations, name, buffer):
    """IFCA on the device route, FLIS (which folds on the host route
    whatever ``async_buffer`` says, ``assign`` over the matured rows):
    integers and bytes bit for bit, floats within ``TOL``."""
    jeng, teng = _engines(populations, (
        jbuild_baseline_strategy(name, **MLP_KW),
        build_baseline_strategy(name, **MLP_KW)), async_buffer=buffer)
    jstate, jreps = _run(jeng)
    tstate, treps = _run(teng)
    assert len(jreps) == len(treps)
    for a, b in zip(jreps, treps):
        for f in ("assignment", "cluster_counts", "per_client_accuracy"):
            _same(getattr(a, f), getattr(b, f), f)
        assert [getattr(a, f) for f in REPORT_INTS] == \
            [getattr(b, f) for f in REPORT_INTS]
        for f in ("idx", "active", "staleness"):
            _same(getattr(a.participation, f), getattr(b.participation, f))
    _close_trees(jstate, tstate)
    _assert_lanes_live(tstate, treps)
    if name.startswith("flis"):
        assert teng._async_hooks


# -- the reference's async engine tests, on the port ------------------------

REF_TM = dict(n_classes=10, n_clauses=20, n_features=100, n_states=63,
              s=5.0, T=20)
REF_SPLIT = dict(n_clients=8, experiment=5, n_train=40, n_test=20, n_conf=20)


@pytest.fixture(scope="module")
def ref_populations():
    """``tests/test_fl_runtime.py::_data()``, drawn by each package."""
    x, y, _ = synthetic.make_dataset("synthmnist", 1500,
                                     tr.PRNGKey(0, "cpu"), side=10)
    data = partition.partition(x, y, 10, key=tr.PRNGKey(1, "cpu"),
                               **REF_SPLIT)
    jx, jy, _ = jsynthetic.make_dataset("synthmnist", 1500,
                                        jax.random.PRNGKey(0), side=10)
    jdata = jpartition.partition(jx, jy, 10, key=jax.random.PRNGKey(1),
                                 **REF_SPLIT)
    return jdata, data


def _ref_engines(pops, rounds=1, sched=None, tm_kw=TM, local_epochs=2,
                 **rt):
    """A TPFL engine on both packages, ``rt`` the whole async
    configuration: the file's small TM (its programs compiled once for
    the whole file) unless ``tm_kw`` names the reference test's."""
    (jdata, data), sched = pops, sched or {}
    jeng = JEngine(JTPFLStrategy(jtm.TMConfig(**tm_kw),
                                 local_epochs=local_epochs),
                   jdata, JRuntimeConfig(
                       rounds=rounds, scheduler=JSchedulerConfig(**sched),
                       aggregation="async", **rt))
    teng = Engine(TPFLStrategy(ttm.TMConfig(**tm_kw),
                               local_epochs=local_epochs),
                  data, RuntimeConfig(
                      rounds=rounds, scheduler=SchedulerConfig(**sched),
                      aggregation="async", **rt))
    return jeng, teng


def _round(eng, state, key):
    if isinstance(eng, Engine):
        return eng.run_round(state, convert.key_from_numpy(key, "cpu"))
    return eng.run_round(state, key)


def _init(eng, seed=0):
    key = jax.random.PRNGKey(seed)
    return eng.init(convert.key_from_numpy(key, "cpu")
                    if isinstance(eng, Engine) else key)


def test_async_buffered_aggregation_applies_mature_uploads(populations):
    """Matured uploads are aggregated, none evicted, every sent upload
    either aggregated or still buffered; the run equals the
    reference's."""
    jeng, teng = _ref_engines(populations, rounds=3, sched=dict(
        participation=0.75, straggler=0.5, max_staleness=2),
        async_min_uploads=2)
    jstate, jreps = _run(jeng)
    tstate, treps = _run(teng)
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    assert sum(r.aggregated_uploads for r in treps) > 0
    assert all(r.evicted_uploads == 0 for r in treps)
    sent = sum(int(r.participation.active.sum()) for r in treps)
    assert sum(r.aggregated_uploads for r in treps) \
        + treps[-1].buffered_uploads == sent


@pytest.mark.parametrize("buffer", ["device", "host"])
def test_async_below_threshold_broadcasts_nothing(ref_populations, buffer):
    """Below B the server and the clients' local training are left as
    they are: nothing aggregated, applied or billed.  The reference's
    test also asks ``mean_accuracy > 0.5``, which its own run misses
    (0.45625, ROADMAP "Reference state"): the port is held to the
    reference's accuracy instead, per client bit for bit."""
    jeng, teng = _ref_engines(ref_populations, tm_kw=REF_TM,
                              local_epochs=1, async_min_uploads=10 ** 6,
                              async_buffer=buffer)
    outs = []
    for eng in (jeng, teng):
        state = _init(eng)
        new_state, rep = _round(eng, state, jax.random.PRNGKey(1))
        outs.append((new_state, rep))
        assert rep.aggregated_uploads == 0
        assert (np.asarray(_bits(new_state.server.slots))
                == _bits(state.server.slots)).all()
        assert (_bits(rep.assignment) == -1).all()
        assert rep.download_bytes_per_client == 0
        assert rep.buffered_uploads == 8
    (js, jr), (ts, trep) = outs
    _same_reports([jr], [trep])
    _same_state(js, ts)
    assert float(trep.mean_accuracy) == pytest.approx(0.45625, abs=1e-6)


@pytest.mark.parametrize("buffer", ["device", "host"])
def test_async_overflow_evicts_oldest_insertion_first(populations, buffer):
    """Four uploads into a capacity-2 buffer: the two oldest are evicted,
    the two newest survive."""
    jeng, teng = _ref_engines(
        populations, async_min_uploads=10 ** 6, buffer_capacity=2,
        async_buffer=buffer, sched=dict(participation=0.75))
    outs = [_round(e, _init(e), jax.random.PRNGKey(1)) for e in (jeng, teng)]
    (js, jr), (ts, trep) = outs
    assert trep.evicted_uploads == 2 and trep.buffered_uploads == 2
    assert ts.buf_seq.tolist() == [2, 3]
    _same_reports([jr], [trep])
    _same_state(js, ts)


@pytest.mark.parametrize("buffer", ["device", "host"])
def test_async_zero_staleness_weight_never_populates_a_slot(
        populations, buffer):
    """discount 0 and every upload stale: zero aggregate weight, so the
    server keeps its previous rows and nothing is broadcast."""
    jeng, teng = _ref_engines(
        populations, async_min_uploads=1, staleness_discount=0.0,
        async_buffer=buffer, sched=dict(straggler=1.0, max_staleness=1))
    outs = []
    for eng in (jeng, teng):
        state = _init(eng)
        full = (torch.full_like if isinstance(eng, Engine)
                else jnp.full_like)(state.server.slots, 7.0)
        seeded = state._replace(server=state.server._replace(slots=full))
        mid, rep0 = _round(eng, seeded, jax.random.PRNGKey(1))
        new_state, rep1 = _round(eng, mid, jax.random.PRNGKey(2))
        assert rep0.aggregated_uploads == rep1.aggregated_uploads == 0
        assert (_bits(new_state.server.slots)
                == _bits(seeded.server.slots)).all()
        assert (_bits(rep1.assignment) == -1).all()
        outs.append((new_state, [rep0, rep1]))
    _same_reports(outs[0][1], outs[1][1])
    _same_state(outs[0][0], outs[1][0])


@pytest.mark.parametrize("buffer", ["device", "host"])
def test_async_maturing_exactly_at_min_uploads_aggregates(populations,
                                                          buffer):
    """The gate is ≥: 6 matured uploads at B = 6 aggregate and drain the
    buffer; at B = 7 nothing aggregates and all 6 stay."""
    for b, agg, left in ((6, 6, 0), (7, 0, 6)):
        jeng, teng = _ref_engines(populations, async_min_uploads=b,
                                  async_buffer=buffer)
        outs = [_round(e, _init(e), jax.random.PRNGKey(1))
                for e in (jeng, teng)]
        (js, jr), (ts, trep) = outs
        assert (trep.aggregated_uploads, trep.buffered_uploads) == (agg,
                                                                    left)
        assert bool(ts.buf_valid.any()) == bool(left)
        _same_reports([jr], [trep])
        _same_state(js, ts)


def test_async_entries_can_outlive_max_staleness_ungated(populations):
    """Entries whose maturity round passed long ago (B never reached)
    stay valid with their discount from staleness, never from age."""
    jeng, teng = _ref_engines(
        populations, rounds=4, async_min_uploads=10 ** 6,
        buffer_capacity=64, sched=dict(participation=0.75, straggler=1.0,
                                       max_staleness=2))
    outs = []
    for eng in (jeng, teng):
        state = _init(eng)
        reps = []
        for r in range(4):
            state, rep = _round(eng, state, jax.random.fold_in(
                jax.random.PRNGKey(0), r))
            assert rep.aggregated_uploads == 0
            reps.append(rep)
        outs.append((state, reps))
    (js, jr), (ts, trs) = outs
    _same_reports(jr, trs)
    _same_state(js, ts)
    valid = ts.buf_valid.numpy()
    ready, weight = ts.buf_ready.numpy()[valid], ts.buf_weight.numpy()[valid]
    assert valid.sum() == 4 * 4                 # K=4 per round, none lost
    assert int(ready.min()) <= 2 < int(ts.round_idx)
    assert (weight >= 0.5 ** 2 - 1e-7).all() and (weight <= 1.0).all()


# -- configuration, CLI, checkpoints ----------------------------------------

@pytest.mark.parametrize("kw", [dict(aggregation="semi"),
                                dict(async_buffer="disk")])
def test_runtime_config_refuses_unknown_async_values(kw):
    with pytest.raises(ValueError, match="unknown"):
        RuntimeConfig(**kw)


CLI_ASYNC = {
    "tpfl_device": ["--clients", "6", "--rounds", "3", "--clauses", "16",
                    "--local-epochs", "1", "--mode", "async",
                    "--participation", "0.75", "--dropout", "0.25",
                    "--straggler", "0.5", "--async-min-uploads", "2",
                    "--buffer-capacity", "5"],
    "fedtm_host_int8": ["--clients", "6", "--rounds", "3", "--clauses", "8",
                        "--local-epochs", "1", "--strategy", "fedtm",
                        "--mode", "async", "--active", "4", "--straggler",
                        "0.6", "--max-staleness", "1", "--async-buffer",
                        "host", "--async-min-uploads", "3",
                        "--buffer-capacity", "4", "--staleness-discount",
                        "0.25", "--codec", "int8"],
}


def _report_lines(text: str) -> list[str]:
    keep = ("round ", "totals:", "final per-client")
    return [re.sub(r" acc=\S+", "", line) for line in text.splitlines()
            if line.startswith(keep)]


@pytest.mark.parametrize("case", CLI_ASYNC)
def test_fed_train_cli_async_prints_the_reference_lines(case, capsys):
    """``--mode async`` and its flags: the same round lines (with their
    ``agg= buf= evict=`` fields), totals and deciles as
    ``repro.launch.fed_train``; mean accuracy within 1e-6."""
    flags = CLI_ASYNC[case]
    ours = fed_train.main(["--device", "cpu", *flags])
    port_text = capsys.readouterr().out
    ref = jfed_train.main(flags)
    ref_text = capsys.readouterr().out
    assert "mode=async" in port_text.splitlines()[0]
    lines = _report_lines(port_text)
    assert lines == _report_lines(ref_text)
    assert len(lines) == 3 + 2 and all(" buf=" in x for x in lines[:3])
    np.testing.assert_allclose(ours["acc_per_round"], ref["acc_per_round"],
                               rtol=0, atol=1e-6)


def _leaf_layout(path):
    payload = ckpt.unpackb(path.read_bytes())
    return [(k, v["dtype"], tuple(v["shape"])) for k, v in payload.items()]


def test_async_checkpoints_cross_both_ways(populations, tmp_path):
    """After an async round each package's checkpoint has the same leaf
    keys in the same order, with the same dtypes and shapes; each
    restores the other's (the buffer's lanes bit for bit) and continues
    to the other's next round."""
    jeng, teng = _engines(populations, _tm_strategies("tpfl_top2"),
                          rounds=1, async_min_uploads=6)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jstate, _ = _run(jeng)
    tstate, _ = _run(teng)
    jpath = jcheckpointing.save(str(jdir), jstate)
    tpath = checkpointing.save(tdir, tstate)
    assert _leaf_layout(jpath) == _leaf_layout(tpath)
    assert any(k.startswith(".buf_") for k, _, _ in _leaf_layout(tpath))
    assert jpath.read_bytes() == tpath.read_bytes()
    t_from_j = checkpointing.restore(jpath, teng.init(
        convert.key_from_numpy(jax.random.PRNGKey(9), "cpu")))
    j_from_t = jcheckpointing.restore(str(tpath), jeng.init(
        jax.random.PRNGKey(9)))
    _same_state(jstate, t_from_j)
    _same_state(j_from_t, tstate)
    assert bool(t_from_j.buf_valid.any())
    key = jax.random.PRNGKey(0)
    jnext, jrep = jeng.run(key, state=j_from_t, rounds=1)
    tnext, trep = teng.run(convert.key_from_numpy(key, "cpu"),
                           state=t_from_j, rounds=1)
    _same_reports(jrep, trep)
    _same_state(jnext, tnext)
    handed = convert.engine_state_from_numpy(
        np.asarray(jstate.round_idx),
        np.asarray(jstate.client_state.ta_state),
        np.asarray(jstate.client_state.weights),
        np.asarray(jstate.server.slots), device="cpu",
        buf=tuple(np.asarray(getattr(jstate, f)) for f in BUF_LANES))
    _same_state(jstate, handed)


def test_async_resume_bit_for_bit(tmp_path, capsys):
    """3 rounds against 2 rounds, then ``--resume`` for the third, with
    stragglers in the buffer across the checkpoint; the checkpoint
    serves with ``--buffer-capacity`` and fails to restore without."""
    flags = ["--device", "cpu", "--clients", "6", "--clauses", "16",
             "--local-epochs", "1", "--mode", "async", "--straggler", "0.6",
             "--async-min-uploads", "3", "--buffer-capacity", "8"]
    whole = fed_train.main(flags + ["--rounds", "3"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    fed_train.main(flags + ["--rounds", "2", *ck])
    resumed = fed_train.main(flags + ["--rounds", "3", "--resume", *ck])
    assert len(resumed["reports"]) == 1
    _same_reports(whole["reports"][2:], resumed["reports"])
    _close_trees(convert.to_numpy(whole["state"]), resumed["state"],
                 exact_floats=True)
    assert any(r.buffered_uploads for r in whole["reports"])
    serve = ["--device", "cpu", "--clients", "6", "--clauses", "16",
             "--local-epochs", "1", "--ckpt-dir", str(tmp_path),
             "--batch", "4", "--requests", "1", "--verify-offline"]
    out = fed_serve.main(serve + ["--buffer-capacity", "8"])
    assert out["mismatches"] == 0 and out["verified_clients"] == 6
    with pytest.raises(ValueError, match="buf_vecs"):
        fed_serve.main(serve + ["--registry", str(tmp_path / "reg64")])
    capsys.readouterr()


def test_async_events_read_the_buffer_counts(tmp_path):
    """The run recorder's ``async`` block holds each round's real
    buffered and evicted counts."""
    from repro_torch.fl import obs
    out = fed_train.main(["--device", "cpu", "--clients", "6", "--clauses",
                          "16", "--rounds", "2", "--local-epochs", "1",
                          "--mode", "async", "--active", "5",
                          "--straggler", "0.5", "--async-min-uploads", "9",
                          "--buffer-capacity", "7", "--telemetry-dir",
                          str(tmp_path)])
    events = obs.read_events(tmp_path / "events.jsonl")
    assert [e["async"] for e in events] == [
        {"aggregated": r.aggregated_uploads, "buffered": r.buffered_uploads,
         "evicted": r.evicted_uploads} for r in out["reports"]]
    assert sum(r.evicted_uploads for r in out["reports"]) > 0
