"""The port's loopback transport against the JAX package's loopback
``TransportEngine`` and against the port's in-process engine, on the
CPU, each package on the population its own partition draws from the
same seeds (the same bits: tests/test_torch_data.py).

Held bit for bit: every report field (the wire gauges ``wire_tx_bytes``
/ ``wire_rx_bytes`` and the observed staleness included, against the
JAX loopback), the codec-metered bytes and the final state (client rows
re-assembled from the worker blocks, server rows, buffer lanes, the
sparse references and error-feedback residuals), on the identity wire,
on int8 + error feedback, on int8 + sparse, under partial
participation with dropout and stragglers, and async with observed
staleness (against the JAX async loopback only: arrivals go in in worker
rank order, so an async transport run is not the in-process engine's
bits, in either package).  ``mean_accuracy`` is held within 1e-6 (queue
C item 3).  FLIS-DC (an MLP: float math) is held within the baselines'
atol 1e-6 / rtol 1e-5 against the JAX loopback on float32, and exactly
against the port's in-process engine on float32 and int8: a worker's
block of clients trains its rows of the whole cohort's product on the
CPU.  On int8 its reports (assignments, counts, bytes exact, accuracy
within the tolerance) are held against the JAX loopback, its state is
not: training from int8-quantized rows meets ReLU ties whose side
follows the dot's summation order (ROADMAP queue C item 5), one
quantization step in a few rows after 2 rounds.  Injected faults (a
disconnect retried, retries exhausted, a delay, a drop) act as in the
reference.

Each JAX configuration runs once, in a module-scoped fixture, and both
port runs are held against it."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import SchedulerConfig as JSchedulerConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline
from repro.fl.transport import DisconnectError as JDisconnectError
from repro.fl.transport import FaultPlan as JFaultPlan
from repro.fl.transport import RetryPolicy as JRetryPolicy
from repro.fl.transport import TransportEngine as JTransportEngine
from repro_torch import convert
from repro_torch import random as tr
from repro_torch import tree
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.obs import RunRecorder
from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                    SchedulerConfig, TPFLStrategy,
                                    build_baseline_strategy)
from repro_torch.fl.transport import (DisconnectError, FaultPlan,
                                      RetryPolicy, TransportEngine)
from test_torch_gpu import one_torch_thread  # noqa: F401

TM = dict(n_classes=10, n_clauses=16, n_features=100, n_states=63, s=5.0,
          T=20)
FLIS = dict(n_features=100, n_classes=10, n_hidden=16, local_epochs=1,
            batch=8, max_slots=4, probe_size=32)
TOL = dict(atol=1e-6, rtol=1e-5)

# name: (strategy, clients, rounds, runtime kwargs, key, in-process pin)
CONFIGS = {
    "identity": ("tpfl", 6, 2, {}, 42, True),
    "int8_error_feedback": ("tpfl", 6, 2, dict(
        codec=dict(name="int8", error_feedback=True)), 42, True),
    "int8_sparse_partial": ("tpfl", 6, 2, dict(
        codec=dict(name="int8", sparse=True),
        scheduler=dict(participation=0.5, dropout=0.2)), 5, True),
    "partial_dropout_stragglers": ("tpfl", 6, 2, dict(
        scheduler=dict(participation=0.5, dropout=0.2, straggler=0.3)),
        7, True),
    "async_observed_staleness": ("tpfl", 6, 3, dict(
        aggregation="async", async_min_uploads=2, buffer_capacity=8,
        scheduler=dict(straggler=0.5, max_staleness=2, dropout=0.1)),
        0, False),
    "flis": ("flis_dc", 6, 2, {}, 3, True),
    "flis_int8": ("flis_dc", 6, 2, dict(codec=dict(name="int8")), 3, True),
}
# queue C item 5: the int8 MLP state is held against the port only
STATE_VS_JAX = [n for n in CONFIGS if n != "flis_int8"]


def _populations(n_clients):
    x, y, _ = synthetic.make_dataset("synthmnist", 900, tr.PRNGKey(0, "cpu"),
                                     side=10)
    data = partition.partition(x, y, 10, n_clients=n_clients, experiment=5,
                               key=tr.PRNGKey(1, "cpu"), n_train=24,
                               n_test=12, n_conf=12)
    jx, jy, _ = jsynthetic.make_dataset("synthmnist", 900,
                                        jax.random.PRNGKey(0), side=10)
    jdata = jpartition.partition(jx, jy, 10, n_clients=n_clients,
                                 experiment=5, key=jax.random.PRNGKey(1),
                                 n_train=24, n_test=12, n_conf=12)
    return data, jdata


def _strategies(name):
    if name == "tpfl":
        return (TPFLStrategy(ttm.TMConfig(**TM), local_epochs=1),
                JTPFLStrategy(jtm.TMConfig(**TM), local_epochs=1))
    return (build_baseline_strategy(name, **FLIS),
            jbuild_baseline(name, **FLIS))


def _configs(rounds, kw, transport=True):
    kw = dict(kw)
    codec, sched = kw.pop("codec", {}), kw.pop("scheduler", {})
    extra = dict(transport="loopback", workers=2) if transport else {}
    return (RuntimeConfig(rounds=rounds, codec=CodecConfig(**codec),
                          scheduler=SchedulerConfig(**sched), **kw, **extra),
            JRuntimeConfig(rounds=rounds, codec=JCodecConfig(**codec),
                           scheduler=JSchedulerConfig(**sched), **kw,
                           transport="loopback", workers=2))


@pytest.fixture(scope="module")
def runs():
    """Each configuration run by the JAX loopback, the port's loopback
    (with a run recorder) and, where pinned, the port's in-process
    engine; computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            strat, n, rounds, kw, seed, pin = CONFIGS[name]
            data, jdata = _populations(n)
            tstrat, jstrat = _strategies(strat)
            cfg, jcfg = _configs(rounds, kw)
            key = jax.random.PRNGKey(seed)
            tkey = convert.key_from_numpy(key, "cpu")
            jst, jreps = JTransportEngine(jstrat, jdata, jcfg).run(key)
            rec = RunRecorder()
            tst, treps = TransportEngine(tstrat, data, cfg,
                                         telemetry=rec).run(tkey)
            inproc = None
            if pin:
                inproc = Engine(tstrat, data,
                                _configs(rounds, kw, False)[0]).run(tkey)
            cache[name] = dict(jax=(jst, jreps), port=(tst, treps),
                               inproc=inproc, recorder=rec, data=data,
                               strategy=tstrat)
        return cache[name]
    return get


def _bits(a):
    a = convert.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _close(a, b):
    np.testing.assert_allclose(convert.to_numpy(b) if isinstance(
        b, torch.Tensor) else np.asarray(b), np.asarray(
        convert.to_numpy(a) if isinstance(a, torch.Tensor) else a), **TOL)


INTS = ("round_idx", "upload_bytes", "download_bytes_broadcast",
        "download_bytes_per_client", "aggregated_uploads",
        "buffered_uploads", "evicted_uploads")


def _same_reports(ref, ours, wire=True, exact=True):
    assert len(ref) == len(ours)
    for a, b in zip(ref, ours):
        for f in INTS + (("wire_tx_bytes", "wire_rx_bytes",
                          "observed_staleness") if wire else ()):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("assignment", "cluster_counts"):
            _same(getattr(a, f), getattr(b, f))
        for f in ("idx", "active", "staleness"):
            _same(getattr(a.participation, f), getattr(b.participation, f))
        if exact:
            _same(a.per_client_accuracy, b.per_client_accuracy)
        else:
            _close(a.per_client_accuracy, b.per_client_accuracy)
        assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) <= 1e-6


def _lanes(state):
    """The final state as named lanes: client rows, server rows (and the
    strategy's aux), the buffer and the wire's lanes."""
    cs = state.client_state
    client = (dict(cs.params) if hasattr(cs, "params") else
              {f: getattr(cs, f) for f in cs._fields})
    out = {f"client.{k}": v for k, v in client.items()}
    out["server"] = state.server.slots
    for f in ("round_idx", "buf_vecs", "buf_slots", "buf_ready",
              "buf_weight", "buf_valid", "buf_seq", "ref_vecs",
              "ref_round", "ef_residual"):
        out[f] = getattr(state, f)
    return out


def _same_state(ref, ours, exact=True):
    a, b = _lanes(ref), _lanes(ours)
    assert a.keys() == b.keys()
    for k in a:
        if exact or k in ("round_idx", "buf_slots", "buf_ready",
                          "buf_valid", "buf_seq", "ref_round"):
            _same(a[k], b[k])
        else:
            _close(a[k], b[k])


@pytest.mark.parametrize("name", CONFIGS)
def test_loopback_reports_equal_the_jax_loopback(runs, name):
    r = runs(name)
    exact = CONFIGS[name][0] == "tpfl"
    _same_reports(r["jax"][1], r["port"][1], exact=exact)
    assert all(rep.wire_tx_bytes > 0 and rep.wire_rx_bytes > 0
               for rep in r["port"][1])


@pytest.mark.parametrize("name", STATE_VS_JAX)
def test_loopback_state_equals_the_jax_loopback(runs, name):
    r = runs(name)
    _same_state(r["jax"][0], r["port"][0], exact=CONFIGS[name][0] == "tpfl")


@pytest.mark.parametrize("name", [n for n, c in CONFIGS.items() if c[5]])
def test_loopback_equals_the_in_process_engine(runs, name):
    """Every report field but the wire gauges, the meters and the final
    state, bit for bit: the FLIS-DC rows too (a block of clients trains
    its rows of the whole cohort's product, on the CPU)."""
    r = runs(name)
    (ist, ireps), (tst, treps) = r["inproc"], r["port"]
    _same_reports(ireps, treps, wire=False)
    for rep in ireps:
        assert rep.wire_tx_bytes == rep.wire_rx_bytes == 0
        assert rep.observed_staleness is None
    _same_state(ist, tst)
    if name.startswith("flis"):
        for a, b in zip(tree.leaves(tuple(ist.server.aux)),
                        tree.leaves(tuple(tst.server.aux))):
            _same(a, b)


def test_async_records_observed_staleness(runs):
    reps = runs("async_observed_staleness")["port"][1]
    obs = [r.observed_staleness for r in reps]
    assert all(o is not None for o in obs)
    assert any(len(o["staleness_hist"]) > 1 for o in obs)   # a lag >= 1
    assert sum(r.aggregated_uploads for r in reps) > 0


def test_round_events_equal_the_jax_recorder(runs):
    """The port's round events of a loopback run against the JAX
    recorder's events of the same reports: the transport section, the
    wire spans, the byte and cluster gauges."""
    from repro.fl.obs import events as jevents
    r = runs("async_observed_staleness")
    rec = r["recorder"]
    prev = None
    for jrep, event in zip(r["jax"][1], rec.history):
        ref = jevents.to_jsonable(jevents.round_event(
            jrep, prev_assignment=prev))
        prev = np.asarray(jrep.assignment)
        assert event["transport"] == ref["transport"]
        assert event["transport"]["wire_tx_bytes"] > 0
        assert "observed" in event["transport"]
        for k in ("round", "bytes", "async", "scheduler", "store",
                  "cluster"):
            assert event[k] == ref[k], k
        assert {"wire_tx", "wire_rx", "uplink_codec",
                "aggregate"} <= set(event["phases"])


# -- injected faults, against the JAX loopback -----------------------------

def _fault_runs(faults, jfaults, retry=None, jretry=None, rounds=2,
                **kw):
    data, jdata = _populations(6)
    tstrat, jstrat = _strategies("tpfl")
    cfg, jcfg = _configs(rounds, kw)
    key = jax.random.PRNGKey(0)
    ours = TransportEngine(tstrat, data, cfg, faults=faults,
                           retry=retry).run(convert.key_from_numpy(key,
                                                                   "cpu"))
    ref = JTransportEngine(jstrat, jdata, jcfg, faults=jfaults,
                           retry=jretry).run(key)
    return ours, ref


def test_injected_disconnect_is_retried_and_run_unperturbed():
    """A disconnect on the server's recv path is retried with backoff;
    the queued frame is intact, so the run equals the clean run."""
    (tst, treps), (jst, jreps) = _fault_runs(
        FaultPlan(disconnect=((0, 0), (1, 2))),
        JFaultPlan(disconnect=((0, 0), (1, 2))),
        RetryPolicy(attempts=3, backoff=0.001),
        JRetryPolicy(attempts=3, backoff=0.001))
    _same_reports(jreps, treps)
    _same_state(jst, tst)
    data, _ = _populations(6)
    tstrat, _ = _strategies("tpfl")
    cst, creps = TransportEngine(tstrat, data, _configs(2, {})[0]).run(
        tr.PRNGKey(0, "cpu"))
    _same_reports(creps, treps)
    _same_state(cst, tst)


def test_retry_exhaustion_raises_disconnect():
    data, jdata = _populations(6)
    tstrat, jstrat = _strategies("tpfl")
    cfg, jcfg = _configs(1, {})
    plan = ((0, 0), (0, 1), (0, 2))
    with pytest.raises(DisconnectError, match="injected disconnect"):
        TransportEngine(tstrat, data, cfg, faults=FaultPlan(disconnect=plan),
                        retry=RetryPolicy(attempts=2, backoff=0.001)
                        ).run(tr.PRNGKey(0, "cpu"))
    with pytest.raises(JDisconnectError, match="injected disconnect"):
        JTransportEngine(jstrat, jdata, jcfg,
                         faults=JFaultPlan(disconnect=plan),
                         retry=JRetryPolicy(attempts=2, backoff=0.001)
                         ).run(jax.random.PRNGKey(0))


def test_fault_delay_shows_up_as_observed_staleness():
    """An injected delivery delay (async): client 2's round-0 upload
    arrives in round 2 with lag 2, as in the reference."""
    (_, treps), (_, jreps) = _fault_runs(
        FaultPlan(delay=((0, 2, 2),)), JFaultPlan(delay=((0, 2, 2),)),
        rounds=3, aggregation="async")
    _same_reports(jreps, treps)
    hist = treps[2].observed_staleness["staleness_hist"]
    assert len(hist) >= 3 and hist[2] >= 1


def test_fault_drop_removes_upload_from_barrier():
    (tst, treps), (jst, jreps) = _fault_runs(
        FaultPlan(drop=((0, 3),)), JFaultPlan(drop=((0, 3),)), rounds=1)
    _same_reports(jreps, treps)
    _same_state(jst, tst)
    data, _ = _populations(6)
    tstrat, _ = _strategies("tpfl")
    _, clean = TransportEngine(tstrat, data, _configs(1, {})[0]).run(
        tr.PRNGKey(0, "cpu"))
    assert treps[0].aggregated_uploads < clean[0].aggregated_uploads
    assert treps[0].upload_bytes < clean[0].upload_bytes


def test_transport_engine_refusals():
    data, _ = _populations(6)
    tstrat, _ = _strategies("tpfl")
    with pytest.raises(ValueError, match="is the in-process Engine"):
        TransportEngine(tstrat, data, RuntimeConfig(rounds=1))
    with pytest.raises(ValueError, match="needs a worker spec"):
        TransportEngine(tstrat, data, dataclasses.replace(
            _configs(1, {})[0], transport="socket"))


def test_loopback_with_unsampled_blocks_equals_the_in_process_engine():
    """One client of six a round over three workers: two blocks have no
    sampled client every round, train nothing and still evaluate."""
    data, _ = _populations(6)
    tstrat, _ = _strategies("tpfl")
    kw = dict(scheduler=dict(participation=1 / 6))
    cfg = dataclasses.replace(_configs(3, kw)[0], workers=3)
    key = tr.PRNGKey(11, "cpu")
    st, reps = TransportEngine(tstrat, data, cfg).run(key)
    ist, ireps = Engine(tstrat, data, _configs(3, kw, False)[0]).run(key)
    assert all(int(r.participation.idx.numel()) == 1 for r in reps)
    _same_reports(ireps, reps, wire=False)
    _same_state(ist, st)
