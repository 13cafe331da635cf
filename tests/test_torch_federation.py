"""The port's legacy federation loop (``core/federation.py``), its round
constructors (``launch/fed_train.make_tpfl_round`` /
``make_fedavg_tm_round``) and the names they use, against the JAX
package on the CPU.

* ``init_state`` + ``run_round`` against the JAX legacy loop, each
  package on the ClientData it draws from the same seeds, for j = 1,
  j = 2 and a ``conf_threshold``: parameters, cluster weights,
  assignment, counts, per-client accuracy and every byte field bit for
  bit, ``mean_accuracy`` within 1e-6 (a float32 mean whose summation
  order XLA and torch choose apart, ROADMAP queue C item 3);
* ``run`` (the engine) against the ``run_round`` loop in process (the
  loop on the ``gloo`` world: ``tests/test_torch_shardmap.py``);
* both round constructors against ``jax.jit`` of the reference's, bit
  for bit, with a FedAvg mean that lands next to .5, where ``sum / n``
  and XLA's ``sum · f32(1/n)`` round apart;
* ``clustered_mean``, ``ensure_server_state``, the ``Strategy``
  protocol, ``booleanize``, ``Pipeline``, ``REAL_DATASETS``, the
  tracer's ``NULL`` and the checkpoints' ``MANIFEST_NAME`` against the
  reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federation as jfederation
from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.data.ingest import encode as jencode
from repro.data.ingest import registry as jregistry
from repro.fl import masked_collectives as jmc
from repro.fl.obs import tracer as jtracer
from repro.fl.runtime import checkpointing as jcheckpointing
from repro.fl.runtime import strategy as jstrategy
from repro.launch import fed_train as jfed_train
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import federation, tm
from repro_torch.data import partition, synthetic
from repro_torch.data.ingest import encode, registry
from repro_torch.fl import masked_collectives
from repro_torch.fl.obs import tracer
from repro_torch.fl.runtime import RuntimeConfig, checkpointing, strategy
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401

TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)
SPLIT = dict(experiment=5, n_train=24, n_test=12, n_conf=12)
CASES = {"j1": {}, "j2": dict(top_classes=2),
         "threshold": dict(top_classes=2, conf_threshold=5.0)}


def _data(n_clients=6):
    x, y, _ = synthetic.make_dataset("synthmnist", 600, tr.PRNGKey(0, "cpu"),
                                     side=12)
    return partition.partition(x, y, 10, key=tr.PRNGKey(1, "cpu"),
                               n_clients=n_clients, **SPLIT)


def _jax_data(n_clients=6):
    x, y, _ = jsynthetic.make_dataset("synthmnist", 600,
                                      jax.random.PRNGKey(0), side=12)
    return jpartition.partition(x, y, 10, key=jax.random.PRNGKey(1),
                                n_clients=n_clients, **SPLIT)


def _bits(a):
    a = np.ascontiguousarray(convert.to_numpy(a) if isinstance(
        a, torch.Tensor) else np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


BYTES = ("upload_bytes", "download_bytes_broadcast",
         "download_bytes_per_client")


def _same_metrics(a, b, same_bytes=True):
    for f in ("per_client_accuracy", "assignment", "cluster_counts"):
        _same(getattr(a, f), getattr(b, f), f)
    for f in BYTES:
        if same_bytes:
            assert getattr(a, f) == getattr(b, f), f
        else:
            assert getattr(a, f) >= getattr(b, f), f
    assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) <= 1e-6


def _same_state(a, b):
    _same(a.client_params.ta_state, b.client_params.ta_state, "ta_state")
    _same(a.client_params.weights, b.client_params.weights, "weights")
    _same(a.cluster_weights, b.cluster_weights, "cluster_weights")


def _legacy_loop(pkg, data, tm_cfg, fed, key, rnd):
    """``init_state`` from k_init, round r keyed ``fold_in(k_rounds, r)``:
    the key chain ``run`` gives the engine."""
    k_init, k_rounds = rnd.split(key)
    st = pkg.init_state(tm_cfg, fed, k_init)
    hist = []
    for r in range(fed.rounds):
        st, m = pkg.run_round(st, data, rnd.fold_in(k_rounds, r), tm_cfg,
                              fed)
        hist.append(m)
    return st, hist


@pytest.fixture(scope="module")
def port_runs():
    """The port's legacy loop and ``run`` for each case (shared by the
    tests against JAX and against the engine)."""
    data = _data()
    out = {}
    for name, kw in CASES.items():
        fed = federation.FedConfig(n_clients=6, rounds=2, local_epochs=1,
                                   **kw)
        key = tr.PRNGKey(0, "cpu")
        out[name] = (_legacy_loop(federation, data, tm.TMConfig(**TM), fed,
                                  key, _TorchKeys),
                     federation.run(data, tm.TMConfig(**TM), fed, key))
    return out


class _TorchKeys:
    split = staticmethod(lambda k: tr.split(k).unbind(0))
    fold_in = staticmethod(tr.fold_in)


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_loop_bit_identical_to_jax(port_runs, case):
    fed = jfederation.FedConfig(n_clients=6, rounds=2, local_epochs=1,
                                **CASES[case])
    want_st, want = _legacy_loop(jfederation, _jax_data(),
                                 jtm.TMConfig(**TM), fed,
                                 jax.random.PRNGKey(0), jax.random)
    (got_st, got), _ = port_runs[case]
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        _same_metrics(a, b)
    _same_state(want_st, got_st)
    if case == "threshold":          # the gate masked some slots, not all
        flat = np.concatenate([convert.to_numpy(m.assignment).ravel()
                               for m in got])
        assert (flat == -1).any() and (flat >= 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_equals_the_legacy_loop(port_runs, case):
    """Bit for bit; under the confidence gate the engine meters only the
    frames it sends (the legacy arithmetic counts every slot), as in the
    reference."""
    (st, hist), (end, run_hist) = port_runs[case]
    assert len(run_hist) == len(hist)
    for a, b in zip(hist, run_hist):
        _same_metrics(a, b, same_bytes=case != "threshold")
        _same(a.mean_accuracy, b.mean_accuracy, "mean_accuracy")
    _same_state(st, end)


def test_fed_config_and_run_overrides():
    fed = federation.FedConfig(bytes_per_weight=2)
    assert dataclasses.asdict(fed) == dataclasses.asdict(
        jfederation.FedConfig(bytes_per_weight=2))
    # fed_cfg.rounds wins over the runtime config's round count
    data = _data()
    fed = federation.FedConfig(n_clients=6, rounds=1, local_epochs=1)
    _, hist = federation.run(data, tm.TMConfig(**TM), fed,
                             tr.PRNGKey(0, "cpu"), RuntimeConfig(rounds=5))
    assert len(hist) == 1
    hist = hist * 3
    assert federation.total_comm_mb(hist) == jfederation.total_comm_mb(hist)
    assert federation.total_comm_mb(hist)[0] == pytest.approx(
        3 * 6 * (16 * 4 + 4) / 1e6)


def test_bytes_per_weight_scales_the_accounting():
    data = _data()
    tm_cfg = tm.TMConfig(**TM)
    key = tr.PRNGKey(0, "cpu")
    out = {}
    for bpw in (4, 2):
        fed = federation.FedConfig(n_clients=6, rounds=1, local_epochs=1,
                                   bytes_per_weight=bpw)
        st = federation.init_state(tm_cfg, fed, key)
        out[bpw] = federation.run_round(st, data, key, tm_cfg, fed)[1]
    assert out[2].upload_bytes == 6 * (16 * 2 + 4)
    assert out[2].download_bytes_per_client * 2 == \
        out[4].download_bytes_per_client


# -- the round constructors against jax.jit of the reference's ------------

def _jax_params(params):
    return jtm.TMParams(*(jnp.asarray(convert.to_numpy(a)) for a in params))


@pytest.mark.parametrize("case", ["j1", "threshold"])
def test_make_tpfl_round_equals_jitted_reference(case):
    fed_kw = dict(n_clients=6, rounds=1, local_epochs=1, **CASES[case])
    tm_cfg, jtm_cfg = tm.TMConfig(**TM), jtm.TMConfig(**TM)
    state = federation.init_state(tm_cfg, federation.FedConfig(**fed_kw),
                                  tr.PRNGKey(4, "cpu"))
    cw = torch.arange(160, dtype=torch.float32).reshape(10, 16) / 8
    key = tr.PRNGKey(5, "cpu")
    got = fed_train.make_tpfl_round(tm_cfg, federation.FedConfig(**fed_kw))(
        state.client_params, cw, _data(), key)
    want = jax.jit(jfed_train.make_tpfl_round(
        jtm_cfg, jfederation.FedConfig(**fed_kw)))(
        _jax_params(state.client_params), jnp.asarray(cw.numpy()),
        _jax_data(), jax.random.PRNGKey(5))
    for a, b, f in zip(want[0], got[0], ("ta_state", "weights")):
        _same(a, b, f)
    _same(want[1], got[1], "cluster_weights")
    assert set(got[2]) == set(want[2])
    for f in ("assignment", "cluster_counts"):
        _same(want[2][f], got[2][f], f)
    assert abs(float(want[2]["mean_accuracy"])
               - float(got[2]["mean_accuracy"])) <= 1e-6
    # the round is the legacy run_round's, state for state
    st, m = federation.run_round(
        federation.TPFLState(state.client_params, cw), _data(), key,
        tm_cfg, federation.FedConfig(**fed_kw))
    _same(st.client_params.weights, got[0].weights)
    _same(st.cluster_weights, got[1])
    _same(m.mean_accuracy, got[2]["mean_accuracy"])


def _fedavg_both(params, n_clients, epochs, key_seed=6):
    fed_kw = dict(n_clients=n_clients, rounds=1, local_epochs=epochs)
    got = fed_train.make_fedavg_tm_round(
        tm.TMConfig(**TM), federation.FedConfig(**fed_kw))(
        params, _data(n_clients), tr.PRNGKey(key_seed, "cpu"))
    want = jax.jit(jfed_train.make_fedavg_tm_round(
        jtm.TMConfig(**TM), jfederation.FedConfig(**fed_kw)))(
        _jax_params(params), _jax_data(n_clients),
        jax.random.PRNGKey(key_seed))
    for a, b, f in zip(want[0], got[0], ("ta_state", "weights")):
        _same(a, b, f)
    assert abs(float(want[1]["mean_accuracy"])
               - float(got[1]["mean_accuracy"])) <= 1e-6
    return got


def test_make_fedavg_tm_round_equals_jitted_reference():
    params = federation.init_state(
        tm.TMConfig(**TM), federation.FedConfig(n_clients=6),
        tr.PRNGKey(4, "cpu")).client_params
    got, _ = _fedavg_both(params, 6, epochs=1)
    # every client holds the one rounded mean
    assert all(bool((a == a[:1]).all()) for a in got)


def test_fedavg_mean_next_to_half_rounds_as_xla():
    """Seven clients whose state sums to 6,291,456 in one entry: the mean
    898779.43 is one float32 step from .5, where ``sum / 7`` rounds to
    898779.4375 (→ 898779) and XLA's ``sum · f32(1/7)`` to 898779.5
    (→ 898780, half to even).  No local epoch, so the sums are the
    inputs'."""
    params = federation.init_state(
        tm.TMConfig(**TM), federation.FedConfig(n_clients=7),
        tr.PRNGKey(4, "cpu")).client_params
    ta, w = params.ta_state.clone(), params.weights.clone()
    vals = torch.tensor([898779] * 6 + [898782], dtype=torch.int32)
    ta[:, 0, 0, 0], w[:, 0, 0] = vals, vals
    total = vals.to(torch.float32).sum()
    assert int(total) == 6_291_456
    assert int(torch.round(total / 7)) == 898779        # the other form
    got, _ = _fedavg_both(tm.TMParams(ta, w), 7, epochs=0)
    assert int(got.ta_state[0, 0, 0, 0]) == int(got.weights[0, 0, 0]) \
        == 898780


# -- the names the loop and the round constructors use ---------------------

@pytest.mark.parametrize("n,m,c", [(6, 16, 10), (12, 5, 3), (5, 7, 4)])
def test_clustered_mean_bit_identical(n, m, c):
    rng = np.random.default_rng(n * m + c)
    vals = rng.normal(size=(n, m, 2)).astype(np.float32)
    assign = rng.integers(-1, c, n).astype(np.int32)
    want = jmc.clustered_mean(jnp.asarray(vals), jnp.asarray(assign), c)
    got = masked_collectives.clustered_mean(torch.from_numpy(vals),
                                            torch.from_numpy(assign), c)
    _same(want, got)


def test_ensure_server_state_and_protocol():
    slots = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = strategy.ensure_server_state(torch.from_numpy(slots))
    want = jstrategy.ensure_server_state(slots)
    assert isinstance(got, strategy.ServerState) and got.aux == want.aux
    _same(want.slots, got.slots)
    assert strategy.ensure_server_state(got) is got
    tpfl = federation._strategy(tm.TMConfig(**TM), federation.FedConfig())
    assert isinstance(tpfl, strategy.Strategy)
    assert not isinstance(object(), strategy.Strategy)


@pytest.mark.parametrize("kind", ["float", "u8_255", "u8_01", "int32"])
def test_booleanize_equals_the_reference(kind):
    rng = np.random.default_rng(7)
    x = {"float": rng.random((4, 9)).astype(np.float32),
         "u8_255": rng.integers(0, 256, (4, 9)).astype(np.uint8),
         "u8_01": rng.integers(0, 2, (4, 9)).astype(np.uint8),
         "int32": rng.integers(0, 2, (4, 9)).astype(np.int32)}[kind]
    x[0, :3] = {"float": [0.5, np.nextafter(0.5, 0), 1.0],
                "u8_255": [127, 126, 255]}.get(kind, x[0, :3])
    for threshold in (0.5, 0.3):
        want = jsynthetic.booleanize(jnp.asarray(x), threshold)
        got = synthetic.booleanize(torch.from_numpy(x), threshold)
        _same(want, got, f"{kind} {threshold}")


def test_pipeline_over_the_encoders():
    rng = np.random.default_rng(8)
    pool = rng.random((40, 6)).astype(np.float32)
    x = rng.random((5, 6)).astype(np.float32)
    steps = [encode.Thermometer(3), encode.Booleanize(0.5)]
    jsteps = [jencode.Thermometer(3), jencode.Booleanize(0.5)]
    got = encode.Pipeline(tuple(steps))
    want = jencode.Pipeline(tuple(jsteps))
    assert got.out_features(6) == want.out_features(6) == 18
    _same(want(jnp.asarray(x)), got(torch.from_numpy(x)))
    q = encode.Pipeline((encode.Quantile.fit(torch.from_numpy(pool), 2),))
    jq = jencode.Pipeline((jencode.Quantile.fit(jnp.asarray(pool), 2),))
    _same(jq(jnp.asarray(x)), q(torch.from_numpy(x)))


def test_constants_equal_the_references():
    assert registry.REAL_DATASETS == jregistry.REAL_DATASETS
    assert set(registry.REAL_DATASETS) | set(registry.SYNTH_DATASETS) == \
        set(registry.names())
    assert checkpointing.MANIFEST_NAME == jcheckpointing.MANIFEST_NAME
    assert isinstance(tracer.NULL, tracer.NullTracer)
    assert type(jtracer.NULL).__name__ == type(tracer.NULL).__name__
    assert tracer.NULL.enabled is False
    with tracer.NULL.span("x"):
        tracer.NULL.fence(torch.zeros(1))
