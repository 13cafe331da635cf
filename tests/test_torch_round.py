"""A 2-round TPFL federation on the JAX engine (sync, in process,
``tm_backend="ref"``) and on the port, from one numpy-built ClientData
and the same seed: reports and final state are bit-identical.

``mean_accuracy`` is compared within 1e-6: it is a float32 mean over the
clients whose summation order XLA and torch choose independently; every
other float (per-client accuracy, server rows) is held bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import tm as jtm
from repro.data.partition import ClientData as JClientData
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro_torch import convert
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.runtime import Engine, RuntimeConfig, TPFLStrategy
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401

TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)


def _engines(rounds, **strategy_kw):
    """The JAX engine and the port's engine over one numpy-built
    population, with the same TPFL settings."""
    x, y, _ = synthetic.make_pool("synthmnist", 600, seed=0)
    data = partition.partition(x, y, 10, n_clients=6, experiment=5, seed=1,
                               n_train=24, n_test=12, n_conf=12, device="cpu")
    fields = convert.to_numpy(data._asdict())
    jdata = JClientData(**{k: None if v is None else jnp.asarray(v)
                           for k, v in fields.items()})
    jeng = JEngine(JTPFLStrategy(jtm.TMConfig(**TM), local_epochs=2,
                                 **strategy_kw),
                   jdata, JRuntimeConfig(rounds=rounds, tm_backend="ref"))
    teng = Engine(TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2,
                               **strategy_kw),
                  convert.client_data_from_numpy(fields, "cpu"),
                  RuntimeConfig(rounds=rounds))
    return jeng, teng


@pytest.fixture(scope="module")
def both_runs():
    jeng, teng = _engines(rounds=2)
    jstate, jreps = jeng.run(jax.random.PRNGKey(3))
    tstate, treps = teng.run(convert.key_from_numpy(jax.random.PRNGKey(3), "cpu"))
    return jstate, jreps, tstate, treps, jeng, teng


def _same(a, b):
    a, b = np.asarray(a), convert.to_numpy(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def test_reports_bit_identical(both_runs):
    _, jreps, _, treps, _, _ = both_runs
    assert len(jreps) == len(treps) == 2
    for a, b in zip(jreps, treps):
        assert a.round_idx == b.round_idx
        for f in ("assignment", "cluster_counts", "per_client_accuracy"):
            _same(getattr(a, f), getattr(b, f))
        for f in ("upload_bytes", "download_bytes_broadcast",
                  "download_bytes_per_client", "aggregated_uploads"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) <= 1e-6
        _same(a.participation.idx, b.participation.idx)


def test_final_state_bit_identical(both_runs):
    jstate, _, tstate, _, _, _ = both_runs
    assert int(jstate.round_idx) == int(tstate.round_idx) == 2
    _same(jstate.client_state.ta_state, tstate.client_state.ta_state)
    _same(jstate.client_state.weights, tstate.client_state.weights)
    _same(jstate.server.slots, tstate.server.slots)


def test_port_continues_from_the_reference_state(both_runs):
    """A third round, started from the JAX engine's state converted with
    convert.engine_state_from_numpy, matches the JAX engine's third."""
    jstate, _, _, _, jeng, teng = both_runs
    st = convert.engine_state_from_numpy(
        np.asarray(jstate.round_idx), np.asarray(jstate.client_state.ta_state),
        np.asarray(jstate.client_state.weights),
        np.asarray(jstate.server.slots), device="cpu")
    key = jax.random.PRNGKey(3)
    jstate3, (jrep,) = jeng.run(key, state=jstate, rounds=1)
    tstate3, (trep,) = teng.run(convert.key_from_numpy(key, "cpu"), state=st,
                                rounds=1)
    assert jrep.round_idx == trep.round_idx == 2
    _same(jrep.assignment, trep.assignment)
    _same(jrep.per_client_accuracy, trep.per_client_accuracy)
    _same(jstate3.client_state.ta_state, tstate3.client_state.ta_state)
    _same(jstate3.server.slots, tstate3.server.slots)


def test_multi_cluster_thresholded_round_bit_identical():
    """§7 extensions: two shared classes per client, a confidence gate
    (−1 slots ship nothing) and weighted confidence margins."""
    jeng, teng = _engines(rounds=1, top_classes=2, conf_threshold=2.0,
                          weighted_confidence=True)
    jstate, (jrep,) = jeng.run(jax.random.PRNGKey(4))
    tstate, (trep,) = teng.run(convert.key_from_numpy(jax.random.PRNGKey(4), "cpu"))
    assert (np.asarray(jrep.assignment) == -1).any()
    _same(jrep.assignment, trep.assignment)
    _same(jrep.cluster_counts, trep.cluster_counts)
    assert jrep.upload_bytes == trep.upload_bytes
    assert jrep.download_bytes_per_client == trep.download_bytes_per_client
    _same(jstate.client_state.weights, tstate.client_state.weights)
    _same(jstate.server.slots, tstate.server.slots)


def test_fed_train_cli_on_cpu(capsys):
    out = fed_train.main(["--device", "cpu", "--clients", "4", "--rounds",
                          "2", "--clauses", "8", "--local-epochs", "1"])
    text = capsys.readouterr().out
    assert text.count("round ") == 2 and "totals: upload=" in text
    assert "down_bc=" in text and "down_pc=" in text
    assert 0.0 <= out["final_accuracy"] <= 1.0
    # identity float32 wire: each shared slot costs a 4-byte id + 4·m
    assert out["upload_bytes"] == 2 * 4 * (4 + 4 * 8)


@pytest.mark.parametrize("kw", [
    dict(aggregation="async"), dict(backend="shardmap"),
    dict(client_store="mmap"), dict(transport="socket"),
    dict(codec="int8"), dict(tm_backend="pallas")])
def test_unsupported_runtime_configs_raise(kw):
    """The reference's other runtime settings are not accepted at all:
    a config written for them fails, it does not run as sync/float32."""
    with pytest.raises(TypeError):
        RuntimeConfig(rounds=1, **kw)


def test_partial_participation_is_a_later_slice(capsys):
    """The CLI has no flag for what the port does not run yet, and a
    strategy other than TPFL is refused by the engine."""
    for flags in (["--participation", "0.5"], ["--mode", "async"],
                  ["--codec", "int8"], ["--strategy", "fedtm"]):
        with pytest.raises(SystemExit) as exc:
            fed_train.main(["--device", "cpu", *flags])
        assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
    x, y, _ = synthetic.make_pool("synthmnist", 200, seed=0)
    data = partition.partition(x, y, 10, n_clients=4, experiment=1, seed=1,
                               n_train=4, n_test=4, n_conf=4, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        Engine(object(), data, RuntimeConfig(rounds=1))
