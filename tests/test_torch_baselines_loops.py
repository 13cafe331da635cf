"""The port's baseline loops, checkpoints and TPFL-for-NN against
the JAX package on the CPU, and the port's engine against its own loops.

* ``repro_torch.core.baselines`` against ``repro.core.baselines``: the
  same metered megabytes and FLIS assignments exactly, the per-round
  mean accuracy within 1e-6 (a float32 mean, queue C item 3);
* the port's engine against its own loops, as the reference's
  conformance suite pins its engine: FLIS-DC / HC and FedTM float for
  float (the same training, similarity and aggregate), FedAvg / IFCA
  within 1e-6 (the loop averages with ``tree_mean`` / the one-hot
  product, the engine in row order);
* a JAX-written checkpoint of each baseline restores into the port bit
  for bit, and the port's next round agrees with the JAX engine's;
* ``nn_federation.run`` agrees within tolerance;
* the engine's contract checks and FLIS's ``assign`` span.

The CLIs and serving: tests/test_torch_baselines_cli.py."""
import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl import nn_federation as jnn_federation
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline_strategy
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import baselines, tm
from repro_torch.data import partition, synthetic
from repro_torch.fl import nn_federation, obs
from repro_torch.fl.runtime import (Engine, FedTMStrategy, FLISStrategy,
                                    RuntimeConfig, ServerState,
                                    build_baseline_strategy, checkpointing)
from test_torch_baselines import _close_trees, _parts, _same_reports
from test_torch_gpu import one_torch_thread  # noqa: F401

SPLIT = dict(n_clients=5, experiment=5, n_train=16, n_test=12, n_conf=12)
BCFG = dict(n_clients=5, rounds=2, local_epochs=2, batch=8, n_hidden=16,
            ifca_k=3, flis_probe=16, flis_max_slots=4)
TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)


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


def _tkey(seed):
    return convert.key_from_numpy(jax.random.PRNGKey(seed), "cpu")


@pytest.mark.parametrize("name", ["fedavg", "fedprox", "ifca", "flis",
                                  "flis_hc"])
def test_loops_match_the_reference_loops(populations, name):
    jdata, data = populations
    want = jbaselines.BASELINES[name](
        jdata, jbaselines.BaselineConfig(**BCFG), jax.random.PRNGKey(2),
        144, 10)
    got = baselines.BASELINES[name](
        data, baselines.BaselineConfig(**BCFG), _tkey(2), 144, 10)
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=0,
                               atol=1e-6)
    assert (got.upload_mb, got.download_mb) == (want.upload_mb,
                                                want.download_mb)
    if want.assignments is not None:
        for a, b in zip(want.assignments, got.assignments):
            np.testing.assert_array_equal(b, a)
        assert any(len(set(a.tolist())) > 1 for a in got.assignments)


def test_fedtm_loop_matches_the_reference_loop(populations):
    jdata, data = populations
    cfg = dict(BCFG, local_epochs=1)
    want = jbaselines.run_fedtm(jdata, jtm.TMConfig(**TM),
                                jbaselines.BaselineConfig(**cfg),
                                jax.random.PRNGKey(3))
    got = baselines.run_fedtm(data, tm.TMConfig(**TM),
                              baselines.BaselineConfig(**cfg), _tkey(3))
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=0,
                               atol=1e-6)
    assert got.upload_mb == want.upload_mb


ENGINE_KW = dict(n_features=144, n_classes=10, n_hidden=16, local_epochs=2,
                 batch=8, ifca_k=3, max_slots=4, probe_size=16)


@pytest.mark.parametrize("name,loop", [
    ("flis_dc", "flis"), ("flis_hc", "flis_hc"), ("fedavg", "fedavg"),
    ("fedprox", "fedprox"), ("ifca", "ifca")])
def test_engine_matches_the_port_loops(populations, name, loop):
    """The port's engine reproduces its own straight-line loops: FLIS's
    per-round assignment and accuracy float for float, its counts the
    labelling's; FedAvg / FedProx / IFCA's accuracy within 1e-6."""
    data = populations[1]
    _, reports = Engine(build_baseline_strategy(name, **ENGINE_KW),
                        data, RuntimeConfig(rounds=2)).run(_tkey(2))
    ref = baselines.BASELINES[loop](
        data, baselines.BaselineConfig(**BCFG), _tkey(2), 144, 10)
    for r in range(2):
        if name.startswith("flis"):
            assert float(reports[r].mean_accuracy) == ref.accuracy[r]
            np.testing.assert_array_equal(
                convert.to_numpy(reports[r].assignment)[:, 0],
                ref.assignments[r])
        else:
            assert abs(float(reports[r].mean_accuracy)
                       - ref.accuracy[r]) <= 1e-6
    if name.startswith("flis"):
        counts = np.bincount(ref.assignments[-1], minlength=4)
        np.testing.assert_array_equal(
            convert.to_numpy(reports[-1].cluster_counts), counts)


def test_engine_fedtm_matches_the_port_loop(populations):
    data = populations[1]
    _, reports = Engine(FedTMStrategy(tm.TMConfig(**TM), local_epochs=1),
                        data, RuntimeConfig(rounds=2)).run(_tkey(3))
    ref = baselines.run_fedtm(data, tm.TMConfig(**TM),
                              baselines.BaselineConfig(**dict(
                                  BCFG, local_epochs=1)), _tkey(3))
    assert [float(r.mean_accuracy) for r in reports] == ref.accuracy


@pytest.mark.parametrize("name", ["fedavg", "fedprox", "ifca", "flis_dc",
                                  "flis_hc"])
def test_port_restores_and_continues_a_jax_checkpoint(populations, tmp_path,
                                                      name):
    """The JAX engine checkpoints after round 1: the port restores it bit
    for bit (FLIS's ``.client_state/.params/w1`` and ``.server/.aux``
    leaves included) and its round 2 agrees with the JAX engine's."""
    jdata, data = populations
    kw = ENGINE_KW
    jeng = JEngine(jbuild_baseline_strategy(name, **kw), jdata,
                   JRuntimeConfig(rounds=1, checkpoint_dir=str(tmp_path),
                                  checkpoint_every=1))
    key = jax.random.PRNGKey(4)
    jstate, _ = jeng.run(key)
    teng = Engine(build_baseline_strategy(name, **kw), data,
                  RuntimeConfig(rounds=1))
    like = teng.init(_tkey(0))
    state = checkpointing.restore(checkpointing.latest(tmp_path), like)
    _close_trees(_parts(jstate), _parts(state), exact_floats=True)
    jstate2, jreps = jeng.run(key, state=jstate, rounds=1)
    tstate2, treps = teng.run(convert.key_from_numpy(key, "cpu"),
                              state=state, rounds=1)
    _same_reports(jreps, treps)
    _close_trees(_parts(jstate2), _parts(tstate2))


def test_nn_federation_within_tolerance(populations):
    jdata, data = populations
    kw = dict(n_clients=5, rounds=2, n_hidden=16, batch=8)
    want = jnn_federation.run(jdata, jnn_federation.NNFedConfig(**kw),
                              jax.random.PRNGKey(2), n_features=144,
                              n_classes=10)
    got = nn_federation.run(data, nn_federation.NNFedConfig(**kw), _tkey(2),
                            n_features=144, n_classes=10)
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(convert.to_numpy(got.assignments),
                                  np.asarray(want.assignments))
    assert got.upload_bytes_per_client_round == \
        want.upload_bytes_per_client_round


def test_flis_assign_span_and_telemetry_change_nothing(populations,
                                                        tmp_path):
    """FLIS's server-side stage is recorded as its own ``assign`` span;
    telemetry on equals off bit for bit."""
    data = populations[1]
    strat = build_baseline_strategy("flis_dc", **ENGINE_KW)
    runs = []
    for telemetry in (None, obs.RunRecorder(run_dir=str(tmp_path))):
        eng = Engine(strat, data, RuntimeConfig(rounds=1),
                     telemetry=telemetry)
        if telemetry is not None:
            telemetry.start(obs.build_manifest(
                config=eng.cfg, seed=0, device=torch.device("cpu")))
        state, _ = eng.run(_tkey(6))
        if telemetry is not None:
            telemetry.close()
        runs.append(state)
    _close_trees(_parts(runs[0]), _parts(runs[1]), exact_floats=True)
    (event,) = obs.read_events(tmp_path / "events.jsonl")
    assert {"uplink_codec", "assign", "aggregate",
            "server_update"} <= set(event["phases"])
    assert event["phases"]["assign"] > 0


def test_strategy_contract_errors(populations):
    """A strategy without the cohort hooks, or with an unknown download
    mode, is refused; FLIS refuses an init without data, a probe larger
    than the pooled confidence split and an unknown linkage."""
    data = populations[1]
    with pytest.raises(TypeError, match="lacks the cohort hook"):
        Engine(object(), data, RuntimeConfig(rounds=1))

    class Odd(FedTMStrategy):
        downloads = "broadcast"

    with pytest.raises(ValueError, match="downloads must be one of"):
        Engine(Odd(tm.TMConfig(**TM)), data, RuntimeConfig(rounds=1))
    flis = FLISStrategy(n_features=144, n_hidden=16, n_classes=10,
                        probe_size=61)
    with pytest.raises(ValueError, match="needs the engine's ClientData"):
        flis.init(_tkey(0), 5)
    with pytest.raises(ValueError, match="probe_size=61 exceeds"):
        flis.init(_tkey(0), 5, data)
    with pytest.raises(ValueError, match="unknown FLIS linkage"):
        FLISStrategy(n_features=144, n_hidden=16, n_classes=10,
                     linkage="ward")
    with pytest.raises(ValueError, match="unknown baseline strategy"):
        build_baseline_strategy("fedsgd", n_features=144, n_classes=10)
    # the server aux defaults to no leaves: TM checkpoints keep theirs
    assert ServerState(torch.zeros(1, 2)).aux == ()
