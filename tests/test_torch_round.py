"""2-round TPFL and FedTM federations on the JAX engine (sync, in
process, ``tm_backend="ref"``) and on the port, each on the ClientData
its own partition draws from the same seeds, at full and partial
participation
(uniform, weighted and round-robin sampling, dropout, stragglers) and
on every wire codec (int8 / int4, sparse delta with ``<u2`` or
varint+RLE indices, error feedback): reports, byte totals and final
state (the wire's reference and residual lanes included) are
bit-identical, and so are resumes from either package's checkpoints.

``mean_accuracy`` is compared within 1e-6: it is a float32 mean over the
clients whose summation order XLA and torch choose independently; every
other float (per-client accuracy, server rows) is held bit for bit."""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import SchedulerConfig as JSchedulerConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro.fl.runtime.strategy import FedTMStrategy as JFedTMStrategy
from repro.launch import fed_train as jfed_train
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                    RuntimeConfig, SchedulerConfig,
                                    TPFLStrategy, checkpointing)
from repro_torch.fl.runtime import codec as tcodec
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401

TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)


SPLIT = dict(n_clients=6, experiment=5, n_train=24, n_test=12, n_conf=12)


def _engines(rounds, strategy="tpfl", sched=None, wire=None, ckpt=None,
             tm_backend="ref", **strategy_kw):
    """The JAX engine and the port's engine, each over the population
    its own package draws from pool seed 0 and partition seed 1 (the
    same bits, pool shares ``sizes`` included: tests/test_torch_data.py),
    with the same strategy, scheduler and codec settings (``ckpt``: the
    JAX engine checkpoints there after every round)."""
    x, y, _ = synthetic.make_dataset("synthmnist", 600, tr.PRNGKey(0, "cpu"),
                                     side=12)
    data = partition.partition(x, y, 10, key=tr.PRNGKey(1, "cpu"), **SPLIT)
    jx, jy, _ = jsynthetic.make_dataset("synthmnist", 600,
                                        jax.random.PRNGKey(0), side=12)
    jdata = jpartition.partition(jx, jy, 10, key=jax.random.PRNGKey(1),
                                 **SPLIT)
    if strategy == "fedtm":
        jstrat = JFedTMStrategy(jtm.TMConfig(**TM), local_epochs=2)
        tstrat = FedTMStrategy(ttm.TMConfig(**TM), local_epochs=2)
    else:
        jstrat = JTPFLStrategy(jtm.TMConfig(**TM), local_epochs=2,
                               **strategy_kw)
        tstrat = TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2,
                              **strategy_kw)
    sched, wire = sched or {}, wire or {}
    jeng = JEngine(jstrat, jdata, JRuntimeConfig(
        rounds=rounds, scheduler=JSchedulerConfig(**sched),
        codec=JCodecConfig(**wire), tm_backend=tm_backend,
        checkpoint_dir=ckpt, checkpoint_every=1 if ckpt else 0))
    teng = Engine(tstrat, data, RuntimeConfig(
        rounds=rounds, scheduler=SchedulerConfig(**sched),
        codec=CodecConfig(**wire), tm_backend=tm_backend))
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


def _same_reports(jreps, treps):
    assert len(jreps) == len(treps)
    for a, b in zip(jreps, treps):
        assert a.round_idx == b.round_idx
        for f in ("assignment", "cluster_counts", "per_client_accuracy"):
            _same(getattr(a, f), getattr(b, f))
        for f in ("upload_bytes", "download_bytes_broadcast",
                  "download_bytes_per_client", "aggregated_uploads"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) <= 1e-6
        for f in ("idx", "active", "staleness"):
            _same(getattr(a.participation, f), getattr(b.participation, f))


def _same_state(jstate, tstate):
    assert int(jstate.round_idx) == int(tstate.round_idx)
    _same(jstate.client_state.ta_state, tstate.client_state.ta_state)
    _same(jstate.client_state.weights, tstate.client_state.weights)
    _same(jstate.server.slots, tstate.server.slots)
    for lane in ("ref_vecs", "ref_round", "ef_residual"):
        _same(getattr(jstate, lane), getattr(tstate, lane))


def test_reports_bit_identical(both_runs):
    _, jreps, _, treps, _, _ = both_runs
    assert len(jreps) == 2
    _same_reports(jreps, treps)


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
    dict(backend="shardmap"), dict(transport="socket")])
def test_unsupported_runtime_configs_raise(kw):
    """The reference's other runtime settings are not accepted at all:
    a config written for them fails, it does not run in process (async
    aggregation runs since its slice: tests/test_torch_async.py;
    ``tm_backend`` names since the LEAF slice:
    ``test_tm_backend_names_the_ports_one_route``; the mmap client store
    since its slice: tests/test_torch_store.py)."""
    with pytest.raises(TypeError):
        RuntimeConfig(rounds=1, **kw)


@pytest.mark.parametrize("name", ["ref", "pallas"])
def test_tm_backend_names_the_ports_one_route(name):
    """``tm_backend`` takes the reference's two names, which the
    reference pins bit-identical (``ref``: jnp; ``pallas``: the fused
    kernels, in interpret mode on the CPU); under either the port runs
    its one route, and a round equals the JAX engine's under that name
    bit for bit.  An unknown name raises ``ValueError`` in both."""
    jeng, teng = _engines(rounds=1, tm_backend=name)
    assert teng.cfg.tm_backend == name
    jstate, jreps = jeng.run(jax.random.PRNGKey(7))
    tstate, treps = teng.run(convert.key_from_numpy(jax.random.PRNGKey(7),
                                                    "cpu"))
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    with pytest.raises(ValueError, match="unknown tm_backend"):
        RuntimeConfig(rounds=1, tm_backend="cuda")
    with pytest.raises(ValueError, match="unknown tm_backend"):
        JRuntimeConfig(rounds=1, tm_backend="cuda")


def test_async_codecs_and_other_strategies_are_a_later_slice(capsys):
    """The CLI has no flag for what the port does not run yet, and an
    object without the cohort hooks is refused by the engine, naming
    them (every strategy of the reference runs since the baselines'
    slice: tests/test_torch_baselines*.py; ``--mode async`` since the
    async slice: tests/test_torch_async.py; ``--client-store`` since the
    store's slice: tests/test_torch_leaf.py)."""
    for flags in (["--transport", "socket"],):
        with pytest.raises(SystemExit) as exc:
            fed_train.main(["--device", "cpu", *flags])
        assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
    x, y, _ = synthetic.make_dataset("synthmnist", 200, tr.PRNGKey(0, "cpu"),
                                     side=12)
    data = partition.partition(x, y, 10, n_clients=4, experiment=1,
                               key=tr.PRNGKey(1, "cpu"), n_train=4, n_test=4,
                               n_conf=4)
    with pytest.raises(TypeError, match="lacks the cohort hook"):
        Engine(object(), data, RuntimeConfig(rounds=1))


# -- partial participation, sampling, dropout, stragglers; FedTM ----------

SCHEDULES = {
    "uniform_dropout": dict(participation=0.5, dropout=0.3),
    "weighted_stragglers": dict(participation=0.5, sampling="weighted",
                                straggler=0.4),
    "round_robin_both": dict(participation=0.5, sampling="round_robin",
                             dropout=0.2, straggler=0.3, max_staleness=3),
    # every sampled upload arrives: the merge back is skipped
    "weighted_all_arrive": dict(participation=0.5, sampling="weighted"),
    # the whole population in order, nothing gathered, with drops merged
    "full_dropout": dict(dropout=0.3),
}
STRATEGIES = {"tpfl": ("tpfl", {}),
              "tpfl_thresh": ("tpfl", dict(conf_threshold=2.0)),
              "fedtm": ("fedtm", {})}


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partial_participation_round_bit_identical(strategy, sched):
    """K of 6 clients a round (3 at participation 0.5): the sampled
    ids, dropout and staleness draws, the gathered cohort's training,
    the arrival-masked aggregation, the merge that keeps non-receivers'
    state, the scatter and the population's evaluation all equal the
    reference's."""
    name, kw = STRATEGIES[strategy]
    cfg = SCHEDULES[sched]
    jeng, teng = _engines(rounds=2, strategy=name, sched=cfg, **kw)
    key = jax.random.PRNGKey(3)
    jstate, jreps = jeng.run(key)
    tstate, treps = teng.run(convert.key_from_numpy(key, "cpu"))
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    # the draw exercised what the case names
    parts = [r.participation for r in treps]
    k = round(cfg.get("participation", 1.0) * 6)
    assert all(p.idx.numel() == k for p in parts)
    if cfg.get("dropout"):
        assert any(not bool(p.active.all()) for p in parts)
    if cfg.get("straggler"):
        assert any(bool((p.staleness > 0).any()) for p in parts)
    # clients outside the cohort keep −1 and are still evaluated
    assert all(int((r.assignment[:, 0] >= 0).sum()) <= k for r in treps)
    assert all(r.per_client_accuracy.shape == (6,) for r in treps)


def test_partial_participation_resumes_bit_for_bit(tmp_path):
    """A checkpoint after round 1 at participation 0.5 restores into a
    run whose round 2 equals the uninterrupted run's."""
    sched = dict(participation=0.5, dropout=0.3, straggler=0.3)
    _, teng = _engines(rounds=2, sched=sched)
    key = convert.key_from_numpy(jax.random.PRNGKey(3), "cpu")
    full, full_reps = teng.run(key)
    _, ceng = _engines(rounds=1, sched=sched)
    ceng = Engine(ceng.strategy, ceng.data, dataclasses.replace(
        ceng.cfg, checkpoint_dir=str(tmp_path), checkpoint_every=1))
    ceng.run(key)
    like = ceng.init(convert.key_from_numpy(jax.random.PRNGKey(0), "cpu"))
    resumed = checkpointing.restore(checkpointing.latest(tmp_path), like)
    assert int(resumed.round_idx) == 1
    state, (rep,) = teng.run(key, state=resumed, rounds=1)
    _same_reports(convert.to_numpy(full_reps[1:]), [rep])
    for a, b in zip((*full.client_state, full.server.slots),
                    (*state.client_state, state.server.slots)):
        assert torch.equal(a, b)


def test_fed_train_cli_scheduler_flags(capsys):
    """--strategy fedtm --active K --sampling weighted --dropout
    --straggler: the banner, one round line a round with
    active=<survivors>/K, and upload bytes metered over the survivors."""
    out = fed_train.main([
        "--device", "cpu", "--clients", "6", "--rounds", "2", "--clauses",
        "8", "--local-epochs", "1", "--strategy", "fedtm", "--active", "3",
        "--sampling", "weighted", "--dropout", "0.3", "--straggler", "0.3",
        "--max-staleness", "3"])
    text = capsys.readouterr().out
    assert text.startswith("fedtm on synthmnist")
    assert "K=3/round" in text and "weighted sampling from partition" in text
    d = 10 * 8                                  # FedTM: C·m floats a frame
    for rep in out["reports"]:
        n_active = int(rep.participation.active.sum())
        assert f"active={n_active}/3" in text
        assert rep.upload_bytes == n_active * (4 + 4 * d)
        arrive = rep.participation.active & (rep.participation.staleness == 0)
        assert rep.aggregated_uploads == int(arrive.sum())
    with pytest.raises(SystemExit, match="--active must be in"):
        fed_train.main(["--device", "cpu", "--clients", "4", "--active",
                        "5"])
    with pytest.raises(ValueError, match="participation"):
        fed_train.main(["--device", "cpu", "--participation", "0"])


CLI_FLAGS = {
    "tpfl": ["--clients", "6", "--rounds", "2", "--clauses", "16",
             "--local-epochs", "1"],
    "fedtm_weighted": ["--clients", "6", "--rounds", "2", "--clauses", "8",
                       "--local-epochs", "1", "--strategy", "fedtm",
                       "--active", "3", "--sampling", "weighted",
                       "--dropout", "0.2", "--straggler", "0.3",
                       "--max-staleness", "3", "--seed", "4",
                       "--experiment", "3"],
    "tpfl_tm_backend_pallas": ["--clients", "4", "--rounds", "2",
                               "--clauses", "8", "--local-epochs", "1",
                               "--tm-backend", "pallas"],
    "tpfl_int8_sparse_vrle_ef": [
        "--clients", "6", "--rounds", "2", "--clauses", "16",
        "--local-epochs", "1", "--codec", "int8", "--sparse",
        "--index-coding", "vrle", "--error-feedback"],
    "fedtm_int4_ef_partial": [
        "--clients", "6", "--rounds", "2", "--clauses", "8",
        "--local-epochs", "1", "--strategy", "fedtm", "--active", "3",
        "--dropout", "0.2", "--straggler", "0.3", "--codec", "int4",
        "--error-feedback"],
}


def _report_lines(text: str) -> list[str]:
    """The round lines without their mean accuracy, the totals line,
    the weighted-sampling banner and the final deciles."""
    keep = ("round ", "totals:", "weighted sampling", "final per-client")
    return [re.sub(r" acc=\S+", "", line) for line in text.splitlines()
            if line.startswith(keep)]


@pytest.mark.parametrize("case", CLI_FLAGS)
def test_fed_train_cli_prints_the_reference_lines(case, capsys):
    """The two CLIs, given the same flags, each draw their own pool and
    partition and print the same round, totals, sampling and decile
    lines; the mean accuracy is held within 1e-6 (queue C item 3)."""
    flags = CLI_FLAGS[case]
    ours = fed_train.main(["--device", "cpu", *flags])
    port_text = capsys.readouterr().out
    ref = jfed_train.main(flags)
    ref_text = capsys.readouterr().out
    assert _report_lines(port_text) == _report_lines(ref_text)
    assert len(_report_lines(port_text)) == 2 + 2 + ("weighted" in case)
    np.testing.assert_allclose(ours["acc_per_round"], ref["acc_per_round"],
                               rtol=0, atol=1e-6)
    for key in ("upload_bytes", "download_bytes_broadcast",
                "download_bytes_per_client"):
        assert ours[key] == ref[key]


# -- the lossy wire ---------------------------------------------------------

WIRES = {
    "int8": dict(name="int8"),
    "int4": dict(name="int4"),
    "f32_sparse": dict(name="float32", sparse=True),
    "int8_sparse": dict(name="int8", sparse=True),
    "int8_sparse_vrle_ef": dict(name="int8", sparse=True,
                                index_coding="vrle", error_feedback=True),
    "int4_ef": dict(name="int4", error_feedback=True),
}
PARTICIPATION = {
    "full": {},
    "partial": dict(participation=0.5, dropout=0.2, straggler=0.3,
                    max_staleness=3),
}


@pytest.mark.parametrize("sched", PARTICIPATION)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("strategy", ["tpfl", "fedtm"])
def test_lossy_wire_round_bit_identical(strategy, wire, sched):
    """Two rounds on the wire: every report field (metered bytes
    included), the client weights and TA states, the server slots and the
    ``ref_vecs`` / ``ref_round`` / ``ef_residual`` lanes equal the JAX
    engine's; ``mean_accuracy`` within 1e-6."""
    jeng, teng = _engines(rounds=2, strategy=strategy,
                          sched=PARTICIPATION[sched], wire=WIRES[wire])
    key = jax.random.PRNGKey(3)
    jstate, jreps = jeng.run(key)
    tstate, treps = teng.run(convert.key_from_numpy(key, "cpu"))
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    cfg = WIRES[wire]
    if cfg.get("sparse"):
        assert int((tstate.ref_round >= 0).sum()) > 0
    else:
        assert tstate.ref_vecs.shape == (0, 0, 0)
    if cfg.get("error_feedback"):
        assert bool((tstate.ef_residual != 0).any())
    else:
        assert tstate.ef_residual.shape == (0, 0, 0)
    if cfg["name"] != "float32":   # a lossy downlink: non-integer rows
        server = tstate.server.slots
        assert bool((server != torch.round(server)).any())


def test_lossy_resume_bit_identical(tmp_path):
    """A sparse + error-feedback run checkpointed after round 1 and
    resumed (the broadcast cache empty, recomputed from the restored
    rows) equals the uninterrupted run, lanes included."""
    wire = dict(name="int8", sparse=True, error_feedback=True)
    sched = dict(participation=0.5, dropout=0.2, straggler=0.3)
    _, teng = _engines(rounds=3, sched=sched, wire=wire)
    key = convert.key_from_numpy(jax.random.PRNGKey(3), "cpu")
    full, full_reps = teng.run(key)
    _, ceng = _engines(rounds=1, sched=sched, wire=wire)
    ceng = Engine(ceng.strategy, ceng.data, dataclasses.replace(
        ceng.cfg, checkpoint_dir=str(tmp_path), checkpoint_every=1))
    ceng.run(key)
    _, reng = _engines(rounds=2, sched=sched, wire=wire)
    like = reng.init(convert.key_from_numpy(jax.random.PRNGKey(0), "cpu"))
    resumed = checkpointing.restore(checkpointing.latest(tmp_path), like)
    assert int(resumed.round_idx) == 1 and reng._tx_cache is None
    state, reps = reng.run(key, state=resumed)
    _same_reports(convert.to_numpy(full_reps[1:]), reps)
    for a, b in zip((*full.client_state, full.server.slots, full.ref_vecs,
                     full.ref_round, full.ef_residual),
                    (*state.client_state, state.server.slots, state.ref_vecs,
                     state.ref_round, state.ef_residual)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("strategy", ["tpfl", "fedtm"])
def test_port_resumes_a_jax_lossy_checkpoint(strategy, tmp_path):
    """The JAX engine's checkpoint after round 1 (int4, sparse with vrle
    indices, error feedback, partial participation) restores into the
    port with its ``ref_vecs`` / ``ref_round`` / ``ef_residual``, and the
    port's round 2 equals the JAX engine's; so does a start from the JAX
    state handed over with ``convert.engine_state_from_numpy``."""
    wire = dict(name="int4", sparse=True, index_coding="vrle",
                error_feedback=True)
    sched = dict(participation=0.5, dropout=0.2)
    jeng, teng = _engines(rounds=2, strategy=strategy, sched=sched,
                          wire=wire, ckpt=str(tmp_path))
    key = jax.random.PRNGKey(3)
    jeng.run(key, rounds=1)
    ck = tmp_path / "round_000001.msgpack"
    like = teng.init(convert.key_from_numpy(jax.random.PRNGKey(0), "cpu"))
    restored = checkpointing.restore(ck, like)
    assert bool((restored.ef_residual != 0).any())
    assert int((restored.ref_round == 0).sum()) > 0
    jstate1 = jeng.init(jax.random.PRNGKey(0))
    from repro.fl.runtime import checkpointing as jcheckpointing
    jstate1 = jcheckpointing.restore(ck, jstate1)
    _same_state(jstate1, restored)
    handed = convert.engine_state_from_numpy(
        *(np.asarray(a) for a in (jstate1.round_idx,
                                  jstate1.client_state.ta_state,
                                  jstate1.client_state.weights,
                                  jstate1.server.slots)), device="cpu",
        ref_vecs=np.asarray(jstate1.ref_vecs),
        ref_round=np.asarray(jstate1.ref_round),
        ef_residual=np.asarray(jstate1.ef_residual))
    jstate2, jreps = jeng.run(key, state=jstate1, rounds=1)
    for start in (restored, handed):
        tstate2, treps = teng.run(convert.key_from_numpy(key, "cpu"),
                                  state=start, rounds=1)
        _same_reports(jreps, treps)
        _same_state(jstate2, tstate2)


@pytest.mark.parametrize("wire", [dict(name="float32"), dict(name="int8"),
                                  dict(name="int8", sparse=True),
                                  dict(name="int4", sparse=True,
                                       index_coding="vrle")])
def test_engine_metered_bytes_equal_reencoded_buffer_lengths(wire):
    """The upload meter is Σ (4-byte slot id + len(frame)) of the frames
    the codec writes for the wire-visible uploads, sparse ones against
    each client's tracked (all-zero, never synced) reference.  The
    port's counterpart of the reference conformance test of this name,
    whose two-value unpack of ``_wire_uplink`` predates its third
    return value, the error-feedback lane."""
    _, teng = _engines(rounds=1, wire=wire)
    state = teng.init(tr.PRNGKey(0, "cpu"))
    part = teng.scheduler.sample(0, tr.PRNGKey(1, "cpu"))
    keys = tr.split(tr.PRNGKey(1, "cpu"), teng.n)
    _, vecs, slots = teng.executor.train(
        teng.strategy, state.client_state, state.server.slots, teng.data,
        keys)
    dec, up_bytes, ef = teng._wire_uplink(state, vecs, slots, part)
    cfg = teng.cfg.codec
    expect = 0
    for c in range(teng.n):
        for j in range(slots.shape[1]):
            s = int(slots[c, j])
            if s < 0:
                continue
            ref = state.ref_vecs[c, s].numpy() if cfg.sparse else None
            expect += 4 + len(tcodec.encode(vecs[c, j].numpy(), cfg,
                                            ref=ref))
    assert up_bytes == expect > 0
    assert ef is state.ef_residual and dec.shape == vecs.shape
