"""The port's serving plane and checkpoints against the JAX package's.

* the msgpack subset the port writes is byte-identical to
  ``msgpack.packb``, and the port restores a checkpoint the JAX engine
  wrote;
* the registry refuses every tamper mode ``tests/test_serve.py`` pins
  (corrupted payload, flipped or missing sidecar, missing version,
  immutable versions, layout drift naming the leaf);
* the warm swap is atomic under an in-flight request, and refresh never
  downgrades;
* served == offline in the port, and the port's plane on a JAX-trained
  checkpoint returns the JAX plane's predictions;
* ``fed_train --ckpt-every 1`` then ``--resume`` equals the
  uninterrupted run, and ``fed_serve --device cpu --verify-offline``
  passes on a port-trained run, TPFL or FedTM (``--strategy fedtm``),
  on the synthetic pool or through ``--data-dir`` and ``--encoding``;
  the port's plane on a JAX-trained FedTM checkpoint returns the JAX
  plane's predictions.
"""
import json

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro.fl.runtime.strategy import FedTMStrategy as JFedTMStrategy
from repro.fl.runtime import checkpointing as jcheckpointing
from repro.fl.serve import ModelRegistry as JModelRegistry
from repro.fl.serve import ServingPlane as JServingPlane
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.checkpoint import ckpt
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.runtime import (Engine, FedTMStrategy, RuntimeConfig,
                                    TPFLStrategy, checkpointing)
from repro_torch.fl.serve import (ChecksumError, ModelRegistry,
                                  RegistryError, ServeTelemetry,
                                  ServingPlane)
from repro_torch.fl.serve import registry as registry_mod
from repro_torch.launch import fed_serve, fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401

TM = dict(n_classes=10, n_clauses=12, n_features=144, n_states=63, s=5.0,
          T=20)
N_CLIENTS = 6


SPLIT = dict(n_clients=N_CLIENTS, experiment=5, n_train=16, n_test=8,
             n_conf=8)


@pytest.fixture(scope="module")
def fields():
    """The port's population, as ClientData field arrays."""
    x, y, _ = synthetic.make_dataset("synthmnist", 600, tr.PRNGKey(0, "cpu"),
                                     side=12)
    data = partition.partition(x, y, 10, key=tr.PRNGKey(1, "cpu"), **SPLIT)
    return convert.to_numpy(data._asdict())


@pytest.fixture(scope="module")
def jdata():
    """The reference's own population from the same seeds (the same
    bits as ``fields``: tests/test_torch_data.py)."""
    jx, jy, _ = jsynthetic.make_dataset("synthmnist", 600,
                                        jax.random.PRNGKey(0), side=12)
    return jpartition.partition(jx, jy, 10, key=jax.random.PRNGKey(1),
                                **SPLIT)


def _engine(fields, cfg=None, **tm_kw):
    strategy = TPFLStrategy(ttm.TMConfig(**{**TM, **tm_kw}), local_epochs=1)
    return Engine(strategy, convert.client_data_from_numpy(fields, "cpu"),
                  cfg or RuntimeConfig())


def _like(engine):
    """The serving template, keyed with the training chain's k_init."""
    return engine.init(tr.split(tr.PRNGKey(0, "cpu"))[0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory, fields):
    """Two port rounds with a checkpoint at round 2."""
    d = tmp_path_factory.mktemp("ckpt")
    engine = _engine(fields, RuntimeConfig(rounds=2, checkpoint_dir=str(d),
                                           checkpoint_every=2))
    state, _ = engine.run(tr.PRNGKey(0, "cpu"))
    return {"ckpt_dir": d, "state": state}


def _fresh_registry(tmp_path, trained) -> ModelRegistry:
    reg = ModelRegistry(tmp_path / "registry")
    reg.publish(checkpointing.latest(trained["ckpt_dir"]))
    return reg


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    {},
    {"a": 1, "b": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32]},
    {str(i): {"dtype": "int32", "shape": [], "data": b""} for i in range(17)},
    {"k" * 40: b"\x00" * 300, "é" * 200: "x" * 70000,
     "big": b"\xff" * 70000, "long": list(range(70000))},
], ids=["empty", "uints", "map16", "str8_bin16_bin32_array16"])
def test_msgpack_subset_bytes_equal_msgpack(payload):
    data = ckpt.packb(payload)
    assert data == msgpack.packb(payload)
    assert ckpt.unpackb(data) == msgpack.unpackb(data) == payload


def test_checkpoint_file_is_the_reference_encoding(tmp_path, trained):
    """A port checkpoint is msgpack.packb of the reference's payload for
    the same leaves, under the reference's leaf keys and in its order
    (the async buffer's six lanes after the server)."""
    path = tmp_path / "round_000002.msgpack"
    ckpt.save(path, trained["state"])
    flat = {
        ".round_idx": trained["state"].round_idx,
        ".client_state/.ta_state": trained["state"].client_state.ta_state,
        ".client_state/.weights": trained["state"].client_state.weights,
        ".server/.slots": trained["state"].server.slots,
        **{f".{lane}": getattr(trained["state"], lane)
           for lane in convert.BUF_LANES},
        ".ref_vecs": trained["state"].ref_vecs,
        ".ref_round": trained["state"].ref_round,
        ".ef_residual": trained["state"].ef_residual}
    payload = {k: {"dtype": str(v.numpy().dtype), "shape": list(v.shape),
                   "data": v.numpy().tobytes()} for k, v in flat.items()}
    assert path.read_bytes() == msgpack.packb(payload)


def test_port_restores_a_jax_checkpoint(tmp_path, fields, jdata):
    """The JAX engine's checkpoint has the port's 13 leaves; restore
    walks the port's template, and every leaf, the async buffer's (empty
    after a sync round) and the wire's (zero-size on the dense wire)
    lanes included, comes back as it was saved."""
    jeng = JEngine(JTPFLStrategy(jtm.TMConfig(**TM), local_epochs=1), jdata,
                   JRuntimeConfig(rounds=1, checkpoint_dir=str(tmp_path),
                                  checkpoint_every=1))
    jstate, _ = jeng.run(jax.random.PRNGKey(0))
    path = jcheckpointing.latest(tmp_path)
    assert len(msgpack.unpackb(path.read_bytes())) == 13
    got = checkpointing.restore(path, _like(_engine(fields)))
    want = [jstate.round_idx, jstate.client_state.ta_state,
            jstate.client_state.weights, jstate.server.slots,
            *(getattr(jstate, lane) for lane in convert.BUF_LANES),
            jstate.ref_vecs, jstate.ref_round, jstate.ef_residual]
    for a, b in zip(want, [got.round_idx, *got.client_state,
                           got.server.slots,
                           *(getattr(got, lane) for lane in convert.BUF_LANES),
                           got.ref_vecs, got.ref_round,
                           got.ef_residual], strict=True):
        assert b.dtype == {np.int32: torch.int32, np.float32: torch.float32,
                           np.bool_: torch.bool}[np.asarray(a).dtype.type]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_restore_layout_error_names_leaf_and_both_layouts(tmp_path):
    path = tmp_path / "round_000001.msgpack"
    ckpt.save(path, {"server": {"slots": torch.zeros((4, 8))}})
    with pytest.raises(ValueError) as ei:
        ckpt.restore(path, {"server": {"slots": torch.zeros((8, 8))}})
    msg = str(ei.value)
    assert "'server/slots'" in msg
    assert "float32(4, 8)" in msg and "float32(8, 8)" in msg
    with pytest.raises(ValueError) as ei:
        ckpt.restore(path, {"server": {"slots": torch.zeros(
            (4, 8), dtype=torch.int32)}})
    msg = str(ei.value)
    assert "float32(4, 8)" in msg and "int32(4, 8)" in msg
    with pytest.raises(KeyError, match="'server/aux'"):
        ckpt.restore(path, {"server": {"aux": torch.zeros(1)}})
    with pytest.raises(ValueError, match="layout"):
        checkpointing.restore(path,
                              {"server": {"slots": torch.zeros((8, 8))}})
    # the reference's reader reads the port's file the same way
    with pytest.raises(ValueError, match="'server/slots'"):
        jckpt.restore(path, {"server": {"slots": np.zeros((8, 8),
                                                          np.float32)}})


# ---------------------------------------------------------------------------
# registry: verify-then-place and its failure modes
# ---------------------------------------------------------------------------

def test_registry_publish_pull_roundtrip(tmp_path, fields, trained):
    reg = _fresh_registry(tmp_path, trained)
    assert reg.versions() == [2] and reg.latest() == 2
    assert registry_mod.checksum_path(reg.path_for(2)).is_file()
    pulled = reg.pull(2, _like(_engine(fields)))
    for a, b in zip(convert.to_numpy([pulled.round_idx, *pulled.client_state,
                                      pulled.server.slots]),
                    convert.to_numpy([trained["state"].round_idx,
                                      *trained["state"].client_state,
                                      trained["state"].server.slots])):
        np.testing.assert_array_equal(a, b)


def _corrupt_payload(reg):
    path = reg.path_for(2)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _flip_sidecar(reg):
    registry_mod.checksum_path(reg.path_for(2)).write_text("0" * 64 + "\n")


def _drop_sidecar(reg):
    registry_mod.checksum_path(reg.path_for(2)).unlink()


@pytest.mark.parametrize("tamper,error,match", [
    (_corrupt_payload, ChecksumError, "mismatch"),
    (_flip_sidecar, ChecksumError, "mismatch"),
    (_drop_sidecar, RegistryError, "sidecar"),
], ids=["corrupted_payload", "flipped_sidecar", "missing_sidecar"])
def test_registry_pull_refuses_tampering(tmp_path, fields, trained, tamper,
                                         error, match):
    reg = _fresh_registry(tmp_path, trained)
    tamper(reg)
    with pytest.raises(error, match=match):
        reg.pull(2, _like(_engine(fields)))


def test_registry_pull_rejects_missing_version(tmp_path, fields, trained):
    reg = _fresh_registry(tmp_path, trained)
    with pytest.raises(RegistryError, match="not in the registry"):
        reg.pull(7, _like(_engine(fields)))


def test_registry_versions_are_immutable(tmp_path, trained):
    reg = _fresh_registry(tmp_path, trained)
    src = checkpointing.latest(trained["ckpt_dir"])
    assert reg.publish(src) == 2              # identical bytes: a no-op
    clash = tmp_path / "clash" / src.name
    clash.parent.mkdir()
    clash.write_bytes(src.read_bytes() + b"\x00")
    with pytest.raises(RegistryError, match="immutable"):
        reg.publish(clash)


def test_registry_pull_rejects_layout_drift(tmp_path, fields, trained):
    """A 12-clause checkpoint does not decode into a 20-clause template;
    the error names the drifted leaf."""
    reg = _fresh_registry(tmp_path, trained)
    with pytest.raises(ValueError, match="layout") as ei:
        reg.pull(2, _like(_engine(fields, n_clauses=20)))
    assert "'.client_state/.ta_state'" in str(ei.value)


# ---------------------------------------------------------------------------
# warm swap
# ---------------------------------------------------------------------------

def _publish_successor(reg, trained, round_idx=4):
    """Forge a later-round version with visibly different weights."""
    state = trained["state"]
    cs = state.client_state
    succ = state._replace(
        round_idx=torch.tensor(round_idx, dtype=torch.int32),
        client_state=cs._replace(weights=cs.weights + 3))
    staging = reg.root / "staging"
    staging.mkdir(exist_ok=True)
    return reg.publish(checkpointing.save(staging, succ))


def test_warm_swap_is_atomic_under_inflight_request(tmp_path, fields,
                                                    trained):
    reg = _fresh_registry(tmp_path, trained)
    engine = _engine(fields)
    like = _like(engine)
    ids = np.arange(N_CLIENTS)
    x = fields["x_test"][:, 0]
    baseline = ServingPlane(engine.strategy, reg, like)
    baseline.refresh()
    want_old = baseline.predict(ids, x)

    def land_new_version(plane):
        if reg.latest() == 2:            # fire once, mid-first-request
            _publish_successor(reg, trained)
            assert plane.refresh()       # swap while the request is in flight

    tel = ServeTelemetry(tmp_path / "tel")
    plane = ServingPlane(engine.strategy, reg, like, telemetry=tel,
                         resolve_hook=land_new_version)
    plane.refresh()
    got = plane.predict(ids, x)
    assert plane.last_served_version == 2
    np.testing.assert_array_equal(got, want_old)
    plane.predict(ids, x)
    assert plane.last_served_version == 4
    events = [json.loads(line) for line in
              tel.events_path.read_text().splitlines()]
    assert [(e["from_version"], e["to_version"]) for e in events
            if e["event"] == "swap"] == [(None, 2), (2, 4)]
    batches = [e for e in events if e["event"] == "batch"]
    assert [e["version"] for e in batches] == [2, 4]
    assert all(e["batch"] == N_CLIENTS and e["latency_s"] > 0
               for e in batches)


def test_refresh_never_downgrades(tmp_path, fields, trained):
    reg = _fresh_registry(tmp_path, trained)
    engine = _engine(fields)
    plane = ServingPlane(engine.strategy, reg, _like(engine))
    assert plane.refresh() is True
    assert plane.refresh() is False          # same version: no swap
    _publish_successor(reg, trained)
    assert plane.refresh() is True
    assert plane.active_version == 4


def test_predict_without_active_version_is_loud(tmp_path, fields):
    engine = _engine(fields)
    plane = ServingPlane(engine.strategy, ModelRegistry(tmp_path / "empty"),
                         _like(engine))
    with pytest.raises(RegistryError, match="no active model"):
        plane.predict(np.arange(2), fields["x_test"][:2, 0])


def test_mmap_store_is_a_later_slice(tmp_path, fields):
    engine = _engine(fields)
    with pytest.raises(NotImplementedError, match="later slice"):
        ServingPlane(engine.strategy, ModelRegistry(tmp_path / "r"),
                     _like(engine), store=object())


# ---------------------------------------------------------------------------
# serving parity
# ---------------------------------------------------------------------------

def _mixed_batch(fields):
    """Every client twice, each time with another test sample."""
    ids = np.concatenate([np.arange(N_CLIENTS), np.arange(N_CLIENTS)])
    x = np.concatenate([fields["x_test"][:, 0], fields["x_test"][:, 1]])
    return ids, x


def test_served_equals_offline(tmp_path, fields, trained):
    reg = _fresh_registry(tmp_path, trained)
    engine = _engine(fields)
    like = _like(engine)
    plane = ServingPlane(engine.strategy, reg, like)
    plane.refresh()
    ids, x = _mixed_batch(fields)
    got = plane.predict(ids, x)
    assert got.dtype == np.int32 and got.shape == ids.shape
    rows, written = plane._resolve_rows(reg.pull(2, like),
                                        np.arange(N_CLIENTS))
    assert written.all()
    cfg = engine.strategy.tm_cfg
    for j, c in enumerate(ids):
        row = ttm.TMParams(*(a[c] for a in rows))
        want = int(ttm.predict(row, torch.as_tensor(x[j:j + 1]), cfg)[0])
        assert int(got[j]) == want


@pytest.mark.parametrize("tm_backend", ["ref", "pallas"])
def test_port_plane_serves_a_jax_checkpoint_as_the_jax_plane(
        tmp_path, fields, jdata, tm_backend):
    """A JAX-trained population, published into both packages'
    registries: the port's plane returns the JAX plane's predictions for
    the same ids and rows."""
    jeng = JEngine(JTPFLStrategy(jtm.TMConfig(**TM), local_epochs=1), jdata,
                   JRuntimeConfig(rounds=2, checkpoint_dir=str(tmp_path / "c"),
                                  checkpoint_every=2, tm_backend=tm_backend))
    jeng.run(jax.random.PRNGKey(0))
    src = jcheckpointing.latest(tmp_path / "c")
    jreg = JModelRegistry(tmp_path / "jreg")
    jreg.publish(src)
    jlike = jeng.init(jax.random.split(jax.random.PRNGKey(0))[0])
    jplane = JServingPlane(jeng.strategy, jreg, jlike)
    jplane.refresh()
    reg = ModelRegistry(tmp_path / "treg")
    reg.publish(src)
    engine = _engine(fields)
    plane = ServingPlane(engine.strategy, reg, _like(engine))
    plane.refresh()
    ids, x = _mixed_batch(fields)
    want = jplane.predict(ids, x)
    np.testing.assert_array_equal(plane.predict(ids, x), np.asarray(want))
    assert plane.active_version == jplane.active_version == 2


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

FLAGS = ["--device", "cpu", "--clients", "4", "--clauses", "8",
         "--local-epochs", "1"]


def test_resumed_run_equals_the_uninterrupted_run(tmp_path, capsys):
    full = fed_train.main(FLAGS + ["--rounds", "2", "--ckpt-dir",
                                   str(tmp_path / "a"), "--ckpt-every", "1"])
    fed_train.main(FLAGS + ["--rounds", "1", "--ckpt-dir",
                            str(tmp_path / "b"), "--ckpt-every", "1"])
    resumed = fed_train.main(FLAGS + ["--rounds", "2", "--resume",
                                      "--ckpt-dir", str(tmp_path / "b"),
                                      "--ckpt-every", "1"])
    assert "resumed from" in capsys.readouterr().out
    a, b = full["state"], resumed["state"]
    for x, y in zip([a.round_idx, *a.client_state, a.server.slots],
                    [b.round_idx, *b.client_state, b.server.slots]):
        assert torch.equal(x, y)
    assert resumed["acc_per_round"] == full["acc_per_round"][1:]
    name = "round_000002.msgpack"
    assert (tmp_path / "a" / name).read_bytes() == \
        (tmp_path / "b" / name).read_bytes()
    done = fed_train.main(FLAGS + ["--rounds", "2", "--resume", "--ckpt-dir",
                                   str(tmp_path / "b")])
    assert done["final_accuracy"] is None


def test_fed_serve_verifies_offline_on_cpu(tmp_path, capsys):
    fed_train.main(FLAGS + ["--rounds", "2", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "1"])
    out = fed_serve.main(FLAGS + ["--ckpt-dir", str(tmp_path), "--batch",
                                  "8", "--requests", "3", "--verify-offline",
                                  "--telemetry-dir", str(tmp_path / "tel")])
    text = capsys.readouterr().out
    assert "published" in text and "registry version 2" in text
    assert "req/s, p50=" in text and "offline parity: OK (4 clients" in text
    assert out["version"] == 2 and out["requests"] == 24
    assert out["verified_clients"] == 4 and out["mismatches"] == 0
    assert 0 < out["p50_s"] <= out["p99_s"]
    kinds = [json.loads(line)["event"] for line in
             (tmp_path / "tel" / "serve_events.jsonl").read_text()
             .splitlines()]
    assert kinds == ["publish", "swap"] + ["batch"] * 4


@pytest.mark.parametrize("extra", [
    [], ["--dataset", "synthfashion", "--data-dir", "DATA", "--encoding",
         "thermometer:2"]], ids=["synthmnist", "data_dir_thermometer"])
def test_fed_serve_fedtm_verifies_offline_on_cpu(tmp_path, capsys, extra):
    """A FedTM run served through ``--strategy fedtm``: every client's
    served prediction equals its row's offline prediction; the scenario
    flags (``--data-dir``, ``--encoding``) pass through to the serving
    process's rebuild."""
    extra = [str(tmp_path / "data") if a == "DATA" else a for a in extra]
    flags = FLAGS + ["--strategy", "fedtm", *extra]
    fed_train.main(flags + ["--rounds", "2", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    out = fed_serve.main(flags + ["--ckpt-dir", str(tmp_path), "--batch",
                                  "8", "--requests", "2",
                                  "--verify-offline"])
    text = capsys.readouterr().out
    assert "serving fedtm version 2" in text
    assert "offline parity: OK (4 clients" in text
    assert out["verified_clients"] == 4 and out["mismatches"] == 0
    if extra:
        assert (tmp_path / "data" / "synthfashion").is_dir()


def test_port_plane_serves_a_jax_fedtm_checkpoint_as_the_jax_plane(
        tmp_path, fields, jdata):
    """A JAX-trained FedTM population, published into both packages'
    registries: the port's plane returns the JAX plane's predictions."""
    jeng = JEngine(JFedTMStrategy(jtm.TMConfig(**TM), local_epochs=1), jdata,
                   JRuntimeConfig(rounds=2, checkpoint_dir=str(tmp_path / "c"),
                                  checkpoint_every=2))
    jeng.run(jax.random.PRNGKey(0))
    src = jcheckpointing.latest(tmp_path / "c")
    jreg = JModelRegistry(tmp_path / "jreg")
    jreg.publish(src)
    jlike = jeng.init(jax.random.split(jax.random.PRNGKey(0))[0])
    jplane = JServingPlane(jeng.strategy, jreg, jlike)
    jplane.refresh()
    reg = ModelRegistry(tmp_path / "treg")
    reg.publish(src)
    engine = Engine(FedTMStrategy(ttm.TMConfig(**TM), local_epochs=1),
                    convert.client_data_from_numpy(fields, "cpu"),
                    RuntimeConfig())
    plane = ServingPlane(engine.strategy, reg, _like(engine))
    plane.refresh()
    ids, x = _mixed_batch(fields)
    np.testing.assert_array_equal(plane.predict(ids, x),
                                  np.asarray(jplane.predict(ids, x)))
    assert plane.active_version == jplane.active_version == 2


@pytest.mark.parametrize("wire", [
    ["--codec", "int8", "--sparse"],
    ["--codec", "int4", "--sparse", "--error-feedback"]],
    ids=["int8_sparse", "int4_sparse_ef"])
def test_fed_serve_restores_a_lossy_run(tmp_path, capsys, wire):
    """A lossy run's checkpoint carries the wire's lanes; ``fed_serve``
    given the same structural codec flags builds a matching template
    and serves it exactly, and without them refuses the layout."""
    fed_train.main(FLAGS + wire + ["--rounds", "2", "--ckpt-dir",
                                   str(tmp_path), "--ckpt-every", "2"])
    out = fed_serve.main(FLAGS + wire + [
        "--ckpt-dir", str(tmp_path), "--batch", "8", "--requests", "2",
        "--verify-offline"])
    assert "offline parity: OK (4 clients" in capsys.readouterr().out
    assert out["verified_clients"] == 4 and out["mismatches"] == 0
    with pytest.raises(ValueError, match="layout mismatch for leaf "
                                         "'.ref_vecs'"):
        fed_serve.main(FLAGS + ["--ckpt-dir", str(tmp_path), "--batch", "8",
                                "--requests", "1"])
