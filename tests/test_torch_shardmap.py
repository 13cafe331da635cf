"""The port's shard-mapped engine (``backend="shardmap"``) at W = 4 over
``gloo`` against the port's in-process engine and the JAX engine, each
package on the ClientData it draws from the same seeds.

Every configuration runs in one module-scoped 4-rank world
(``repro_torch.launch.mesh.run_federations``, started in a thread so the
JAX runs go on beside it):

* ``gather``, for TPFL, FedTM, FedAvg, IFCA and FLIS-DC, on the float32
  and the int8 + sparse wires, under full participation and under 0.5
  with dropout 0.25: bit for bit the port's in-process engine (every
  report field, the state's every leaf), and the JAX engine: bit for bit
  for the TM strategies (``mean_accuracy`` within 1e-6, ROADMAP queue C
  item 3), within the baselines' ``TOL`` for the MLP on float32 under
  partial participation (the MLP is float math; on int8 it meets ReLU
  ties against JAX, queue C item 5, so there it is held to the
  in-process port alone);
* ``psum`` on integer uploads (TPFL's fused round, FedTM staged on a
  partial cohort, the async fold at a discount of 0.5): bit for bit the
  JAX in-process engine; on int8 + sparse (non-integer uploads) within
  atol 1e-6 / rtol 1e-5 of the JAX shard-mapped psum at W = 4;
* async TPFL on the device buffer, gather and psum, every buffer lane;
* the telemetry's span names, ``fused_round`` included, equal to the
  JAX shard-mapped engine's;
* the mmap store on the mesh equal to the resident engine, its files
  the in-process store's byte for byte;
* the reference's refusals, message for message;
* the legacy ``federation.init_state`` + ``run_round`` loop ==
  ``federation.run`` in process == the engine ``run`` builds on the
  mesh, the reference's three-way contract.

The JAX shard-mapped runs need 4 devices, so they run in a subprocess
with ``--xla_force_host_platform_device_count=4``.
"""
import filecmp
import functools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import tm as jtm
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl.obs import RunRecorder as JRunRecorder
from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import SchedulerConfig as JSchedulerConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro.fl.runtime.strategy import FedTMStrategy as JFedTMStrategy
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline_strategy
from repro_torch import convert
from repro_torch import random as tr
from repro_torch import tree
from repro_torch.core import federation
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.masked_collectives import collective_payload_bytes
from repro_torch.fl.obs.tracer import SUBSPANS
from repro_torch.fl.store import client_store
from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                    RuntimeConfig, SchedulerConfig,
                                    ShardMapExecutor, TPFLStrategy,
                                    build_baseline_strategy)
from repro_torch.launch import mesh as mesh_lib
from test_torch_async import _same_reports as _same_reports_tm
from test_torch_baselines import TOL, _close_trees
from test_torch_baselines import _same_reports as _same_reports_mlp
from test_torch_gpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
W = 4
TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)
MLP = dict(n_features=144, n_classes=10, n_hidden=16, local_epochs=1,
           batch=8, ifca_k=3, max_slots=4, probe_size=16)
SPLIT = dict(n_clients=6, experiment=5, n_train=24, n_test=12, n_conf=12)
STRATEGIES = ("tpfl", "fedtm", "fedavg", "ifca", "flis_dc")
TM_STRATEGIES = ("tpfl", "fedtm")
WIRES = {"float32": {}, "int8_sparse": dict(name="int8", sparse=True)}
PARTS = {"full": {}, "partial": dict(participation=0.5, dropout=0.25)}
ASYNC = dict(aggregation="async", async_min_uploads=2, buffer_capacity=3)
ASYNC_SCHED = dict(participation=0.75, dropout=0.25, straggler=0.5,
                   max_staleness=2)


def _cell(strategy, wire, part, collective="gather", rounds=2, **rt):
    return dict(strategy=strategy, wire=WIRES[wire], sched=PARTS[part],
                collective=collective, rounds=rounds, rt=rt)


GATHER = {f"{s}-{w}-{p}": _cell(s, w, p) for s in STRATEGIES
          for w in WIRES for p in PARTS}
CELLS = dict(GATHER)
CELLS.update({
    "tpfl-float32-full-psum": _cell("tpfl", "float32", "full", "psum"),
    "fedtm-float32-partial-psum": _cell("fedtm", "float32", "partial",
                                        "psum"),
    "tpfl-int8_sparse-full-psum": _cell("tpfl", "int8_sparse", "full",
                                        "psum"),
    "async-gather": dict(_cell("tpfl", "float32", "full", rounds=3),
                         sched=ASYNC_SCHED, rt=ASYNC),
    "async-psum": dict(_cell("tpfl", "float32", "full", "psum", rounds=3),
                       sched=ASYNC_SCHED, rt=ASYNC),
    "mmap-tpfl-int8_sparse-partial": _cell("tpfl", "int8_sparse", "partial",
                                           client_store="mmap"),
    "mmap-fedtm-float32-partial": _cell("fedtm", "float32", "partial",
                                        client_store="mmap"),
})
# the JAX shard-mapped runs (subprocess): the lossy psum, and the fused
# round (the one span layout only the shard-mapped engine has)
JAX_MESH = ("tpfl-int8_sparse-full-psum", "tpfl-float32-full")


def _strategy(name, jax_side=False):
    tm_cfg = (jtm if jax_side else ttm).TMConfig(**TM)
    if name == "tpfl":
        return (JTPFLStrategy if jax_side else TPFLStrategy)(
            tm_cfg, local_epochs=1)
    if name == "fedtm":
        return (JFedTMStrategy if jax_side else FedTMStrategy)(
            tm_cfg, local_epochs=1)
    build = jbuild_baseline_strategy if jax_side else build_baseline_strategy
    return build(name, **MLP)


def _config(cell, jax_side=False, mesh=False, store_dir=None):
    rt = dict(cell["rt"])
    if store_dir is not None:
        rt["store_dir"] = str(store_dir)
    if mesh:
        rt.update(backend="shardmap", mesh_collective=cell["collective"])
    if jax_side:
        return JRuntimeConfig(
            rounds=cell["rounds"], scheduler=JSchedulerConfig(**cell["sched"]),
            codec=JCodecConfig(**cell["wire"]), **rt)
    return RuntimeConfig(
        rounds=cell["rounds"], scheduler=SchedulerConfig(**cell["sched"]),
        codec=CodecConfig(**cell["wire"]), **rt)


@functools.cache
def _data():
    x, y, _ = synthetic.make_dataset("synthmnist", 600,
                                     tr.PRNGKey(0, "cpu"), side=12)
    return partition.partition(x, y, 10, key=tr.PRNGKey(1, "cpu"), **SPLIT)


@functools.cache
def _jax_data():
    x, y, _ = jsynthetic.make_dataset("synthmnist", 600,
                                      jax.random.PRNGKey(0), side=12)
    return jpartition.partition(x, y, 10, key=jax.random.PRNGKey(1),
                                **SPLIT)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("shardmap")


JAX_CODE = """
import json, sys
import numpy as np
import jax
from repro.core import tm as jtm
from repro.data import partition as jp, synthetic as js
from repro.fl.obs import RunRecorder
from repro.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                              SchedulerConfig, TPFLStrategy)
from repro.fl.runtime.strategy import build_baseline_strategy
from repro.sharding import compat

spec = json.loads(sys.argv[1])
x, y, _ = js.make_dataset("synthmnist", 600, jax.random.PRNGKey(0), side=12)
data = jp.partition(x, y, 10, key=jax.random.PRNGKey(1), **spec["split"])
mesh = compat.make_mesh((4,), ("clients",))
out, phases = {}, {}
for name, cell in spec["cells"].items():
    if cell["strategy"] == "tpfl":
        strat = TPFLStrategy(jtm.TMConfig(**spec["tm"]), local_epochs=1)
    else:
        strat = build_baseline_strategy(cell["strategy"], **spec["mlp"])
    cfg = RuntimeConfig(rounds=cell["rounds"],
                        scheduler=SchedulerConfig(**cell["sched"]),
                        codec=CodecConfig(**cell["wire"]),
                        backend="shardmap",
                        mesh_collective=cell["collective"], **cell["rt"])
    rec = RunRecorder()
    state, reps = Engine(strat, data, cfg, mesh=mesh,
                         telemetry=rec).run(jax.random.PRNGKey(0))
    phases[name] = [list(e["phases"]) for e in rec.history]
    out[name + "/slots"] = np.asarray(state.server.slots)
    for i, r in enumerate(reps):
        out[f"{name}/{i}/counts"] = np.asarray(r.cluster_counts)
        out[f"{name}/{i}/assignment"] = np.asarray(r.assignment)
        out[f"{name}/{i}/acc"] = np.asarray(r.per_client_accuracy)
        out[f"{name}/{i}/bytes"] = np.asarray(
            [r.upload_bytes, r.download_bytes_broadcast,
             r.download_bytes_per_client, r.aggregated_uploads])
np.savez(sys.argv[2], **out)
print("JAX_PHASES " + json.dumps(phases))
"""


@pytest.fixture(scope="module")
def jax_mesh(dirs):
    """The JAX package's shard-mapped engine on 4 virtual CPU devices, in
    a subprocess started first."""
    spec = dict(split=SPLIT, tm=TM, mlp=MLP,
                cells={name: CELLS[name] for name in JAX_MESH})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, json.dumps(spec),
         str(dirs / "jax_mesh.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def result():
        if not got:
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
            got["phases"] = json.loads(next(
                x for x in out.splitlines()
                if x.startswith("JAX_PHASES "))[11:])
            got["arrays"] = dict(np.load(dirs / "jax_mesh.npz"))
        return got

    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def world(jax_mesh, dirs):
    """Every cell on the port's 4-rank mesh, in one world spawned from a
    thread; ``world()`` waits for it."""
    data = _data()
    names = sorted(CELLS)
    jobs = [dict(strategy=_strategy(CELLS[n]["strategy"]), data=data,
                 seed=0, config=_config(
                     CELLS[n], mesh=True,
                     store_dir=(dirs / f"store-{n}" if n.startswith("mmap")
                                else None)))
            for n in names]
    box = {}

    def run():
        try:
            box["out"] = mesh_lib.spawn(mesh_lib.run_federations, W, jobs,
                                        device="cpu")
        except BaseException as e:           # re-raised in the test
            box["err"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def result():
        thread.join()
        if "err" in box:
            raise box["err"]
        return dict(zip(names, box["out"]))

    yield result
    thread.join()


_IN_PROCESS: dict = {}
_JAX: dict = {}


def _in_process(name, dirs=None):
    """The port's in-process run of a cell (the mmap cells' in-process
    store under ``dirs``)."""
    if name not in _IN_PROCESS:
        cell = CELLS[name]
        store = dirs / f"ref-store-{name}" if name.startswith("mmap") \
            else None
        engine = Engine(_strategy(cell["strategy"]), _data(),
                        _config(cell, store_dir=store))
        _IN_PROCESS[name] = (engine,) + engine.run(tr.PRNGKey(0, "cpu"))
    return _IN_PROCESS[name]


def _jax_in_process(name):
    """The JAX engine in process (its collective is no setting there):
    ``(state, reports, phases)``, the span names each round."""
    cell = CELLS[name]
    key = json.dumps({k: v for k, v in cell.items() if k != "collective"},
                     sort_keys=True)
    if key not in _JAX:
        rec = JRunRecorder()
        state, reps = JEngine(_strategy(cell["strategy"], jax_side=True),
                              _jax_data(), _config(cell, jax_side=True),
                              telemetry=rec).run(jax.random.PRNGKey(0))
        _JAX[key] = (state, reps, [list(e["phases"]) for e in rec.history])
    return _JAX[key]


def _bits(a):
    a = np.ascontiguousarray(convert.to_numpy(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_runs(ref, ours, store_meters=True):
    """Two port runs: every report field and every leaf of the state,
    bit for bit."""
    (rstate, rreps), (state, reps) = ref, ours
    assert len(rreps) == len(reps)
    for a, b in zip(rreps, reps):
        for f in a._fields:
            if f == "participation":
                for x, y in zip(a.participation, b.participation):
                    _same(x, y, f)
            elif f in ("store_read_bytes", "store_written_bytes") \
                    and not store_meters:
                continue
            elif isinstance(getattr(a, f), int):
                assert getattr(a, f) == getattr(b, f), f
            elif getattr(a, f) is not None:
                _same(getattr(a, f), getattr(b, f), f)
    la, lb = tree.leaves(tuple(rstate)), tree.leaves(tuple(state))
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        _same(x, y, f"state leaf {i}")


def _meter_matches_payload(res, cell):
    """Every rank's aggregation moved ``collective_payload_bytes`` (the
    reference's arithmetic) each round, padding apart.  The uploads cross
    the mesh once a round (under ``gather`` that gather is the
    aggregation), and the replicated ``assign`` moves nothing."""
    strat = _strategy(cell["strategy"])
    k = res["reports"][0].participation.idx.shape[0]
    payload = res["collective_payload_bytes"]
    assert payload == collective_payload_bytes(
        cell["collective"], k * strat.j_slots, strat.vec_dim, strat.n_slots)
    assert len(res["meter"]) == W
    for meter in res["meter"]:
        assert meter["bytes"]["aggregate"] - meter["pad"]["aggregate"] \
            == cell["rounds"] * payload
        assert "assign" not in meter["bytes"]
        if cell["collective"] == "gather":
            assert "uploads" not in meter["bytes"]


@pytest.mark.parametrize("name", sorted(
    n for n in GATHER if n.split("-")[0] in TM_STRATEGIES
    or n.endswith("-float32-partial")))
def test_gather_equals_the_jax_engine(world, name):
    """``gather`` against the JAX engine: the TM strategies bit for bit
    in every cell, the MLP baselines on float32 under partial
    participation with dropout (the cohort gathered, drops merged back)
    within ``TOL`` (their floats), their integers and bytes exact."""
    jstate, jreps, _ = _jax_in_process(name)
    res = world()[name]
    if CELLS[name]["strategy"] in TM_STRATEGIES:
        _same_reports_tm(jreps, res["reports"])
        _close_trees(jstate, res["state"], exact_floats=True)
    else:
        _same_reports_mlp(jreps, res["reports"])
        _close_trees(jstate, res["state"])


@pytest.mark.parametrize("name", sorted(GATHER))
def test_gather_equals_the_in_process_engine(world, name):
    """``gather`` on 4 ranks is the in-process port bit for bit, and its
    aggregation moved exactly ``collective_payload_bytes`` a round on
    every rank."""
    res = world()[name]
    _, state, reps = _in_process(name)
    _same_runs((state, reps), (res["state"], res["reports"]))
    _meter_matches_payload(res, CELLS[name])


@pytest.mark.parametrize("name", ["tpfl-float32-full-psum",
                                  "fedtm-float32-partial-psum",
                                  "async-gather", "async-psum"])
def test_integer_uploads_are_exact_on_either_collective(world, name):
    """On integer uploads (the float32 wire, the async fold at a discount
    of 0.5) ``psum`` is exact too: the JAX in-process engine bit for bit
    (TPFL's fused round; FedTM staged on a partial cohort; async TPFL on
    the device buffer, every lane), and the in-process port."""
    jstate, jreps, _ = _jax_in_process(name)
    res = world()[name]
    _same_reports_tm(jreps, res["reports"])
    _close_trees(jstate, res["state"], exact_floats=True)
    _, state, reps = _in_process(name)
    _same_runs((state, reps), (res["state"], res["reports"]))
    _meter_matches_payload(res, CELLS[name])
    if name.startswith("async"):
        assert sum(r.aggregated_uploads for r in reps) > 0
        assert sum(r.evicted_uploads for r in reps) > 0


def test_psum_on_lossy_uploads_is_close_to_the_jax_psum(world, jax_mesh):
    """On int8 + sparse the uploads are ``q·scale``: ``psum`` adds the
    ranks' partial sums in its own order, within atol 1e-6 / rtol 1e-5
    of the JAX shard-mapped psum at W = 4 (and of the in-process port);
    the counts, assignment and bytes exact."""
    name = "tpfl-int8_sparse-full-psum"
    res = world()[name]
    arrays = jax_mesh()["arrays"]
    _, state, reps = _in_process(name)
    got = convert.to_numpy(res["state"].server.slots)
    np.testing.assert_allclose(got, arrays[name + "/slots"], **TOL)
    np.testing.assert_allclose(got, convert.to_numpy(state.server.slots),
                               **TOL)
    for i, r in enumerate(res["reports"]):
        _same(r.cluster_counts, arrays[f"{name}/{i}/counts"])
        _same(r.assignment, arrays[f"{name}/{i}/assignment"])
        assert [r.upload_bytes, r.download_bytes_broadcast,
                r.download_bytes_per_client, r.aggregated_uploads] \
            == arrays[f"{name}/{i}/bytes"].tolist()
    assert (got != 0).any() and not np.array_equal(got, np.round(got))


@pytest.mark.parametrize("name", ["tpfl-float32-full",
                                  "flis_dc-float32-partial",
                                  "async-gather"])
def test_span_names_are_the_references(world, jax_mesh, name):
    """Rank 0's telemetry names the JAX shard-mapped engine's spans, in
    its order: ``fused_round`` on the identity wire (against the JAX
    shard-mapped run), the staged spans with ``assign`` for FLIS-DC, the
    async round's (the reference's staged and async rounds are one code
    path for both backends: against its in-process run).  The spans the
    port opens below the stages (``SUBSPANS``), which the reference has
    not, are left out of the comparison."""
    if name == "tpfl-float32-full":
        want = jax_mesh()["phases"][name]
        assert all("fused_round" in p for p in want)
    else:
        want = _jax_in_process(name)[2]
    got = [[n for n in e["phases"] if n not in SUBSPANS]
           for e in world()[name]["events"]]
    assert got == want


def test_three_way_parity_with_the_legacy_loop(world):
    """The legacy loop (``init_state`` from k_init, round r keyed
    ``fold_in(k_rounds, r)``) == ``federation.run`` in process == the
    engine ``federation.run`` builds, on the 4-rank mesh (the
    ``tpfl-float32-full`` cell: ``run``'s strategy and configuration),
    bit for bit."""
    tm_cfg = ttm.TMConfig(**TM)
    fed = federation.FedConfig(n_clients=SPLIT["n_clients"], rounds=2,
                               local_epochs=1)
    cell = CELLS["tpfl-float32-full"]
    assert federation._strategy(tm_cfg, fed) == _strategy("tpfl")
    assert _config(cell, mesh=True).rounds == fed.rounds
    key = tr.PRNGKey(0, "cpu")
    k_init, k_rounds = tr.split(key).unbind(0)
    st = federation.init_state(tm_cfg, fed, k_init)
    legacy = []
    for r in range(fed.rounds):
        st, m = federation.run_round(st, _data(), tr.fold_in(k_rounds, r),
                                     tm_cfg, fed)
        legacy.append(m)
    end, hist = federation.run(_data(), tm_cfg, fed, key)
    res = world()["tpfl-float32-full"]
    assert len(legacy) == len(hist) == len(res["reports"])
    for a, b, c in zip(legacy, hist, res["reports"]):
        for got in (b, c):
            _same(a.mean_accuracy, got.mean_accuracy, "mean_accuracy")
            _same(a.cluster_counts, got.cluster_counts, "counts")
            for f in ("upload_bytes", "download_bytes_broadcast",
                      "download_bytes_per_client"):
                assert getattr(a, f) == getattr(got, f), f
        _same(a.assignment, b.assignment, "assignment")
        _same(a.assignment, c.assignment[:, 0], "assignment")
    for got_cs, got_cw in ((end.client_params, end.cluster_weights),
                           (res["state"].client_state,
                            res["state"].server.slots)):
        _same(st.client_params.ta_state, got_cs.ta_state, "ta_state")
        _same(st.client_params.weights, got_cs.weights, "weights")
        _same(st.cluster_weights, got_cw, "cluster_weights")


@pytest.mark.parametrize("name", ["mmap-tpfl-int8_sparse-partial",
                                  "mmap-fedtm-float32-partial"])
def test_mmap_store_on_the_mesh_equals_the_resident_engine(world, dirs,
                                                           name):
    """Over the mmap store (rank 0 reads, spills and broadcasts the rows)
    the mesh run equals the resident in-process run bit for bit but the
    store meters, its population gathered back from the store; the
    store's files and meters are the in-process mmap run's."""
    res = world()[name]
    resident = name[len("mmap-"):]
    _, rstate, rreps = _in_process(resident)
    engine, mstate, mreps = _in_process(name, dirs)
    assert all(r.store_written_bytes > 0 for r in res["reports"])
    _same_runs((mstate, mreps), (res["state"], res["reports"]))
    _same_runs((rstate, rreps), (rstate, res["reports"]),
               store_meters=False)
    pop = res["population"]
    want = tree.leaves(tuple(rstate.client_state))
    got = client_store.flatten(pop["cs"])[0]
    assert len(want) == len(got)
    for x, y in zip(want, got):
        _same(x, y)
    if "ref_vecs" in pop:
        _same(rstate.ref_vecs, pop["ref_vecs"])
        _same(rstate.ref_round, pop["ref_round"])
    ref_dir, mesh_dir = dirs / f"ref-store-{name}", dirs / f"store-{name}"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in mesh_dir.iterdir())
    match, mismatch, errors = filecmp.cmpfiles(ref_dir, mesh_dir, names,
                                               shallow=False)
    assert not mismatch and not errors


REFUSALS = {
    "unknown_backend": dict(backend="multihost"),
    "unknown_collective": dict(mesh_collective="ring"),
    "transport_on_the_mesh": dict(transport="loopback", workers=2,
                                  backend="shardmap"),
    "host_buffer_on_the_mesh": dict(backend="shardmap", aggregation="async",
                                    async_buffer="host"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_runtime_config_refusals_are_the_references(case):
    kw = REFUSALS[case]
    with pytest.raises(ValueError) as mine:
        RuntimeConfig(rounds=1, **kw)
    with pytest.raises(ValueError) as theirs:
        JRuntimeConfig(rounds=1, **kw)
    assert str(mine.value) == str(theirs.value)


def test_the_mesh_has_the_one_clients_axis():
    """The port's clients mesh has one axis, ``clients``: another
    ``mesh_axis`` is refused with the reference's words for a mesh
    without that axis, when the config is built."""
    with pytest.raises(ValueError, match="mesh has no 'data' axis"):
        RuntimeConfig(rounds=1, backend="shardmap", mesh_axis="data")
    assert RuntimeConfig(rounds=1, backend="shardmap").mesh_axis \
        == "clients"


def test_async_hooks_on_the_mesh_are_refused_as_the_reference():
    """Async FLIS (server-side hooks) folds on the host buffer, which is
    in-process only: both engines refuse it on the mesh, before they
    look at a mesh."""
    cfg = dict(rounds=1, backend="shardmap", aggregation="async")
    with pytest.raises(ValueError) as mine:
        Engine(_strategy("flis_dc"), _data(), RuntimeConfig(**cfg))
    with pytest.raises(ValueError) as theirs:
        JEngine(_strategy("flis_dc", jax_side=True), _jax_data(),
                JRuntimeConfig(**cfg))
    assert str(mine.value) == str(theirs.value)


def test_shardmap_needs_a_mesh():
    """The port's mesh is a process group the caller joined: without one
    the engine refuses the backend (it builds no group of its own)."""
    with pytest.raises(ValueError, match="clients process group"):
        Engine(_strategy("tpfl"), _data(),
               RuntimeConfig(rounds=1, backend="shardmap"))
    with pytest.raises(ValueError, match="unknown collective"):
        ShardMapExecutor(None, collective="ring")
