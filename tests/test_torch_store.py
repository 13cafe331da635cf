"""The port's mmap client store (``repro_torch.fl.store``) and the engine
over it, against the JAX package's on the CPU.

* the store's unit properties, ``tests/test_store.py`` ported: gather
  after spill is the identity across reopen, fault-in, a flipped row
  byte and a tampered manifest are refused, concurrent gathers agree,
  never-sampled rows stay holes, the I/O meters are exact, out-of-range
  ids and template drift fail, and ``init_cohort == init[ids]``;
* the store's files are the reference's, byte for byte, after the same
  template and spills (a TM row with its sparse references, a 0-d
  ``ref_round`` among them, and an MLP dict row);
* the mmap engine against the JAX mmap engine: TPFL and FedTM on
  float32 and int8 + sparse, full and partial participation with
  dropout, async on both buffer routes, every report field bit for bit
  (``mean_accuracy`` within 1e-6, queue C item 3), the store meters,
  the server, the buffer's lanes, the population read back from the
  store and the store directory's bytes; ``store_eval="sampled"``; a
  checkpointed run resumed over its store; IFCA and FLIS-DC within
  atol 1e-6 / rtol 1e-5; and the port's mmap engine equals its resident
  engine bit for bit for every strategy;
* the ``RuntimeConfig`` refusals carry the reference's messages.

One JAX run per configuration, shared by the tests through a
module-scoped cache."""
import dataclasses
import json
import pathlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
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
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline_strategy
from repro.fl.store import ClientStore as JClientStore
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.data.ingest import idx
from repro_torch.fl.runtime import (CodecConfig, Engine, FedTMStrategy,
                                    RuntimeConfig, SchedulerConfig,
                                    TPFLStrategy, build_baseline_strategy,
                                    checkpointing)
from repro_torch.fl.store import ClientStore
from repro_torch.fl.store.client_store import (_DIGEST_BYTES, MANIFEST_NAME,
                                               WRITTEN_NAME, flatten)
from test_torch_gpu import one_torch_thread  # noqa: F401

N = 32
TEMPLATE = {"w": np.zeros((3, 4), np.int32),
            "b": np.zeros((5,), np.float32)}


def _init_fn(ids):
    """Deterministic per-client rows: the fault-in contract."""
    ids = np.asarray(ids, np.int64)
    return {
        "b": (ids[:, None] * 0.5 + np.arange(5)).astype(np.float32),
        "w": (ids[:, None, None]
              + np.arange(12).reshape(3, 4)).astype(np.int32),
    }


def _rand_rows(rng, k):
    return {"b": rng.normal(size=(k, 5)).astype(np.float32),
            "w": rng.integers(-9, 9, size=(k, 3, 4)).astype(np.int32)}


def _assert_rows_equal(a, b):
    la, lb = flatten(a)[0], flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _files(root) -> dict:
    return {p.name: p.read_bytes()
            for p in sorted(pathlib.Path(root).iterdir()) if p.is_file()}


# ---------------------------------------------------------------------------
# the store's unit properties (tests/test_store.py)
# ---------------------------------------------------------------------------

def test_gather_spill_roundtrip_identity_across_reopen(tmp_path):
    rng = np.random.default_rng(0)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    ids = np.asarray([3, 0, 17, 8])
    rows = _rand_rows(rng, ids.size)
    store.spill(ids, rows)
    _assert_rows_equal(store.gather(ids), rows)
    store.flush()
    again = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    _assert_rows_equal(again.gather(ids), rows)
    assert again.written_count() == ids.size
    # the last spill of an id wins, its digest recorded again
    newer = _rand_rows(rng, 1)
    again.spill(np.asarray([17]), newer)
    got = again.gather(ids)
    _assert_rows_equal({k: v[ids == 17] for k, v in got.items()}, newer)


def test_unwritten_rows_fault_in_from_init_fn(tmp_path):
    rng = np.random.default_rng(1)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    store.spill(np.asarray([4]), _rand_rows(rng, 1))
    out = store.gather(np.asarray([2, 4, 9]))
    expect = _init_fn(np.asarray([2, 9]))
    for leaf in ("b", "w"):
        np.testing.assert_array_equal(out[leaf][[0, 2]], expect[leaf])
    assert store.written_count() == 1          # fault-in is read-only
    # init_fn may hand tensors: they are copied to the host
    tensors = ClientStore(tmp_path, N, TEMPLATE, init_fn=lambda ids: {
        k: torch.from_numpy(v) for k, v in _init_fn(ids).items()})
    _assert_rows_equal(tensors.gather(np.asarray([2, 9])), expect)
    bare = ClientStore(tmp_path, N, TEMPLATE)
    with pytest.raises(ValueError, match="never spilled"):
        bare.gather(np.asarray([9]))


def test_flipped_row_byte_is_rejected_loudly(tmp_path):
    rng = np.random.default_rng(2)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    ids = np.asarray([5, 11])
    store.spill(ids, _rand_rows(rng, ids.size))
    store.flush()
    leaf0 = store.manifest["leaves"][0]        # "b" (sorted): 20 B a row
    nb = np.dtype(leaf0["dtype"]).itemsize * int(np.prod(leaf0["shape"]))
    path = tmp_path / (leaf0["slug"] + ".bin")
    raw = bytearray(path.read_bytes())
    raw[11 * nb] ^= 0xFF                       # client 11's first byte
    path.write_bytes(raw)
    reopened = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    with pytest.raises(idx.ChecksumError, match="checksum mismatch"):
        reopened.gather(np.asarray([11]))
    reopened.gather(np.asarray([5]))           # its neighbour reads
    ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn,
                verify=False).gather(np.asarray([11]))


def test_tampered_manifest_is_rejected_at_open(tmp_path):
    ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    man_path = tmp_path / MANIFEST_NAME
    man = json.loads(man_path.read_text())
    man["n_clients"] = N + 1
    man_path.write_text(json.dumps(man, indent=2, sort_keys=True))
    with pytest.raises(idx.ChecksumError):
        ClientStore(tmp_path, N, TEMPLATE)
    idx.write_checksum(man_path)               # re-signed: layout check
    with pytest.raises(ValueError, match="different engine configuration"):
        ClientStore(tmp_path, N, TEMPLATE)


def test_concurrent_gathers_are_deterministic(tmp_path):
    rng = np.random.default_rng(3)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    ids = np.arange(0, N, 2)
    store.spill(ids, _rand_rows(rng, ids.size))

    def snap(_):
        return [a.copy() for a in flatten(store.gather(ids))[0]]

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(snap, range(16)))
    for got in results[1:]:
        for a, b in zip(results[0], got):
            np.testing.assert_array_equal(a, b)
    assert store.io_read_bytes == 16 * ids.size * store.row_nbytes


def test_never_sampled_rows_stay_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    cohort = np.asarray([1, 7, 30])
    untouched = np.setdiff1d(np.arange(N), cohort)

    def region_bytes():
        out = []
        for spec in store.manifest["leaves"]:
            nb = np.dtype(spec["dtype"]).itemsize * int(
                np.prod(spec["shape"]))
            raw = (tmp_path / (spec["slug"] + ".bin")).read_bytes()
            out.append([raw[i * nb:(i + 1) * nb] for i in untouched])
        return out

    store.spill(cohort, _rand_rows(rng, cohort.size))
    store.flush()
    before = region_bytes()
    assert all(not any(r) for per_leaf in before for r in per_leaf)
    for _ in range(3):
        bundle = store.gather(cohort)
        store.spill(cohort, {k: (v + 1).astype(v.dtype)
                             for k, v in bundle.items()})
    store.flush()
    assert region_bytes() == before
    written = np.frombuffer((tmp_path / WRITTEN_NAME).read_bytes(), np.uint8)
    assert (written[untouched] == 0).all()
    assert store.written_count() == cohort.size


def test_io_counters_meter_exact_bytes(tmp_path):
    rng = np.random.default_rng(5)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    assert store.io_read_bytes == store.io_written_bytes == 0
    store.gather(np.arange(6))                 # all fault-in: no I/O
    assert store.io_read_bytes == 0 and store.io_written_bytes == 0
    store.spill(np.arange(6), _rand_rows(rng, 6))
    assert store.io_written_bytes == 6 * (store.row_nbytes
                                          + _DIGEST_BYTES + 1)
    store.gather(np.arange(8))                 # 6 from disk, 2 fault-in
    assert store.io_read_bytes == 6 * store.row_nbytes


def test_out_of_range_ids_and_template_drift_fail_loudly(tmp_path):
    rng = np.random.default_rng(6)
    store = ClientStore(tmp_path, N, TEMPLATE, init_fn=_init_fn)
    with pytest.raises(ValueError, match="out of range"):
        store.gather(np.asarray([N]))
    with pytest.raises(ValueError, match="out of range"):
        store.spill(np.asarray([-1]), _rand_rows(rng, 1))
    with pytest.raises(ValueError, match="does not match"):
        store.spill(np.asarray([0]),
                    {"b": np.zeros((1, 5), np.float64),   # wrong dtype
                     "w": np.zeros((1, 3, 4), np.int32)})
    store.spill(np.asarray([0]), _rand_rows(rng, 1))
    store.flush()
    with pytest.raises(ValueError, match="different"):
        ClientStore(tmp_path, N + 1, TEMPLATE)  # drifted client count


TM_SMALL = dict(n_classes=4, n_clauses=6, n_features=20, n_states=63, s=5.0,
                T=10)


@pytest.mark.parametrize("name", ["tpfl", "fedtm"])
def test_cohort_init_hooks_match_full_init(name):
    """``init_cohort(key, ids, n) == init(key, n)[0][ids]`` bit for bit
    (repeats allowed), ``init_server`` the full init's server, and both
    the JAX strategy's hooks."""
    cls, jcls = {"tpfl": (TPFLStrategy, JTPFLStrategy),
                 "fedtm": (FedTMStrategy, JFedTMStrategy)}[name]
    strat = cls(ttm.TMConfig(**TM_SMALL), local_epochs=1)
    jstrat = jcls(jtm.TMConfig(**TM_SMALL), local_epochs=1)
    jkey, n = jax.random.PRNGKey(42), 12
    key = convert.key_from_numpy(jkey, "cpu")
    ids = np.asarray([0, 5, 11, 5])
    full_cs, full_server = strat.init(key, n)
    cohort = strat.init_cohort(key, ids, n)
    jcohort = jstrat.init_cohort(jkey, jnp.asarray(ids), n)
    for a, b, c in zip(cohort, full_cs, jcohort):
        assert torch.equal(a, b[torch.as_tensor(ids)])
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    server = strat.init_server(key, n)
    assert torch.equal(server.slots, full_server.slots)
    np.testing.assert_array_equal(
        server.slots.numpy(),
        np.asarray(jstrat.init_server(jkey, n).slots))


# ---------------------------------------------------------------------------
# the store's files are the reference's
# ---------------------------------------------------------------------------

def _tm_row(rng):
    from repro_torch.core.tm import TMParams
    return {"cs": TMParams(
        ta_state=rng.integers(1, 127, (3, 4, 10)).astype(np.int32),
        weights=rng.integers(0, 9, (3, 4)).astype(np.int32)),
        "ref_vecs": rng.normal(size=(3, 4)).astype(np.float32),
        "ref_round": np.asarray(rng.integers(-1, 5), np.int32)}


def _mlp_row(rng):
    return {"cs": {"w1": rng.normal(size=(6, 5)).astype(np.float32),
                   "b1": rng.normal(size=(5,)).astype(np.float32),
                   "w2": rng.normal(size=(5, 3)).astype(np.float32),
                   "b2": rng.normal(size=(3,)).astype(np.float32)}}


def _jax_row(row):
    """The same row with the reference's TMParams."""
    cs = row["cs"]
    if hasattr(cs, "ta_state"):
        cs = jtm.TMParams(ta_state=cs.ta_state, weights=cs.weights)
    return {**row, "cs": cs}


def _stack(rows):
    leaves = [flatten(r)[0] for r in rows]
    _, unflatten = flatten(rows[0])
    return unflatten([np.stack(ls) for ls in zip(*leaves)])


@pytest.mark.parametrize("make", [_tm_row, _mlp_row], ids=["tm", "mlp"])
def test_store_files_are_the_reference_bytes(tmp_path, make):
    """After the same template and the same spills, every file of the
    port's store (manifest and sidecar, each leaf file, ``written.bin``,
    ``digests.bin``) equals the JAX ``ClientStore``'s byte for byte, and
    each reads the other's rows back."""
    rng = np.random.default_rng(7)
    n = 9
    template = make(rng)
    ours = ClientStore(tmp_path / "t", n, template)
    ref = JClientStore(tmp_path / "j", n, _jax_row(template))
    assert ours.manifest == ref.manifest
    assert ours.row_nbytes == ref.row_nbytes
    for ids in ([4, 0, 7], [7, 2], [8]):
        rows = _stack([make(rng) for _ in ids])
        ours.spill(np.asarray(ids), rows)
        ref.spill(np.asarray(ids), _jax_row(rows))
    ours.flush()
    ref.flush()
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    if make is _tm_row:
        assert ours.manifest["leaves"][2]["shape"] == []     # ref_round
    back = ClientStore(tmp_path / "j", n, template)
    ids = np.asarray([0, 2, 4, 7, 8])
    _assert_rows_equal(back.gather(ids), ours.gather(ids))
    _assert_rows_equal(JClientStore(tmp_path / "t", n, _jax_row(template))
                       .gather(ids)["cs"], ours.gather(ids)["cs"])


# ---------------------------------------------------------------------------
# the engine over the store, against the JAX engine
# ---------------------------------------------------------------------------

TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)
SPLIT = dict(n_clients=6, experiment=5, n_train=24, n_test=12, n_conf=12)
MLP_KW = dict(n_features=144, n_classes=10, n_hidden=16, local_epochs=2,
              batch=8, ifca_k=3, max_slots=4, probe_size=16)
TOL = dict(atol=1e-6, rtol=1e-5)
PARTIAL = dict(participation=0.5, dropout=0.3)
INT8_SPARSE = dict(name="int8", sparse=True)
ASYNC = dict(aggregation="async", async_min_uploads=2, buffer_capacity=6)
ASYNC_SCHED = dict(participation=0.75, dropout=0.25, straggler=0.5,
                   max_staleness=2)
# name: (strategy, scheduler, codec, other RuntimeConfig fields)
CASES = {
    "tpfl_f32_full": ("tpfl", {}, {}, {}),
    "tpfl_int8_sparse_partial": ("tpfl", PARTIAL, INT8_SPARSE, {}),
    "fedtm_f32_partial": ("fedtm", PARTIAL, {}, {}),
    "fedtm_int8_sparse_full": ("fedtm", {}, INT8_SPARSE, {}),
    "async_device": ("tpfl", ASYNC_SCHED, {}, ASYNC),
    "async_host_int8_sparse": ("tpfl", ASYNC_SCHED, INT8_SPARSE,
                               dict(ASYNC, async_buffer="host")),
    "tpfl_sampled": ("tpfl", PARTIAL, {}, dict(store_eval="sampled")),
}
BASELINE_CASES = {"ifca_partial": ("ifca", PARTIAL),
                  "flis_dc_partial": ("flis_dc", PARTIAL)}
ROUNDS = 2
CHUNK = 4       # 6 clients: chunks of 4 and 2


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


def _strategies(name):
    if name == "tpfl":
        return (JTPFLStrategy(jtm.TMConfig(**TM), local_epochs=2),
                TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2))
    if name == "fedtm":
        return (JFedTMStrategy(jtm.TMConfig(**TM), local_epochs=2),
                FedTMStrategy(ttm.TMConfig(**TM), local_epochs=2))
    return (jbuild_baseline_strategy(name, **MLP_KW),
            build_baseline_strategy(name, **MLP_KW))


def _run_all(populations, root, name, sched, wire, extra, ckpt=False):
    """The JAX mmap engine, the port's mmap engine and the port's
    resident engine on one configuration, 2 rounds from key 3 (the mmap
    runs checkpoint every round with ``ckpt``)."""
    jdata, data = populations
    jstrat, tstrat = _strategies(name)
    mmap = dict(client_store="mmap", store_eval_chunk=CHUNK)
    out = {}
    for tag in ("jax", "port", "resident"):
        kw = dict(rounds=ROUNDS, **extra)
        if tag != "resident":
            kw.update(mmap, store_dir=str(root / tag / "store"))
            if ckpt:
                kw.update(checkpoint_dir=str(root / tag / "ckpt"),
                          checkpoint_every=1)
        if tag == "jax":
            eng = JEngine(jstrat, jdata, JRuntimeConfig(
                scheduler=JSchedulerConfig(**sched),
                codec=JCodecConfig(**wire), **kw))
            state, reps = eng.run(jax.random.PRNGKey(3))
        else:
            eng = Engine(tstrat, data, RuntimeConfig(
                scheduler=SchedulerConfig(**sched),
                codec=CodecConfig(**wire), **kw))
            state, reps = eng.run(
                convert.key_from_numpy(jax.random.PRNGKey(3), "cpu"))
        if eng.store is not None:
            eng.store.flush()
        out[tag] = (eng, state, reps)
    return out


@pytest.fixture(scope="module")
def runs(populations, tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            root = tmp_path_factory.mktemp(case)
            if case in CASES:
                name, sched, wire, extra = CASES[case]
                cache[case] = _run_all(populations, root, name, sched, wire,
                                       extra, ckpt=case ==
                                       "tpfl_int8_sparse_partial")
            else:
                name, sched = BASELINE_CASES[case]
                cache[case] = _run_all(populations, root, name, sched, {},
                                       {})
        return cache[case]

    return get


def _bits(a):
    a = convert.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


REPORT_ARRAYS = ("assignment", "cluster_counts", "per_client_accuracy")
REPORT_INTS = ("upload_bytes", "download_bytes_broadcast",
               "download_bytes_per_client", "aggregated_uploads",
               "buffered_uploads", "evicted_uploads")


def _same_reports(want, got, store_meters=True, mean_tol=1e-6):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.round_idx == b.round_idx
        for f in REPORT_ARRAYS:
            _same(getattr(a, f), getattr(b, f), f)
        for f in REPORT_INTS:
            assert getattr(a, f) == getattr(b, f), f
        if store_meters:
            for f in ("store_read_bytes", "store_written_bytes"):
                assert getattr(a, f) == getattr(b, f), f
        assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) \
            <= mean_tol
        for f in ("idx", "active", "staleness"):
            _same(getattr(a.participation, f), getattr(b.participation, f))


def _lanes(state):
    """The replicated part of an engine state: round, server slots, the
    buffer's six lanes."""
    return [state.round_idx, state.server.slots, *state[3:9]]


def _population(eng, n):
    return eng.store.gather(np.arange(n))


@pytest.mark.parametrize("case", CASES)
def test_mmap_engine_equals_the_jax_mmap_engine(runs, case):
    """Reports (store meters included), the server and buffer lanes, the
    population read back from each store, and the store directories'
    bytes: the port's mmap engine is the JAX mmap engine's."""
    out = runs(case)
    jeng, jstate, jreps = out["jax"]
    teng, tstate, treps = out["port"]
    _same_reports(jreps, treps)
    for a, b in zip(_lanes(jstate), _lanes(tstate)):
        _same(a, b)
    for lane in ("ref_vecs", "ref_round", "ef_residual"):
        _same(getattr(jstate, lane), getattr(tstate, lane), lane)
    n = teng.n
    for a, b in zip(jax.tree_util.tree_leaves(_population(jeng, n)),
                    flatten(_population(teng, n))[0]):
        _same(a, b)
    assert _files(teng.store.root) == _files(jeng.store.root)
    written = [r.store_written_bytes for r in treps]
    assert written == [int(r.participation.idx.numel())
                       * (teng.store.row_nbytes + 33) for r in treps]
    if CASES[case][3].get("store_eval") == "sampled":
        k = teng.scheduler.k
        assert all(r.per_client_accuracy.shape == (k,)
                   and r.assignment.shape[0] == k for r in treps)


def _same_port_runs(resident, mmap):
    """The port's mmap run against its resident run: every report field
    but the store meters bit for bit, the server and buffer lanes, and
    the population gathered back from the store against the resident
    client state (and, on the sparse wire, its reference lanes)."""
    reng, rstate, rreps = resident
    teng, tstate, treps = mmap
    _same_reports(rreps, treps, store_meters=False, mean_tol=0.0)
    assert all(r.store_read_bytes == r.store_written_bytes == 0
               for r in rreps)
    for a, b in zip(_lanes(rstate), _lanes(tstate)):
        _same(a, b)
    pop = _population(teng, teng.n)
    for a, b in zip(flatten(rstate.client_state)[0], flatten(pop["cs"])[0]):
        _same(a, b)
    if "ref_vecs" in pop:
        _same(rstate.ref_vecs, pop["ref_vecs"])
        _same(rstate.ref_round, pop["ref_round"])


@pytest.mark.parametrize("case", [c for c in CASES if c != "tpfl_sampled"]
                         + list(BASELINE_CASES))
def test_mmap_engine_equals_the_resident_engine(runs, case):
    _same_port_runs(runs(case)["resident"], runs(case)["port"])


def _leaves_with_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


@pytest.mark.parametrize("case", BASELINE_CASES)
def test_mmap_baselines_within_tolerance_of_the_jax_engine(runs, case):
    """IFCA and FLIS-DC (the hookless fallback: one full init, rows
    served by index) over the store: the reports' integers exactly, the
    store meters exactly, the server and the population read back from
    each store within atol 1e-6 / rtol 1e-5."""
    out = runs(case)
    jeng, jstate, jreps = out["jax"]
    teng, tstate, treps = out["port"]
    for a, b in zip(jreps, treps):
        for f in ("assignment", "cluster_counts"):
            _same(getattr(a, f), getattr(b, f), f)
        for f in REPORT_INTS + ("store_read_bytes", "store_written_bytes"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(convert.to_numpy(b.per_client_accuracy),
                                   np.asarray(a.per_client_accuracy),
                                   atol=1e-6)
    np.testing.assert_allclose(tstate.server.slots.numpy(),
                               np.asarray(jstate.server.slots), **TOL)
    jpop = _leaves_with_paths(_population(jeng, teng.n))
    tpop = flatten(_population(teng, teng.n))[0]
    assert len(jpop) == len(tpop)
    for (path, a), b in zip(jpop, tpop):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(b, a, err_msg=path, **TOL)


def test_mmap_checkpoint_resume_is_bit_identical(runs, populations,
                                                 tmp_path):
    """A checkpointed mmap run: ``store_manifest.json`` beside each
    checkpoint is the reference's file; one round, then a resume from
    its checkpoint over the same store directory (restored into a state
    built from another key), equals the uninterrupted 2 rounds: the
    second report, the state and the store directory's bytes."""
    out = runs("tpfl_int8_sparse_partial")
    jeng, _, _ = out["jax"]
    teng, tstate, treps = out["port"]
    ours = pathlib.Path(teng.cfg.checkpoint_dir)
    ref = pathlib.Path(jeng.cfg.checkpoint_dir)
    for name in ("store_manifest.json", "round_000001.msgpack",
                 "round_000002.msgpack"):
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
    _, tstrat = _strategies("tpfl")
    cfg = dataclasses.replace(
        teng.cfg, rounds=1, store_dir=str(tmp_path / "store"),
        checkpoint_dir=str(tmp_path / "ckpt"))
    key = convert.key_from_numpy(jax.random.PRNGKey(3), "cpu")
    Engine(tstrat, populations[1], cfg).run(key)
    again = Engine(tstrat, populations[1], cfg)
    state = checkpointing.restore(
        checkpointing.latest(tmp_path / "ckpt"),
        again.init(tr.PRNGKey(99, "cpu")))
    state, (rep,) = again.run(key, state=state)
    again.store.flush()
    _same_reports(treps[1:], [rep])
    for a, b in zip(_lanes(tstate), _lanes(state)):
        _same(a, b)
    assert _files(tmp_path / "store") == _files(teng.store.root)


@pytest.mark.parametrize("kw", [
    dict(client_store="mmap", codec="error_feedback"),
    dict(client_store="disk"), dict(store_eval="all"),
    dict(store_eval_chunk=0)])
def test_runtime_config_refusals_carry_the_reference_messages(kw):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("codec") == "error_feedback":
        jkw["codec"] = JCodecConfig("int8", error_feedback=True)
        tkw["codec"] = CodecConfig("int8", error_feedback=True)
    with pytest.raises(ValueError) as want:
        JRuntimeConfig(**jkw)
    with pytest.raises(ValueError) as got:
        RuntimeConfig(**tkw)
    assert str(got.value) == str(want.value)
