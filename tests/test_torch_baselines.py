"""The DL baselines (FedAvg, FedProx, IFCA, FLIS-DC, FLIS-HC) on the
port's engine against ``repro.fl.runtime.Engine`` on the CPU, each
engine on the ClientData its own package draws from the same seeds.

Exact: the initial state (FLIS's probe draw included), every byte total,
every integer field of the reports (assignments, cluster counts,
participation, aggregated uploads) and the per-client accuracies.
Within ``TOL`` (float math: batched autograd against XLA's vmapped
``grad``, measured at about 1.2e-7 here): every float of the client and
server state; ``mean_accuracy`` within 1e-6 (queue C item 3).

On the float32 wire the two engines run free for 2 rounds.  On the int8
wire two discrete decisions sit within float drift: a value near a
rounding boundary can quantize to the next code on one side, and a
client training from quantized rows meets ReLU ties (ROADMAP queue C).
So the int8 engines run in lockstep (each round of the port starts from
the JAX engine's state and is handed its client step), downlink code
flips are found from the server rows, their margins printed and held
below ``TOL``, and a flip may move only its own column, by at most a
quantum; the ties are pinned on their own."""
import jax
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import SchedulerConfig as JSchedulerConfig
from repro.fl.runtime.strategy import \
    build_baseline_strategy as jbuild_baseline_strategy
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.data import partition, synthetic
from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                    SchedulerConfig, build_baseline_strategy)
from repro_torch.fl.runtime import codec as tcodec
from repro_torch.fl.runtime.strategy import flis_similarity
from test_torch_gpu import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-6, rtol=1e-5)
BASELINES = ("fedavg", "fedprox", "ifca", "flis_dc", "flis_hc")
KW = dict(n_features=144, n_classes=10, n_hidden=16, local_epochs=2,
          batch=8, ifca_k=3, max_slots=4, probe_size=16)
SPLIT = dict(n_clients=6, experiment=5, n_train=16, n_test=12, n_conf=12)
PARTICIPATION = {"full": {},
                 "partial": dict(participation=0.5, dropout=0.3,
                                 straggler=0.2)}


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


def _engines(populations, name, rounds, sched=None, wire=None):
    jdata, data = populations
    sched, wire = sched or {}, wire or {}
    jeng = JEngine(jbuild_baseline_strategy(name, **KW), jdata,
                   JRuntimeConfig(rounds=rounds,
                                  scheduler=JSchedulerConfig(**sched),
                                  codec=JCodecConfig(**wire)))
    teng = Engine(build_baseline_strategy(name, **KW), data,
                  RuntimeConfig(rounds=rounds,
                                scheduler=SchedulerConfig(**sched),
                                codec=CodecConfig(**wire)))
    return jeng, teng


def _leaves(tree):
    """(path, numpy leaf) pairs in jax's order (dict keys sorted)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def _close_trees(jtree, ttree, exact_floats=False):
    jl, tl = _leaves(jtree), _leaves(convert.to_numpy(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype == np.float32 and not exact_floats:
            np.testing.assert_allclose(b, a, err_msg=path, **TOL)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)


def _parts(state):
    """Every field of the engine state, the async buffer's lanes
    included (both packages carry them in the same order)."""
    return tuple(state)


def _same_reports(jreps, treps):
    assert len(jreps) == len(treps)
    for a, b in zip(jreps, treps):
        assert a.round_idx == b.round_idx
        for f in ("assignment", "cluster_counts", "per_client_accuracy"):
            want, got = np.asarray(getattr(a, f)), convert.to_numpy(
                getattr(b, f))
            assert want.dtype == got.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        for f in ("upload_bytes", "download_bytes_broadcast",
                  "download_bytes_per_client", "aggregated_uploads"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(float(a.mean_accuracy) - float(b.mean_accuracy)) <= 1e-6
        for f in ("idx", "active", "staleness"):
            np.testing.assert_array_equal(
                convert.to_numpy(getattr(b.participation, f)),
                np.asarray(getattr(a.participation, f)))


def _np(a):
    return convert.to_numpy(a) if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _watch_decisions(teng, log):
    """Record the margins of the port's discrete decisions each round:
    IFCA's gap between a client's two lowest slot losses, FLIS's
    smallest distance of a similarity to the threshold."""
    ex, strat = teng.executor, teng.strategy
    train, assign = ex.train, ex.assign

    def watched_train(strategy, sub_cs, server, sub_data, keys):
        if hasattr(strategy, "slot_losses"):
            top2 = torch.sort(strategy.slot_losses(server, sub_data),
                              dim=-1).values[:, :2]
            log.append(f"IFCA loss gap "
                       f"{float((top2[:, 1] - top2[:, 0]).min()):.3e}")
        return train(strategy, sub_cs, server, sub_data, keys)

    def watched_assign(strategy, server, dec, slots, arrive):
        sim = flis_similarity(dec[:, 0], server.aux.probe, strat._layout)
        pair = arrive[:, None] & arrive[None, :] & ~torch.eye(
            len(arrive), dtype=torch.bool)
        gap = (sim - strat.threshold).abs()[pair]
        log.append(f"FLIS |sim - threshold| "
                   f"{float(gap.min()):.3e}" if gap.numel() else
                   "FLIS: fewer than two arrivals")
        return assign(strategy, server, dec, slots, arrive)

    ex.train, ex.assign = watched_train, watched_assign


@pytest.mark.parametrize("sched", PARTICIPATION)
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_float32_wire_within_tolerance(populations, name, sched):
    """Two rounds on the float32 wire, full and partial participation with
    dropout and stragglers: the initial states bit for bit, the reports'
    integers and bytes exactly, the final state within TOL."""
    jeng, teng = _engines(populations, name, 2, PARTICIPATION[sched])
    key = jax.random.PRNGKey(3)
    tkey = convert.key_from_numpy(key, "cpu")
    k_init = jax.random.split(key)[0]
    _close_trees(_parts(jeng.init(k_init)), _parts(teng.init(
        tr.split(tkey)[0])), exact_floats=True)
    margins = []
    _watch_decisions(teng, margins)
    jstate, jreps = jeng.run(key)
    tstate, treps = teng.run(tkey)
    print(f"{name} {sched} decision margins: {margins}")
    _same_reports(jreps, treps)
    _close_trees(_parts(jstate), _parts(tstate))
    if sched == "partial":
        assert any(not bool(r.participation.active.all()) for r in treps)
    if name.startswith("flis"):
        # the membership table of the last round rides in the server aux
        np.testing.assert_array_equal(
            convert.to_numpy(tstate.server.aux.members),
            convert.to_numpy(treps[-1].cluster_counts))


def _record(eng, log):
    """Record each round's pre-codec uploads and the server rows the
    downlink encodes (test-local wrappers on the instance)."""
    up, down = eng._wire_uplink, eng._wire_downlink

    def wire_uplink(state, vecs, slots, part, *a, **kw):
        log.append(("up", _np(vecs), _np(slots), _np(part.active)))
        return up(state, vecs, slots, part, *a, **kw)

    def wire_downlink(server, counts, *a, **kw):
        log.append(("down", _np(server), _np(counts)))
        return down(server, counts, *a, **kw)

    eng._wire_uplink, eng._wire_downlink = wire_uplink, wire_downlink


def _flips(a, b, name):
    """Columns where int8 codes of two float vectors differ, the margin
    of each (the JAX value's distance to the rounding boundary) and the
    larger quantum."""
    qa, sa = tcodec._quantize(a, 127)
    qb, sb = tcodec._quantize(b, 127)
    cols = np.nonzero(qa != qb)[0]
    margins = np.abs(np.abs(a[cols] / np.float32(sa)) % 1 - 0.5) * sa
    for c, m in zip(cols, margins):
        print(f"int8 flip in {name} column {c}: margin {m:.3e}")
    return cols, margins, max(sa, sb)


def _to_port(jstate):
    """The JAX engine's state as the port's, through convert."""
    cs = jstate.client_state
    if hasattr(cs, "prev_slot"):
        client = convert.flis_client_state_from_numpy(
            {k: np.asarray(v) for k, v in cs.params.items()},
            np.asarray(cs.prev_slot), "cpu")
        aux = (np.asarray(jstate.server.aux.probe),
               np.asarray(jstate.server.aux.members))
    else:
        client = convert.mlp_params_from_numpy(
            {k: np.asarray(v) for k, v in cs.items()}, "cpu")
        aux = None
    server = convert.server_state_from_numpy(
        np.asarray(jstate.server.slots), aux, "cpu")
    return convert.state_from_numpy(
        np.asarray(jstate.round_idx), client, server, "cpu",
        ref_vecs=np.asarray(jstate.ref_vecs),
        ref_round=np.asarray(jstate.ref_round),
        ef_residual=np.asarray(jstate.ef_residual))





def _client_from_numpy(cs):
    """A JAX MLP / FLIS client state (any leading axes) as the port's."""
    if hasattr(cs, "prev_slot"):
        return convert.flis_client_state_from_numpy(
            {k: np.asarray(v) for k, v in cs.params.items()},
            np.asarray(cs.prev_slot), "cpu")
    return convert.mlp_params_from_numpy(
        {k: np.asarray(v) for k, v in cs.items()}, "cpu")


def _inject_reference_client_step(jeng, teng):
    """The port's client step returns what the JAX engine's returned for
    the same round (the JAX engine runs each round first)."""
    seen = []
    jtrain = jeng.executor.train

    def record(*a, **kw):
        out = jtrain(*a, **kw)
        seen.append(out)
        return out

    def replay(strategy, sub_cs, server, sub_data, keys):
        new_sub, vecs, slots = seen.pop()
        return (_client_from_numpy(new_sub),
                torch.as_tensor(np.asarray(vecs)),
                torch.as_tensor(np.asarray(slots)))

    jeng.executor.train, teng.executor.train = record, replay


def _flat(cs, layout):
    """(n, d) flattened MLPs of a client state, either package's."""
    params = getattr(cs, "params", cs)
    n = _np(params["w1"]).shape[0]
    return np.concatenate([_np(params[k]).reshape(n, -1)
                           for k, _ in layout], axis=1)


@pytest.mark.parametrize("sched", PARTICIPATION)
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_int8_wire_lockstep(populations, name, sched):
    """Two rounds on the dense int8 wire, each round of the port started
    from the JAX engine's state and handed its client step (training
    from quantized rows is held apart, below): bytes, participation,
    assignments, counts and per-client accuracies exactly; the
    aggregate within TOL; every downlink code that differs has a margin
    below TOL, and the state is within TOL outside those columns and
    within a quantum inside them."""
    jeng, teng = _engines(populations, name, 1, PARTICIPATION[sched],
                          dict(name="int8"))
    _inject_reference_client_step(jeng, teng)
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    key = jax.random.PRNGKey(5)
    tkey = convert.key_from_numpy(key, "cpu")
    jstate = jeng.init(jax.random.split(key)[0])
    layout = teng.strategy._layout
    n_flips = 0
    for _ in range(2):
        jlog.clear()
        tlog.clear()
        start = _to_port(jstate)
        jstate, jreps = jeng.run(key, state=jstate, rounds=1)
        tstate, treps = teng.run(tkey, state=start, rounds=1)
        _same_reports(jreps, treps)
        (_, jup, _, _), (_, tup, _, _) = jlog[0], tlog[0]
        np.testing.assert_array_equal(tup, jup)     # the handed uploads
        (_, jsrv, jcnt), (_, tsrv, _) = jlog[1], tlog[1]
        np.testing.assert_allclose(tsrv, jsrv, **TOL)
        cols, quantum = [], 0.0
        for s in np.nonzero(jcnt > 0)[0]:
            f, m, q = _flips(jsrv[s], tsrv[s], f"slot {s}")
            assert (m < TOL["atol"]).all(), m
            cols.extend(f.tolist())
            quantum = max(quantum, q)
        n_flips += len(cols)
        free = np.setdiff1d(np.arange(teng.strategy.vec_dim), cols)
        for want, got in ((_flat(jstate.client_state, layout),
                           _flat(tstate.client_state, layout)),
                          (np.asarray(jstate.server.slots),
                           _np(tstate.server.slots))):
            np.testing.assert_allclose(got[:, free], want[:, free], **TOL)
            assert (np.abs(got[:, cols] - want[:, cols]) <= quantum).all()
        _close_trees(jstate.server.aux, tstate.server.aux)
        if name.startswith("flis"):
            np.testing.assert_array_equal(
                _np(tstate.client_state.prev_slot),
                np.asarray(jstate.client_state.prev_slot))
    print(f"{name} {sched}: {n_flips} downlink int8 code flips in 2 rounds")


@pytest.mark.parametrize("name", BASELINES)
def test_int8_rows_put_relu_ties_in_training(populations, name):
    """Queue C: on the int8 wire a client trains from quantized rows, and
    a hidden unit's pre-activation can be exactly 0 in exact arithmetic
    (codes summing to 0, times the scale); its float32 value takes its
    sign from the dot's summation order, which XLA and torch choose
    apart, so ReLU's gate can differ and the upload with it.  The port's
    own client step, one round from the JAX engine's state, for each
    baseline: FedAvg, FedProx and IFCA train from the server row their
    upload is tagged with (round 0), FLIS from the row it applied the
    round before (round 1, after one JAX round).  Each client's upload
    agrees within TOL unless its split holds such a tie, whose margin
    (|float32 pre-activation|) is printed and below TOL."""
    warm = 1 if name.startswith("flis") else 0
    jeng, teng = _engines(populations, name, 1, {}, dict(name="int8"))
    key = jax.random.PRNGKey(5)
    tkey = convert.key_from_numpy(key, "cpu")
    jstate = jeng.init(jax.random.split(key)[0])
    for _ in range(warm):
        jstate, _ = jeng.run(key, state=jstate, rounds=1)
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    jeng.run(key, state=jstate, rounds=1)
    teng.run(tkey, state=_to_port(jstate), rounds=1)
    (_, jup, jslots, _), (_, tup, tslots, _) = jlog[0], tlog[0]
    np.testing.assert_array_equal(tslots, jslots)
    x = _np(teng.data.x_train).astype(np.int64)
    n_f, n_h = teng.strategy.n_features, teng.strategy.n_hidden
    n_w1 = n_f * n_h
    rows = np.asarray(jstate.server.slots)
    start = _flat(jstate.client_state, teng.strategy._layout)
    differ = 0
    for c in range(jup.shape[0]):
        q, scale = tcodec._quantize(rows[int(jslots[c, 0])], 127)
        if warm:       # the client holds the row it applied, decoded
            np.testing.assert_array_equal(
                start[c], q.astype(np.float32) * np.float32(scale))
        qw1 = q[:n_w1].astype(np.int64).reshape(n_f, n_h)
        qb1 = q[n_w1:n_w1 + n_h].astype(np.int64)
        ties = (x[c] @ qw1 + qb1) == 0
        pre = x[c].astype(np.float32) @ (
            qw1.astype(np.float32) * np.float32(scale)) \
            + qb1.astype(np.float32) * np.float32(scale)
        gap = float(np.abs(tup[c] - jup[c]).max())
        margin = float(np.abs(pre[ties]).max(initial=0.0))
        print(f"{name} client {c}: {int(ties.sum())} ReLU ties, margin "
              f"{margin:.3e}, upload differs by {gap:.3e}")
        if gap > TOL["atol"] + TOL["rtol"] * float(np.abs(jup[c]).max()):
            differ += 1
            assert ties.any() and margin < TOL["atol"]
    print(f"{name}: {differ} of {jup.shape[0]} uploads moved by a tie")
