"""The port's telemetry plane (``repro_torch.fl.obs``) against the JAX
package's: the recorder never changes what a round computes (on == off
bit for bit), its events carry the reference's non-timing fields for the
same run, the manifest the reference's keys (torch and CUDA versions
where the reference records jax's), ``summarize`` renders a run, and a
telemetry run's manifest rides along with its checkpoints.  The spans
below the engine's stages (``tracer.SUBSPANS``) open on the round's
tracer, nest inside their stages on the profiler's timeline, and cost
nothing with telemetry off."""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.fl import obs as jobs
from repro_torch import convert
from repro_torch.fl import obs
from repro_torch.fl.obs import tracer
from repro_torch.fl.obs.summarize import main as summarize_main
from repro_torch.fl.runtime import Engine
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401
from test_torch_round import _engines

ROOT = Path(__file__).resolve().parents[1]
SPANS = {"round", "schedule", "gather", "broadcast_encode", "client_step",
         "uplink_codec", "aggregate", "server_update", "downlink",
         "apply_merge", "ref_track", "eval"}
# the spans each client step and eval opens below the stages: every TM
# strategy trains (key chain, epoch) and evaluates its votes; TPFL picks
# by confidence; a cohort's rows are scattered into the population
TRAINS = {"key_chain", "train_epoch", "eval_votes"}
SUBSPANS = {"tpfl": TRAINS | {"confidence", "top_class"}, "fedtm": TRAINS}
COHORT = {"eval_scatter"}
WIRE = dict(name="int8", sparse=True, index_coding="vrle",
            error_feedback=True)
SCHED = dict(participation=0.5, dropout=0.2, straggler=0.3)


def _run(teng, telemetry=None):
    eng = Engine(teng.strategy, teng.data, teng.cfg, telemetry=telemetry)
    return eng.run(convert.key_from_numpy(jax.random.PRNGKey(3), "cpu"))


@pytest.mark.parametrize("strategy", ["tpfl", "fedtm"])
def test_telemetry_on_equals_off_bit_for_bit(strategy, tmp_path):
    _, teng = _engines(rounds=2, strategy=strategy, sched=SCHED, wire=WIRE)
    off_state, off_reps = _run(teng)
    rec = obs.RunRecorder(run_dir=tmp_path).start(
        obs.build_manifest(config=teng.cfg, seed=3, device="cpu"))
    on_state, on_reps = _run(teng, rec)
    rec.close()
    a, b = convert.to_numpy((off_state, off_reps)), \
        convert.to_numpy((on_state, on_reps))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    events = obs.read_events(tmp_path / "events.jsonl")
    assert [e["round"] for e in events] == [0, 1]
    for e in events:
        assert set(e["phases"]) == SPANS | SUBSPANS[strategy] | COHORT
        assert all(v >= 0.0 for v in e["phases"].values())


def _drop_timing(event):
    event = dict(event)
    event.pop("phases")
    event["accuracy"] = dict(event["accuracy"])
    mean = event["accuracy"].pop("mean")
    return event, mean


@pytest.mark.parametrize("strategy", ["tpfl", "fedtm"])
def test_events_equal_the_references(strategy):
    """The same run recorded by both packages: every non-timing field
    of every event is equal (the accuracy mean within 1e-6)."""
    jeng, teng = _engines(rounds=2, strategy=strategy, sched=SCHED,
                          wire=WIRE)
    jrec = jobs.RunRecorder()
    jeng.obs = jrec
    jeng.run(jax.random.PRNGKey(3))
    trec = obs.RunRecorder()
    _run(teng, trec)
    assert len(jrec.history) == len(trec.history) == 2
    for je, te in zip(jrec.history, trec.history):
        (je, jmean), (te, tmean) = _drop_timing(je), _drop_timing(te)
        assert je == te
        assert abs(jmean - tmean) <= 1e-6


def test_round_event_keys_and_scheduler_summary():
    _, teng = _engines(rounds=1, sched=SCHED, wire=WIRE)
    rec = obs.RunRecorder()
    _, (rep,) = _run(teng, rec)
    (event,) = rec.history
    assert set(event) == {"schema", "round", "accuracy", "cluster",
                          "scheduler", "bytes", "async", "store",
                          "transport", "phases"}
    assert event["transport"] is None
    assert event["scheduler"] == rep.participation.summary()
    assert event["bytes"]["upload"] == rep.upload_bytes
    assert event["async"] == {"aggregated": rep.aggregated_uploads,
                              "buffered": 0, "evicted": 0}


def test_manifest_keys():
    _, teng = _engines(rounds=1, wire=WIRE)
    ours = obs.build_manifest(config=teng.cfg, seed=0, device="cpu",
                              extra={"strategy": "tpfl"})
    ref = jobs.build_manifest(config=None, seed=0,
                              extra={"strategy": "tpfl"})
    assert set(ours) == (set(ref) - {"jax_version"}) | {"torch_version",
                                                        "cuda_version"}
    assert ours["torch_version"] == torch.__version__
    assert ours["devices"]["platform"] == "cpu"
    assert ours["config"]["codec"] == dict(WIRE)
    assert ours["config"]["scheduler"]["participation"] == 1.0
    json.dumps(ours)            # plain JSON throughout


def test_fed_train_telemetry_summarize_and_checkpoint_manifest(tmp_path,
                                                               capsys):
    """``fed_train --telemetry-dir`` writes the manifest and one event a
    round, the manifest rides along with each checkpoint, and
    ``python -m repro_torch.fl.obs summarize`` renders the run."""
    run, ck = tmp_path / "run", tmp_path / "ck"
    out = fed_train.main([
        "--device", "cpu", "--clients", "4", "--rounds", "2", "--clauses",
        "8", "--local-epochs", "1", "--codec", "int4", "--sparse",
        "--telemetry-dir", str(run), "--ckpt-dir", str(ck),
        "--ckpt-every", "1"])
    text = capsys.readouterr().out
    assert "codec=int4+sparse" in text and f"telemetry: {run}" in text
    manifest = obs.read_manifest(run)
    assert manifest["config"]["codec"]["name"] == "int4"
    assert manifest["strategy"] == "tpfl" and manifest["seed"] == 0
    assert json.loads((ck / "manifest.json").read_text()) == manifest
    events = obs.read_events(run / "events.jsonl")
    assert [e["bytes"]["upload"] for e in events] == \
        [r.upload_bytes for r in out["reports"]]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.fl.obs", "summarize", str(run)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert summarize_main(["summarize", str(run)]) == 0
    shown = capsys.readouterr().out
    assert shown == res.stdout
    assert "strategy=tpfl" in shown and f"torch={torch.__version__}" in shown
    assert "rounds: 2" in shown and "uplink_codec" in shown
    assert "client accuracy deciles (round 1)" in shown
    medians = obs.phase_medians(events)
    assert set(medians) == SPANS | SUBSPANS["tpfl"]
    # the spans inside the stages are shown apart, after the stages' sum
    table = shown[shown.index("per-phase wall time"):]
    inside = table.index("inside the stages:")
    assert table.index("Σ stages") < inside
    for name in SUBSPANS["tpfl"]:
        assert table.index(f"  {name} ") > inside


def test_summarize_refuses_a_directory_without_events(tmp_path):
    with pytest.raises(SystemExit, match="not a telemetry run"):
        obs.summarize(tmp_path)


def test_profile_dir_writes_a_trace(tmp_path):
    fed_train.main(["--device", "cpu", "--clients", "2", "--rounds", "1",
                    "--clauses", "8", "--local-epochs", "1",
                    "--profile-dir", str(tmp_path)])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_phase_table_counts_the_subspans_apart():
    """``Σ stages`` sums the stages alone: a moment inside a sub-span is
    already inside its stage."""
    from repro_torch.fl.obs.summarize import _phase_table
    events = [{"phases": {"client_step": 2.0, "eval": 1.0, "round": 3.5,
                          "key_chain": 0.5, "eval_votes": 0.25}}]
    lines = _phase_table(events)
    total = next(ln for ln in lines if ln.startswith("Σ stages"))
    assert float(total.split()[-1]) == 3.0
    inside = lines.index("inside the stages:")
    assert [ln.split()[0] for ln in lines[inside + 1:]] == ["key_chain",
                                                           "eval_votes"]
    assert lines[inside + 1].startswith("  key_chain")


def _ranges(trace_events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
            if e.get("ph") == "X" and e.get("name") == name
            and e.get("cat") == "user_annotation"]


def _inside(inner, outer) -> bool:
    s, e = inner
    return any(s0 <= s and e <= e0 for s0, e0 in outer)


@pytest.mark.parametrize("strategy", ["tpfl", "fedtm"])
def test_subspans_nest_in_their_stages_on_the_profilers_clock(strategy,
                                                              tmp_path):
    """A ``RunRecorder`` round under its own ``torch.profiler`` capture
    (``profile_dir``): the Chrome trace names every span of the round,
    and each span below a stage lies inside that stage's range."""
    _, teng = _engines(rounds=1, strategy=strategy, sched=SCHED)
    rec = obs.RunRecorder(profile_dir=tmp_path).start()
    try:
        _run(teng, rec)
    finally:
        rec.close()
    trace = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = SPANS | SUBSPANS[strategy] | COHORT
    assert all(_ranges(trace, n) for n in names)
    stage = {"key_chain": "client_step", "train_epoch": "client_step",
             "confidence": "client_step", "top_class": "client_step",
             "eval_scatter": "eval", "eval_votes": "eval"}
    for name in SUBSPANS[strategy] | COHORT:
        outer = _ranges(trace, stage[name])
        for r in _ranges(trace, name):
            assert _inside(r, outer), (name, r, outer)
    # two epochs, each with its key chain (which splits the epoch's key
    # out of the clients' keys) between the literals and the epoch's launch
    assert len(_ranges(trace, "train_epoch")) == 4
    assert len(_ranges(trace, "key_chain")) == 2


@pytest.mark.parametrize("telemetry", ["null", "recorder"])
def test_no_capture_opens_no_record_function(telemetry, monkeypatch):
    """Without a profiler capture a round opens no ``record_function``;
    with telemetry off it also makes no span object."""
    import torch.autograd.profiler as autograd_profiler
    calls = {"record_function": 0, "span": 0}
    real_rf, real_init = autograd_profiler.record_function, \
        tracer._Span.__init__

    def counted_rf(*a, **kw):
        calls["record_function"] += 1
        return real_rf(*a, **kw)

    def counted_init(self, *a):
        calls["span"] += 1
        real_init(self, *a)

    for mod in (torch.profiler, autograd_profiler):
        monkeypatch.setattr(mod, "record_function", counted_rf)
    monkeypatch.setattr(tracer._Span, "__init__", counted_init)
    _, teng = _engines(rounds=1, sched=SCHED)
    _run(teng, obs.RunRecorder() if telemetry == "recorder" else None)
    assert calls["record_function"] == 0
    if telemetry == "null":
        assert calls["span"] == 0
    else:
        assert calls["span"] > len(SPANS | SUBSPANS["tpfl"] | COHORT)


def test_current_is_the_rounds_tracer_and_restored_when_it_raises(
        monkeypatch):
    """Inside a round, code below the engine sees the engine's telemetry
    (a thread it starts sees ``NULL``); after the round, also one that
    raised, ``current()`` is ``NULL`` again."""
    from repro_torch.core import tm as ttm
    _, teng = _engines(rounds=1)
    rec = obs.RunRecorder()
    seen = {}

    def boom(*a, **kw):
        seen["round"] = tracer.current()
        t = threading.Thread(target=lambda: seen.setdefault(
            "thread", tracer.current()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        raise RuntimeError("injected")

    monkeypatch.setattr(ttm, "confidence_scores_batched", boom)
    assert tracer.current() is tracer.NULL
    with pytest.raises(RuntimeError, match="injected"):
        _run(teng, rec)
    assert seen["round"] is rec and seen["thread"] is tracer.NULL
    assert tracer.current() is tracer.NULL
