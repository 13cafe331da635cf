"""The port's telemetry plane (``repro_torch.fl.obs``) against the JAX
package's: the recorder never changes what a round computes (on == off
bit for bit), its events carry the reference's non-timing fields for the
same run, the manifest the reference's keys (torch and CUDA versions
where the reference records jax's), ``summarize`` renders a run, and a
telemetry run's manifest rides along with its checkpoints."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.fl import obs as jobs
from repro_torch import convert
from repro_torch.fl import obs
from repro_torch.fl.obs.summarize import main as summarize_main
from repro_torch.fl.runtime import Engine
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401
from test_torch_round import _engines

ROOT = Path(__file__).resolve().parents[1]
SPANS = {"round", "schedule", "gather", "broadcast_encode", "client_step",
         "uplink_codec", "aggregate", "server_update", "downlink",
         "apply_merge", "ref_track", "eval"}
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
        assert set(e["phases"]) == SPANS
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
    assert set(medians) == SPANS


def test_summarize_refuses_a_directory_without_events(tmp_path):
    with pytest.raises(SystemExit, match="not a telemetry run"):
        obs.summarize(tmp_path)


def test_profile_dir_writes_a_trace(tmp_path):
    fed_train.main(["--device", "cpu", "--clients", "2", "--rounds", "1",
                    "--clauses", "8", "--local-epochs", "1",
                    "--profile-dir", str(tmp_path)])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
