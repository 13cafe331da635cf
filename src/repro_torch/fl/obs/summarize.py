"""The telemetry consumer: render a run directory for humans.

    PYTHONPATH=src python -m repro_torch.fl.obs summarize <run-dir>

Counterpart of ``repro/fl/obs/summarize.py``.  Reads ``manifest.json`` +
``events.jsonl`` (written by ``fed_train --telemetry-dir`` or any
:class:`~repro_torch.fl.obs.recorder.RunRecorder`) and prints three
views:

* the **round table** — accuracy (mean and worst-decile), wire bytes by
  direction, participation, async buffer counters, per round;
* the **phase breakdown** — median wall time per round stage and its
  share of the round, the where-does-round-time-go view every perf PR
  reports against, then the spans inside the stages (``SUBSPANS``:
  key chain, epoch, confidence, top class, eval scatter and votes)
  apart, left out of ``Σ stages``;
* the **client-accuracy deciles** of the final round — the
  distributional (worst-k) personalization metric, not just the mean.

Pure consumer: it only reads the run directory, so it can run anywhere
the JSONL landed (CI artifacts included).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from repro_torch.fl.obs import manifest as mf
from repro_torch.fl.obs.events import read_events
from repro_torch.fl.obs.tracer import SUBSPANS


def _fmt_bytes(n: int | None) -> str:
    if n is None:
        return "-"
    if n >= 1e6:
        return f"{n / 1e6:.2f}MB"
    if n >= 1e3:
        return f"{n / 1e3:.1f}kB"
    return f"{n}B"


def _manifest_header(manifest: dict | None) -> list[str]:
    if not manifest:
        return ["manifest: (none found)"]
    cfg = manifest.get("config") or {}
    mesh = manifest.get("mesh")
    mesh_s = ("x".join(f"{k}:{v}" for k, v in mesh.items())
              if mesh else "in-process")
    parts = [
        f"strategy={manifest.get('strategy', '?')}",
        f"dataset={manifest.get('dataset', '?')}",
        f"backend={cfg.get('backend', 'inprocess')}",
        f"aggregation={cfg.get('aggregation', 'sync')}",
        f"mesh={mesh_s}",
        f"seed={manifest.get('seed')}",
    ]
    prov = [
        f"torch={manifest.get('torch_version')}",
        f"cuda={manifest.get('cuda_version')}",
        f"devices={((manifest.get('devices') or {}).get('count'))}",
        f"git={str(manifest.get('git_sha'))[:12]}",
    ]
    return ["run: " + "  ".join(parts), "env: " + "  ".join(prov)]


def _round_table(events: list[dict]) -> list[str]:
    head = (f"{'round':>5}  {'acc':>7}  {'w10%':>7}  {'up':>9}  "
            f"{'down_bc':>9}  {'down_pc':>9}  {'arrived':>7}  "
            f"{'agg':>4}  {'buf':>4}  {'evict':>5}  {'churn':>5}")
    lines = [head, "-" * len(head)]
    for e in events:
        acc = e.get("accuracy") or {}
        by = e.get("bytes") or {}
        sch = e.get("scheduler") or {}
        asy = e.get("async") or {}
        cl = e.get("cluster") or {}
        churn = cl.get("churn_vs_prev")
        lines.append(
            f"{e.get('round', '?'):>5}  "
            f"{acc.get('mean', float('nan')):>7.4f}  "
            f"{acc.get('worst_decile_mean', float('nan')):>7.4f}  "
            f"{_fmt_bytes(by.get('upload')):>9}  "
            f"{_fmt_bytes(by.get('download_broadcast')):>9}  "
            f"{_fmt_bytes(by.get('download_per_client')):>9}  "
            f"{sch.get('arrived_on_time', '-'):>7}  "
            f"{asy.get('aggregated', '-'):>4}  "
            f"{asy.get('buffered', '-'):>4}  "
            f"{asy.get('evicted', '-'):>5}  "
            + (f"{churn:>5.2f}" if churn is not None else f"{'-':>5}"))
    return lines


def phase_medians(events: list[dict]) -> dict[str, float]:
    """Median wall seconds per phase over the rounds that recorded it."""
    acc: dict[str, list[float]] = {}
    for e in events:
        for name, dt in (e.get("phases") or {}).items():
            acc.setdefault(name, []).append(float(dt))
    return {name: float(np.median(v)) for name, v in acc.items()}


def _phase_table(events: list[dict]) -> list[str]:
    """The stages by median time, then the spans inside them
    (``SUBSPANS``) apart, so ``Σ stages`` counts each moment once."""
    med = phase_medians(events)
    if not med:
        return ["(no phase spans recorded)"]
    stages = {k: v for k, v in med.items()
              if k != "round" and k not in SUBSPANS}
    inner = {k: v for k, v in med.items() if k in SUBSPANS}
    total = med.get("round") or sum(stages.values())
    lines = [f"{'phase':<18} {'median_s':>10} {'share':>7}",
             "-" * 37]

    def rows(spans, indent=""):
        for name, dt in sorted(spans.items(), key=lambda kv: -kv[1]):
            share = f"{100.0 * dt / total:>6.1f}%" if total else "      -"
            lines.append(f"{indent + name:<18} {dt:>10.4f} {share}")

    rows(stages)
    lines.append("-" * 37)
    lines.append(f"{'Σ stages':<18} {sum(stages.values()):>10.4f}")
    if "round" in med:
        lines.append(f"{'round total':<18} {med['round']:>10.4f}")
    if inner:
        lines.append("inside the stages:")
        rows(inner, "  ")
    return lines


def _decile_table(event: dict) -> list[str]:
    acc = event.get("accuracy") or {}
    deciles = acc.get("deciles")
    if not deciles:
        return ["(no decile data)"]
    labels = [f"p{10 * i}" for i in range(len(deciles))]
    return [
        "  ".join(f"{lb:>6}" for lb in labels),
        "  ".join(f"{d:>6.3f}" for d in deciles),
        f"worst-decile mean = {acc.get('worst_decile_mean'):.4f}   "
        f"population mean = {acc.get('mean'):.4f}",
    ]


def summarize(run_dir: str | pathlib.Path, out=None) -> dict:
    """Render the run; returns the parsed (manifest, events) payload so
    tests and tooling can assert on it."""
    out = out or sys.stdout
    run_dir = pathlib.Path(run_dir)
    events_path = run_dir / mf.EVENTS_NAME
    if not events_path.is_file():
        raise SystemExit(f"no {mf.EVENTS_NAME} in {run_dir} — not a "
                         f"telemetry run directory")
    manifest = mf.read_manifest(run_dir)
    events = read_events(events_path)

    w = lambda s="": print(s, file=out)
    for line in _manifest_header(manifest):
        w(line)
    w(f"rounds: {len(events)}")
    w()
    for line in _round_table(events):
        w(line)
    w()
    w("per-phase wall time (median over rounds):")
    for line in _phase_table(events):
        w("  " + line)
    if events:
        w()
        w(f"client accuracy deciles (round {events[-1].get('round')}):")
        for line in _decile_table(events[-1]):
            w("  " + line)
    return {"manifest": manifest, "events": events}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fl.obs",
        description="Federated telemetry consumers")
    sub = ap.add_subparsers(dest="command", required=True)
    s = sub.add_parser("summarize",
                       help="render a telemetry run directory: round "
                            "table, phase breakdown, accuracy deciles")
    s.add_argument("run_dir", help="directory holding manifest.json + "
                                   "events.jsonl (fed_train "
                                   "--telemetry-dir output)")
    args = ap.parse_args(argv)
    if args.command == "summarize":
        summarize(args.run_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
