"""A second kind of configuration added from new files only: a copy of
the checkout gains a configuration that names its program, that program
module, a traffic file, a metric reader and the entries, and the
copy's ``bench/run.py``, run from the copy's root in a process of its
own, runs it, untraced and traced, reading none of the TM's metrics.
The toy program is one seeded matmul step, ``tanh(h @ w)`` in float32,
held against its plain reference in float64."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench import run

PROGRAM = '''
"""A toy kind: a cycle of ``steps`` steps ``h = tanh(h @ w)``."""
import contextlib

import torch


def make_inputs(config, workload, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    n = config["width"]
    return {"x": torch.randn(workload["batch"], n, generator=g,
                             device=device),
            "w": torch.randn(n, n, generator=g, device=device) / n ** 0.5}


class Program:
    def __init__(self, config, workload, inputs, seed, device):
        self.inputs, self.obs = inputs, None
        self.steps = workload["steps"]
        self.samples = self.steps * workload["batch"]

    def cycle(self, on_step=None):
        h = self.inputs["x"]
        for r in range(self.steps):
            with (self.obs.span("toy_step") if self.obs is not None
                  else contextlib.nullcontext()):
                h = torch.ACT(h @ self.inputs["w"])
            if on_step is not None:
                on_step(r, h)
        return h

    def outcome(self, out):
        return (out.cpu(),)

    def close(self):
        self.inputs = None


def capture(workload, r, h):
    return h.cpu()


def check(config, workload, inputs, seed, device, captured,
          cycles_differing):
    h, w = inputs["x"].double(), inputs["w"].double()
    gap = 0.0
    for got in captured:
        h = torch.tanh(h @ w)
        gap = max(gap, float((got.double() - h).abs().max()))
    return {"max_gap": {"value": gap, "limit": 1e-5},
            "cycles_differing": {"value": cycles_differing, "limit": 0}}
'''
READER = '''
def read(ctx):
    return ctx["spans_ms"].get("toy_step")
'''
CELL = "toy-matmul.steps4"


def _checkout(tmp_path, act):
    """A copy of the checkout with the toy kind added as new files."""
    shutil.copytree(run.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-matmul", "source": "a toy",
                             "file": "bench/configs/toy-matmul.json",
                             "reduced": [], "why": "a second kind"})
    bench["workloads"].append({"name": CELL, "config": "toy-matmul",
                               "traffic": "steps4", "chips": 1,
                               "why": "four steps of 64 rows"})
    bench["per_layer"].append({"name": "toy_step_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "toy step",
                               "moves": "train_samples_per_s",
                               "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "bench"
    (b / "configs" / "toy-matmul.json").write_text(json.dumps(
        {"name": "toy-matmul", "source": "a toy", "program": "toy_step",
         "reference": "toy_step", "width": 32, "reduced": []}))
    (b / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"config": "toy-matmul", "traffic": "steps4", "batch": 64,
         "steps": 4}))
    (b / "toy_step.py").write_text(PROGRAM.replace("ACT", act))
    (b / "metrics" / "toy_step_ms.py").write_text(READER)


# drives the copy's harness on the CPU (no look for a card or for JAX)
# and records, in ``read.json``, every metric reader it loads
DRIVER = """
import json, sys
from bench import run
read = []
reader = run.metric_reader


def recording(name):
    read.append(name)
    return reader(name)


run.metric_reader = recording
out = run.main(sys.argv[1:], device="cpu", isolation=False)
open("read.json", "w").write(json.dumps(read))
print(json.dumps(out))
"""


@pytest.mark.parametrize("act, correct", [("tanh", True),
                                          ("sigmoid", False)])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_second_kind_runs_from_new_files(tmp_path, act, correct, traced):
    _checkout(tmp_path, act)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
    got = subprocess.run(
        [sys.executable, "-c", DRIVER, "--workload", CELL,
         "--seed", str(2 ** 31 + 3), "--seconds", "0.2",
         "--trace", str(traced)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    read = json.loads((tmp_path / "read.json").read_text())
    assert out["correct"] is correct, out["check"]
    assert out["attempted"] % 4 == 0
    assert list(out)[-1] == "check"
    assert out["check"]["cycles_differing"]["value"] == 0
    if not traced:
        assert read == []
        assert set(out["metrics"]) == {"train_samples_per_s",
                                       "device_peak_gib", "setup_s"}
        # the rate is the toy's samples (4 steps of 64 rows) a cycle
        cycles, window = re.search(r"cycles (\d+), steps \d+, window "
                                   r"([\d.]+) s", got.stderr).groups()
        assert out["metrics"]["train_samples_per_s"]["value"] == \
            pytest.approx(int(cycles) * 256 / float(window), rel=1e-2)
    else:
        # a TM reader is never called on another kind's cell
        assert set(read) == {"toy_step_ms", "device.idle_pct"}
        assert set(out["metrics"]) == {"toy_step_ms"}
        assert out["metrics"]["toy_step_ms"]["value"] > 0
