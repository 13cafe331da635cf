"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload tm-mnist-c10.silo20 --seed 1 \
        --seconds 20 --trace 0

From the root of a checkout, on a machine with the card(s) the cell
asks for.  The cell's files are found by name: ``BENCHMARK.json`` at the
root lists it, ``bench/workloads/<cell>.json`` is its traffic,
``bench/configs/<config>.json`` its configuration, whose ``program``
names the module in ``bench/`` that runs it (``program`` where the key
is absent: the TPFL round) and whose ``reference`` names the plain
reference module; each per-layer metric is read by
``bench/metrics/<metric>.py``.

The program module gives ``make_inputs(config, workload, seed,
device)``; ``Program(config, workload, inputs, seed, device)`` with
``steps`` (a cycle's steps), ``samples`` (the training samples a cycle
trains), ``obs`` (the telemetry slot the spans go into),
``cycle(on_step=None)`` (returns the cycle's last output),
``outcome(out)`` (what must repeat from cycle to cycle; ``None``: the
kind's cycles need not repeat bit for bit) and ``close()``;
``capture(workload, step, *outputs)`` (a step's copy for the check, or
``None`` for a step the check does not read); and ``check(config,
workload, inputs, seed, device, captured, cycles_differing)``, the
numbers that decide ``correct``, each ``{"value", "limit"}``.

Set-up (``setup_s``, from the top of this file): imports, the inputs
made from ``--seed`` on the card, the program's construction, and one
warm-up cycle, which loads (the first run in a checkout: builds) the
kernel libraries under ``build/kernels``.  The window repeats whole
cycles and closes at the first cycle boundary after ``--seconds``.
With ``--trace 1`` the window's steps run with the spans fenced, then
one more cycle runs under ``torch.profiler``; the line then carries the
per-layer metrics and ``breakdown``.  The window keeps nothing of the
check on the card: each cycle's outcome is compared with the first
cycle's on the host, and ``device_peak_gib`` is read as the window
closes.  Only then one more cycle runs, whose steps the module copies
to the host for the check; the program is freed and the module's
``check`` holds the copies against its plain reference.

The last line of standard output is one JSON object; the compared
numbers and their limits are the last lines of standard error and the
line's last key.  Exit codes: 0 with a result; 2 no usable card; 3 the
process loaded JAX or the JAX package; 1 anything else, with no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)
# every kernel cache the program or torch may write, at fixed paths
# inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


class NoCard(RuntimeError):
    pass


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, its entry for the cell, the traffic, the
    configuration)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    workload = json.loads(
        (root / "bench" / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / "bench" / "configs"
                         / f"{workload['config']}.json").read_text())
    return bench, cells[name], workload, config


def metric_reader(name: str):
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_of(config: dict):
    """The module ``bench/<program>.py`` that runs ``config``: its
    ``program`` key, ``program`` (the TPFL round) where it has none."""
    return importlib.import_module(
        f"bench.{config.get('program', 'program')}")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process), each compared whole."""
    tops = {m.split(".")[0] for m in list(names or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_state() -> str:
    """The card's name, power limit, clocks, temperature and draw."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class GcTimer:
    """Counts the collector's passes and their time (a ``gc`` callback)."""

    def __init__(self):
        self.n, self.seconds, self._t = [0, 0, 0], 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.n[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t


def host_speed() -> float:
    """Seconds that a fixed loop of Python takes on this host, least of
    three: a witness of how fast the host ran this process."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        sum(i * i for i in range(1_000_000))
        best = min(best, time.perf_counter() - t)
    return best


def same(a: tuple | None, b: tuple | None) -> bool:
    import torch
    if a is None or b is None:
        return a is b
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None, device: str | None = None, isolation: bool = True,
         cell=None) -> dict:
    """Run the cell; returns the result line's object.  For tests:
    ``device`` names a device (no look for a card), ``isolation=False``
    skips the look for JAX modules, ``cell`` replaces
    :func:`load_cell`'s four parts."""
    args = parse(argv)
    bench, entry, workload, config = cell or load_cell(args.workload)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    t_torch = time.perf_counter()

    from bench import attribution, check, trace
    program = program_of(config)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < entry["chips"]:
            raise NoCard(f"the cell needs {entry['chips']} CUDA device(s); "
                         f"{torch.cuda.device_count()} visible")
        device = "cuda"
    t_card = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.set_num_threads(1)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # -- set-up --------------------------------------------------------
    marks = [time.perf_counter()]
    inputs = program.make_inputs(config, workload, args.seed, dev)
    sync()
    marks.append(time.perf_counter())
    prog = program.Program(config, workload, inputs, args.seed, dev)
    sync()
    marks.append(time.perf_counter())
    peaks = [torch.cuda.max_memory_allocated(dev) if cuda else 0]
    prog.cycle()
    sync()
    marks.append(time.perf_counter())
    peaks.append(torch.cuda.max_memory_allocated(dev) if cuda else 0)
    setup_s = marks[-1] - T_START

    # -- the window: whole cycles ---------------------------------------
    spans = trace.Spans(fenced=True) if args.trace else None
    obs0 = prog.obs
    if spans is not None:
        prog.obs = spans
    first, differing, ends = None, 0, []
    collector = GcTimer()
    gc.callbacks.append(collector)
    t0 = time.perf_counter()
    while not ends or ends[-1] - t0 < args.seconds:
        out = prog.cycle()
        sync()
        last = prog.outcome(out)
        ends.append(time.perf_counter())
        if len(ends) == 1:
            first = last
        else:
            differing += not same(last, first)
    cycles, window_s = len(ends), ends[-1] - t0
    gc.callbacks.remove(collector)
    host_loop = host_speed()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    card = card_state() if cuda else dev.type
    cycle_steps, samples = prog.steps, prog.samples
    steps = cycles * cycle_steps
    profile = {}
    if args.trace:
        from torch.profiler import ProfilerActivity, profile as torch_profile
        tracer = trace.Spans(fenced=False)
        prog.obs = tracer
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with torch_profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.CYCLE):
                prog.cycle()
                sync()
        profile = attribution.reduce_profile(prof, set(tracer.totals))
        del prof

    # -- the checked cycle: its steps copied to the host ----------------
    captured: list = []

    def on_step(r, *outputs):
        got = program.capture(workload, r, *outputs)
        if got is not None:
            captured.append(got)

    prog.obs = obs0
    final = prog.cycle(on_step)
    sync()
    differing += not same(prog.outcome(final), first)
    prog.close()
    del prog, final
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    ref_t0 = time.perf_counter()
    numbers = program.check(config, workload, inputs, args.seed, dev,
                         captured, differing)
    del captured
    marks.append(time.perf_counter())
    correct = check.passed(numbers)

    # -- the line -------------------------------------------------------
    kind = torch.cuda.get_device_name(dev) if cuda else dev.type
    e2e = {"train_samples_per_s": cycles * samples / window_s,
           "device_peak_gib": peak / GIB, "setup_s": setup_s}
    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if args.workload in m.get("workloads", [args.workload]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        chip_peaks = json.loads((BENCH / "peaks.json").read_text())
        ctx = {"config": config, "workload": workload, "profile": profile,
               "spans_ms": {k: 1e3 * v / steps
                            for k, v in spans.totals.items()},
               "round_s": window_s / steps,
               "cycle_rounds": cycle_steps,
               "peak": chip_peaks.get(kind)}
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": kind, "count": entry["chips"], "memory_peak_bytes": peak}}
    if args.trace:
        out["device"]["busy_s"] = profile.get("busy_s", 0.0)
        out["device"]["window_s"] = profile.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": profile.get("device_ops", []),
                            "idle_gaps": profile.get("idle_gaps", [])}
    out["check"] = numbers
    print(f"card at the window's end: {card}", file=sys.stderr)
    print("gc in the window: %d / %d / %d passes (generations 0 / 1 / 2), "
          "%.4f s; host loop %.4f s" % (*collector.n, collector.seconds,
                                       host_loop), file=sys.stderr)
    print("device peak: %d B after init, %d B after the warm-up cycle, "
          "%d B at the window's end" % (*peaks, peak), file=sys.stderr)
    took = sorted(b - a for a, b in zip([t0] + ends, ends))
    print(f"cycles {cycles}, steps {steps}, window {window_s:.3f} s; a "
          f"cycle {took[0]:.4f} / {took[len(took) // 2]:.4f} / "
          f"{took[-1]:.4f} s (least / median / most)", file=sys.stderr)
    print("timing: imports %.2f s (torch %.2f s, the card's query %.2f "
          "s), inputs %.2f s, init %.2f s, warm-up cycle %.2f s, "
          "reference %.2f s" % (
              marks[0] - T_START, t_torch - T_START, t_card - t_torch,
              marks[1] - marks[0], marks[2] - marks[1],
              marks[3] - marks[2], marks[4] - ref_t0), file=sys.stderr)
    if isolation:
        found = forbidden_modules()
        if found:
            print(f"loaded in this process: {', '.join(found)}",
                  file=sys.stderr)
            raise SystemExit(3)
    for k, v in numbers.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    return out


if __name__ == "__main__":
    # Python's bytecode is a build cache too: where the interpreter is
    # told to write none, each run would compile torch's and the
    # program's sources anew (seconds of set-up that follow the host's
    # load).  The checkout keeps it at a fixed path, so only its first
    # run compiles.
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, str(ROOT))
    try:
        result = main()
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        raise SystemExit(2)
    print(json.dumps(result), flush=True)
