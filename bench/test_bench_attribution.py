"""Launches and device time by span (``bench/attribution.py``) on a
hand-built capture: nested spans, launches found by their correlation
ids among frontend ops that share the numbers, an unspanned copy, and
the ``key_chain_ms`` reader."""
import math
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench import attribution, run, trace

SPANS = {"client_step", "key_chain", "train_epoch", "eval", "eval_scatter"}


def _ev(name, start, end, dev=False, cid=0):
    return SimpleNamespace(
        name=name, id=cid, device_type=DeviceType.CUDA if dev
        else DeviceType.CPU, time_range=SimpleNamespace(start=start,
                                                        end=end))


def _capture():
    """A cycle of [0, 1000] µs.  Host spans: client_step [100, 500] with
    key_chain [110, 200] and train_epoch [200, 480] in it, eval [600,
    900] with eval_scatter [610, 700].  Each device operation has its
    runtime call (same id, a ``cu...`` name), one of them after the
    operation's start by the device's clock; frontend ops reuse ids."""
    return [
        _ev(trace.CYCLE, 0, 1000),
        _ev("client_step", 100, 500), _ev("key_chain", 110, 200),
        _ev("train_epoch", 200, 480), _ev("eval", 600, 900),
        _ev("eval_scatter", 610, 700),
        # the annotations' ranges on the device timeline are no work
        _ev("client_step", 150, 480, dev=True, cid=1),
        # key chain: two kernels; an aten op with id 11 starts later
        _ev("cudaLaunchKernel", 120, 125, cid=11),
        _ev("k_xor", 150, 152, dev=True, cid=11),
        _ev("aten::add", 300, 305, cid=11),
        _ev("cudaLaunchKernel", 130, 135, cid=12),
        _ev("k_shift", 152, 160, dev=True, cid=12),
        # kernel 1, launched in train_epoch, runs long after its launch
        _ev("aten::copy_", 205, 210, cid=13),
        _ev("cuLaunchKernel", 210, 215, cid=13),
        _ev("train_epoch_kernel", 220, 470, dev=True, cid=13),
        # client_step's own launch, outside its sub-spans; the device's
        # clock puts the kernel before its call
        _ev("cudaLaunchKernel", 485, 490, cid=14),
        _ev("k_sort", 470, 475, dev=True, cid=14),
        # the eval's scatter copy, and its votes after the sub-span
        _ev("cudaMemcpyAsync", 620, 625, cid=15),
        _ev("Memcpy DtoD (Device -> Device)", 630, 690, dev=True, cid=15),
        _ev("cudaLaunchKernel", 710, 715, cid=16),
        _ev("votes_mma_kernel", 720, 800, dev=True, cid=16),
        # an unspanned copy (the cycle's restore), and an operation whose
        # call the capture lacks
        _ev("cudaMemcpyAsync", 10, 15, cid=17),
        _ev("Memcpy DtoD (Device -> Device)", 20, 90, dev=True, cid=17),
        _ev("Memset (Device)", 940, 950, dev=True, cid=99),
        # a kernel that runs past the cycle's end counts up to it
        _ev("cudaLaunchKernel", 910, 915, cid=18),
        _ev("k_tail", 990, 1010, dev=True, cid=18),
        # outside the cycle: not kept
        _ev("cudaLaunchKernel", 1005, 1006, cid=19),
        _ev("k_after", 1020, 1030, dev=True, cid=19),
    ]


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


def test_the_reducers_keys_are_unchanged():
    prof = _Prof(_capture())
    base = trace.reduce_profile(prof, SPANS)
    got = attribution.reduce_profile(prof, SPANS)
    assert set(got) == set(base) | {"launches_by_span", "device_s_by_span"}
    assert {k: got[k] for k in base} == base


def test_launches_go_to_the_innermost_span_of_their_call():
    got = attribution.reduce_profile(_Prof(_capture()), SPANS)
    outside = attribution.OUTSIDE
    assert got["launches_by_span"] == {
        "key_chain": 2, "train_epoch": 1, "client_step": 1,
        "eval_scatter": 1, "eval": 1, outside: 3}
    want_us = {"key_chain": 2 + 8, "train_epoch": 250, "client_step": 5,
               "eval_scatter": 60, "eval": 80, outside: 70 + 10 + 10}
    for name, us in want_us.items():
        assert math.isclose(got["device_s_by_span"][name], us * 1e-6,
                            rel_tol=1e-12), name


def test_the_counts_sum_to_the_operations_kept():
    events = _capture()
    got = attribution.reduce_profile(_Prof(events), SPANS)
    kept = [e for e in events if trace._is_device(e)
            and e.name not in SPANS and e.time_range.end > 0
            and e.time_range.start < 1000]
    assert sum(got["launches_by_span"].values()) == len(kept) == 9
    assert math.isclose(sum(got["device_s_by_span"].values()),
                        sum(got["kernel_s"].values()), rel_tol=1e-12)
    # the idle gaps keep their rule: the first gap, before the restore
    # copy, lies outside every span
    assert dict(got["idle_gaps"])[attribution.OUTSIDE] > 0


def test_no_cycle_gives_nothing():
    events = [e for e in _capture() if e.name != trace.CYCLE]
    assert attribution.reduce_profile(_Prof(events), SPANS) == {}
    assert attribution.by_span(events, SPANS) == {}


@pytest.mark.parametrize("spans_ms, want", [
    ({"client_step": 40.0, "key_chain": 12.5}, 12.5),
    ({"client_step": 40.0}, None)])
def test_key_chain_ms_reads_its_span(spans_ms, want):
    assert run.metric_reader("key_chain_ms")({"spans_ms": spans_ms}) == want


def test_a_traced_run_reports_key_chain_ms():
    """The harness reads the program's ``key_chain`` span in a traced
    run (the tiny cell on the CPU, which reads the TM cells' metrics)."""
    from bench import tiny
    bench, entry, workload, config = tiny.cell(rounds_checked=1)
    out = run.main(["--workload", "tiny", "--seed", "11", "--seconds", "0.1",
                    "--trace", "1"], device="cpu", isolation=False,
                   cell=(bench, entry, workload, config))
    assert out["correct"] is True
    got = out["metrics"]["key_chain_ms"]
    assert got["unit"] == "ms"
    assert 0 < got["value"] < out["metrics"]["client_step_ms"]["value"]


def _with_aggregate():
    """The hand-built capture and an ``aggregate`` span [920, 980] that
    launches two kernels."""
    return _capture() + [
        _ev("aggregate", 920, 980),
        _ev("cudaLaunchKernel", 925, 926, cid=20),
        _ev("k_add", 930, 934, dev=True, cid=20),
        _ev("cudaLaunchKernel", 935, 936, cid=21),
        _ev("k_add", 936, 939, dev=True, cid=21)]


@pytest.mark.parametrize("metric, want", [
    ("launches_per_round", 11 / 2),
    ("key_chain.launches", 2 / 2),
    ("aggregate.launches", 2 / 2),
    ("eval_scatter.device_ms", 60e-3 / 2)])
def test_the_launch_readers_read_the_capture_by_span(metric, want):
    """Each launch reader on the capture over a cycle of two rounds;
    nothing where the profile counted no device operation (a CPU run)
    or holds no cycle."""
    read = run.metric_reader(metric)
    prof = attribution.reduce_profile(_Prof(_with_aggregate()),
                                      SPANS | {"aggregate"})
    assert math.isclose(read({"profile": prof, "cycle_rounds": 2}), want,
                        rel_tol=1e-12)
    cpu = [e for e in _with_aggregate() if not trace._is_device(e)]
    empty = attribution.reduce_profile(_Prof(cpu), SPANS | {"aggregate"})
    assert empty["launches_by_span"] == {}
    for profile in (empty, {}):
        assert read({"profile": profile, "cycle_rounds": 2}) is None
