"""The frozen least-time counts, pinned on hand-worked shapes, and the
peaks they are held against."""
import json

import pytest

from bench import run
from bench.costs import common, round as round_cost, train_epoch, votes

MNIST = {"n_classes": 10, "n_clauses": 300, "n_features": 784,
         "n_states": 63, "local_epochs": 2}
PEAK = json.loads((run.BENCH / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


def test_peaks_are_the_h100_data_sheet():
    assert PEAK["hbm_bytes_per_s"] == 3.35e12
    assert PEAK["int8_tensor_ops_per_s"] == 1.979e15
    assert PEAK["bf16_tensor_flops_per_s"] == 9.894e14


def test_state_bits():
    assert common.state_bits(63) == 7       # states 1..126
    assert common.state_bits(64) == 7       # states 1..128
    assert common.state_bits(127) == 8
    assert common.class_bits(10) == 4 and common.class_bits(62) == 6


def test_train_epoch_count_silo20():
    c = train_epoch.count(MNIST, 20, 2400)
    # 20 clients x 2400 samples x 2 classes x 300 clauses x 1568
    # literals, two operations a multiply-add
    assert c["ops"] == 90_316_800_000
    # TA states at 7 bits, read and written: 2 x 82,320,000 B; weights
    # at 16 bits both ways: 240,000 B; 784 bits and a 4-bit label a
    # sample: 4,728,000 B
    assert c["bytes"] == 164_640_000 + 240_000 + 4_728_000
    # bound by bytes: 50.6 us against 45.6 us of operations
    assert common.seconds(c, PEAK) == pytest.approx(169_608_000 / 3.35e12)


def test_votes_count_eval_silo20():
    c = votes.count(MNIST, 20, 300)
    assert c["ops"] == 56_448_000_000 + 36_000_000
    # include bits 11,760,000; weights 120,000; samples 588,000; votes
    # written 240,000
    assert c["bytes"] == 12_708_000
    assert common.seconds(c, PEAK) == pytest.approx(56_484_000_000
                                                    / 1.979e15)


def test_round_count_is_its_parts():
    wl = {"cohort": 20, "population": 20,
          "per_client": {"train": 2400, "test": 300, "conf": 300}}
    c = round_cost.count(MNIST, wl)
    e, v = train_epoch.count(MNIST, 20, 2400), votes.count(MNIST, 20, 300)
    assert c["ops"] == 2 * e["ops"] + 2 * v["ops"]
    assert c["bytes"] == 2 * e["bytes"] + 2 * v["bytes"] + 4 * 300 * 30


def test_a_sum_is_bounded_once():
    a, b = {"ops": 1.979e15, "bytes": 0}, {"ops": 0, "bytes": 3.35e12}
    # one second of each could overlap: the sum's least time is 1 s
    assert common.seconds(common.add(a, b), PEAK) == 1.0
