"""The plain reference equals ``Engine.run_round``: every round of a
whole cycle, its outputs and byte counts, at a size the CPU holds, at 10
and at 62 classes, with a sampled cohort and under full participation.
The harness drives the engine and the comparison as a chip run does."""
import pytest

from bench import check, tiny


@pytest.mark.parametrize("n_classes,population,cohort,partition", [
    (10, 6, 3, None),
    (62, 6, 2, {"kind": "writers", "mix_alpha": 0.3}),
    (10, 6, 6, None),
])
def test_reference_equals_engine_over_a_cycle(n_classes, population,
                                               cohort, partition):
    out = tiny.run_tiny(seed=2 ** 31 + 17, n_classes=n_classes,
                        population=population, cohort=cohort,
                        partition=partition)
    assert list(out["check"]) == list(check.NAMES)
    assert all(v["value"] == 0 for v in out["check"].values()), out["check"]
    assert out["correct"] is True
    assert out["attempted"] % 5 == 0
    assert set(out["metrics"]) == {"train_samples_per_s", "device_peak_gib",
                                   "setup_s"}


def test_traced_run_reports_the_span_metrics():
    out = tiny.run_tiny(seed=11, trace=1, n_classes=10, population=6,
                        cohort=3, rounds_checked=1)
    assert out["correct"] is True
    # the tiny cell reads the silo cell's span metrics, gather_ms with them
    for name in ("gather_ms", "client_step_ms", "aggregate_ms", "eval_ms"):
        assert out["metrics"][name]["value"] > 0
    # no card: no device metric is read on the CPU
    for name in ("train_epoch_roofline", "votes_roofline", "round_mfu_pct",
                 "device.idle_pct", "launches_per_round",
                 "key_chain.launches", "aggregate.launches",
                 "eval_scatter.device_ms"):
        assert name not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "check"


def test_inputs_follow_the_seed():
    import torch

    from bench import traffic
    bench, entry, workload, config = tiny.cell()
    a = traffic.make(config, workload, 2 ** 31 + 5, "cpu")
    b = traffic.make(config, workload, 2 ** 31 + 5, "cpu")
    c = traffic.make(config, workload, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x_train"], c["x_train"])
    assert a["x_train"].shape == (6, 20, 144)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 3 * 2 ** 32 + 11])
def test_frozen_threefry_draws_the_programs_bits(seed):
    import torch
    from repro_torch import random as rnd

    from bench import threefry as tf
    k = tf.key(seed)
    assert torch.equal(rnd.PRNGKey(seed, "cpu"), k)
    ks = tf.split(k, 4)
    assert torch.equal(rnd.split(k, 4), ks)
    assert torch.equal(rnd.fold_in(k, 0x5C4ED), tf.fold_in(k, 0x5C4ED))
    assert torch.equal(rnd.bits(ks, (3, 7)), tf.bits(ks, (3, 7)))
    assert torch.equal(rnd.uniform(ks, (50,)), tf.uniform(ks, (50,)))
    assert torch.equal(rnd.randint(ks, (9,), 1, 62),
                       tf.randint(ks, (9,), 1, 62))
    assert torch.equal(rnd.permutation(k, 1000).long(),
                       tf.permutation(k, 1000))
