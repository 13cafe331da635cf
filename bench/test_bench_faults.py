"""The comparison fails a broken timed path: the harness runs on the
CPU (no look for a card) with a fault planted in the program, and
``correct`` comes out false.  One test a fault the cells can have: a
training step that returns its state unchanged, half the uploads left
out of the mean, an answer (an accuracy, an upload's class) altered
where it is produced.  No cell spans chips, so none has an exchange
between chips to leave out.  The control, the reference put in the
program's place in bfloat16, fails too."""
import pytest
import torch

from bench import check, program, ref_tm, tiny


def _fails(out, *names):
    assert out["correct"] is False
    bad = [k for k, v in out["check"].items() if v["value"] > v["limit"]]
    assert set(names) <= set(bad), out["check"]


def test_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "train_epoch_fused",
                        lambda ta, w, *a, **k: (ta, w))
    _fails(tiny.run_tiny(rounds_checked=1), "ta_states")


def test_half_the_uploads_left_out_of_the_mean(monkeypatch):
    from repro_torch.core import clustering
    orig = clustering.aggregate

    def half(uploads, assignment, n_clusters, prev=None):
        n = uploads.shape[0] // 2
        return orig(uploads[:n], assignment[:n], n_clusters, prev)
    monkeypatch.setattr(clustering, "aggregate", half)
    _fails(tiny.run_tiny(rounds_checked=1, cohort=6), "server")


def test_accuracy_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core import tm
    orig = tm.accuracy_batched

    def altered(params, x, y, cfg):
        acc = orig(params, x, y, cfg).clone()
        acc[0] += 0.1
        return acc
    monkeypatch.setattr(tm, "accuracy_batched", altered)
    _fails(tiny.run_tiny(rounds_checked=1), "accuracy")


def test_upload_class_altered_where_it_is_produced(monkeypatch):
    from repro_torch.fl.runtime import strategy
    orig = strategy.TPFLStrategy.fused_client_step

    def altered(self, cs, slots, d, keys):
        params, up = orig(self, cs, slots, d, keys)
        s = up.slots.clone()
        s[0] = (s[0] + 1) % self.tm_cfg.n_classes
        return params, up._replace(slots=s)
    monkeypatch.setattr(strategy.TPFLStrategy, "fused_client_step", altered)
    _fails(tiny.run_tiny(rounds_checked=1), "cluster_counts")


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_in_bfloat16_is_refused(seed):
    """The reference in bfloat16 where the configuration states float32
    (activation probability, its compare, the mean), in the program's
    place, against the float32 reference."""
    bench, entry, workload, config = tiny.cell(cohort=6)
    from bench import traffic
    tm = ref_tm.TM.of(config)
    data = traffic.make(config, workload, seed, "cpu")
    key = program.threefry.key(seed)
    _, got = ref_tm.run_round(tm, ref_tm.init_state(tm, key, 6), data, key,
                              0, 6, lowp=True)
    _, want = ref_tm.run_round(tm, ref_tm.init_state(tm, key, 6), data, key,
                               0, 6)
    numbers = check.compare(got, want, 0)
    assert not check.passed(numbers), numbers
    assert numbers["ta_states"]["value"] > 0
    assert torch.equal(got["idx"], want["idx"])


def test_later_cycles_that_drift_from_the_first_are_refused(monkeypatch):
    """A program whose answers change after the window's first cycle,
    so the checked cycle after the window differs from it."""
    from repro_torch.core import tm
    orig, calls = tm.accuracy_batched, []

    def drifting(params, x, y, cfg):
        calls.append(1)
        acc = orig(params, x, y, cfg)
        return acc + 0.1 if len(calls) > 10 else acc
    monkeypatch.setattr(tm, "accuracy_batched", drifting)
    _fails(tiny.run_tiny(rounds_checked=1), "cycles_differing")

