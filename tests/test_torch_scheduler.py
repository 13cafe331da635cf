"""The port's scheduler draws the reference's participation (ids,
dropout survival, staleness) from the same round keys, for every
sampling policy with dropout and stragglers off and on; and the
primitives it stands on, ``permutation``, ``choice`` and ``gumbel``,
equal ``jax.random``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.runtime import scheduler as jsched
from repro_torch import random as tr
from repro_torch.fl.runtime import scheduler as tsched
from test_torch_gpu import one_torch_thread  # noqa: F401

N = 20
POLICIES = {"uniform_k_lt_n": dict(participation=0.35),
            "uniform_k_eq_n": dict(participation=1.0),
            "weighted": dict(participation=0.5, sampling="weighted"),
            "weighted_k_eq_n": dict(participation=1.0, sampling="weighted"),
            "round_robin": dict(participation=0.35, sampling="round_robin")}
FAULTS = {"none": {}, "dropout_stragglers": dict(
    dropout=0.25, straggler=0.3, max_staleness=3)}


def _eq(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("faults", FAULTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sample_matches_reference(policy, faults):
    """200 round keys each; the weights are the uneven integer pool
    shares that ``partition`` records."""
    kw = {**POLICIES[policy], **FAULTS[faults]}
    sizes = np.random.default_rng(1).integers(1, 900, N).astype(np.int32)
    js = jsched.Scheduler(jsched.SchedulerConfig(**kw), N,
                          jnp.asarray(sizes))
    ts = tsched.Scheduler(tsched.SchedulerConfig(**kw), N,
                          torch.from_numpy(sizes))
    if ts.p is not None:
        _eq(js.p, ts.p)
    jroot, troot = jax.random.PRNGKey(7), tr.PRNGKey(7, "cpu")
    dropped = late = 0
    for r in range(200):
        a = js.sample(r, jax.random.fold_in(jroot, r))
        b = ts.sample(r, tr.fold_in(troot, r))
        for f in ("idx", "active", "staleness"):
            _eq(getattr(a, f), getattr(b, f))
        dropped += int((~b.active).sum())
        late += int((b.staleness > 0).sum())
    assert (dropped > 0) == (late > 0) == bool(FAULTS[faults])


@pytest.mark.parametrize("kw,in_order,arrive", [
    (dict(), True, True),
    (dict(dropout=0.2), True, False),
    (dict(straggler=0.3, max_staleness=0), True, True),
    (dict(participation=0.5, straggler=0.3), False, False),
    (dict(sampling="weighted"), False, True),
    (dict(sampling="round_robin"), False, True)])
def test_scheduler_flags_and_host_draw(kw, in_order, arrive):
    """``full_in_order``: the cohort is arange(N); ``all_arrive``: no
    upload can miss the barrier.  ``sample`` is ``draw`` on the host."""
    s = tsched.Scheduler(tsched.SchedulerConfig(**kw), N,
                         torch.arange(1, N + 1))
    assert (s.full_in_order, s.all_arrive) == (in_order, arrive)
    for r in range(20):
        key = tr.fold_in(tr.PRNGKey(11, "cpu"), r)
        a, b = s.sample(r, key), s.draw(r, key)
        for f in ("idx", "active", "staleness"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (r, f)
        if in_order:
            assert torch.equal(a.idx, torch.arange(N, dtype=torch.int32))
        if arrive:
            assert bool((a.active & (a.staleness == 0)).all())


def test_scheduler_refuses_bad_weights_and_config():
    with pytest.raises(ValueError, match="sampling"):
        tsched.SchedulerConfig(sampling="random")
    with pytest.raises(ValueError, match="participation"):
        tsched.SchedulerConfig(participation=1.5)
    cfg = tsched.SchedulerConfig(participation=0.5, sampling="weighted")
    with pytest.raises(ValueError, match="shape"):
        tsched.Scheduler(cfg, 4, torch.ones(3))
    with pytest.raises(ValueError, match="non-negative"):
        tsched.Scheduler(cfg, 2, torch.tensor([1.0, -1.0]))


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 2, 20, 333, 1700])
def test_permutation(seed, n):
    """1700 ids take two sort rounds (ceil(3·ln n / ln(2**32 - 1)))."""
    _eq(jax.random.permutation(jax.random.PRNGKey(seed), n),
        tr.permutation(tr.PRNGKey(seed, "cpu"), n))


@pytest.mark.parametrize("seed", range(40))
def test_choice_without_replacement(seed):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed, "cpu")
    rng = np.random.default_rng(seed)
    for n, k in ((20, 5), (20, 20), (7, 1), (300, 64)):
        _eq(jax.random.choice(jk, n, (k,), replace=False),
            tr.choice(tk, n, k))
        w = rng.integers(0, 50, n).astype(np.float32)
        w[rng.integers(0, n)] += 1.0            # a positive sum
        p = w / w.sum()                         # zeros too: log(0) = -inf
        _eq(jax.random.choice(jk, n, (k,), replace=False,
                              p=jnp.asarray(p)),
            tr.choice(tk, n, k, p=torch.from_numpy(p)))


def test_choice_refuses_what_it_does_not_draw():
    key = tr.PRNGKey(0, "cpu")
    with pytest.raises(NotImplementedError):
        tr.choice(key, 5, 2, replace=True)
    with pytest.raises(ValueError):
        tr.choice(key, 5, 6)
    with pytest.raises(ValueError):
        tr.choice(key, 5, 2, p=torch.ones(4) / 4)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
@pytest.mark.parametrize("shape", [(), (7,), (5, 13), (33, 130)])
def test_gumbel(seed, shape):
    _eq(jax.random.gumbel(jax.random.PRNGKey(seed), shape),
        tr.gumbel(tr.PRNGKey(seed, "cpu"), shape))


def test_batched_keys_match_vmap():
    jks = jax.random.split(jax.random.PRNGKey(5), 6)
    tks = tr.split(tr.PRNGKey(5, "cpu"), 6)
    _eq(jax.vmap(lambda k: jax.random.permutation(k, 30))(jks),
        tr.permutation(tks, 30))
    _eq(jax.vmap(lambda k: jax.random.gumbel(k, (4,)))(jks),
        tr.gumbel(tks, (4,)))
