"""The keyed TA transition of one sample step against the JAX package.

``ta_update.ta_update_plain`` (the plain version of the CUDA kernel
``csrc/ta_update.cu``: both feedback roles of every client, drawn from
the step's role keys) is bit-equal to ``repro.core.tm._feedback_one_class``
applied to the target bank and then to the negative one, on its jnp path
and on its Pallas kernel in interpret mode; the unit-weight scan that
feeds it from one key chain per epoch is bit-equal to
``repro.core.tm.train_batched(weighted=False)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tm as jtm
from repro_torch import random as tr
from repro_torch.core import tm as ttm
from repro_torch.kernels import ops
from repro_torch.kernels import ta_update as tta
from test_torch_gpu import _step_inputs, one_torch_thread  # noqa: F401

N, C, T, N_STATES = 2, 4, 15, 63
S_ = 10.0     # p_inc = 0.9, whose float32 lies below it; p_dec = 0.1
KW = dict(T=T, p_inc=(S_ - 1.0) / S_, p_dec=1.0 / S_, n_states=N_STATES)


def _jax_step(ta, lits, fired, votes, cls2, keys, m, L, use_kernel):
    """The reference: per client, _feedback_one_class on the target bank
    under k_t, then on the negative bank under k_n, both from the clause
    outputs and votes before either update."""
    cfg = jtm.TMConfig(n_classes=C, n_clauses=m, n_features=L // 2,
                       n_states=N_STATES, s=S_, T=T,
                       weighted=False, use_kernel=use_kernel)
    out = []
    for n in range(ta.shape[0]):
        bank = jnp.asarray(ta[n])
        w = jnp.ones((m,), jnp.int32)
        for role, is_target in ((0, True), (1, False)):
            c = int(cls2[n, role])
            key = jnp.asarray(keys[n, role], dtype=jnp.uint32)
            new, _ = jtm._feedback_one_class(
                bank[c], w, jnp.asarray(lits[n]), jnp.asarray(fired[n, c]),
                jnp.asarray(votes[n, c]), is_target, key, cfg)
            bank = bank.at[c].set(new)
        out.append(np.asarray(bank))
    return np.stack(out)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("role", [0, 1])
@pytest.mark.parametrize("vote", [-T - 3, -T, 0, T, T + 3])
@pytest.mark.parametrize("m,L", [(16, 128), (33, 130)])
def test_plain_matches_feedback_one_class(m, L, vote, role, use_kernel):
    """Bit-equal for both roles; the vote of ``role``'s class is ``vote``
    (clipped to ±T by both), the other role's a random one in [-T/2, T/2],
    so that role always has active clauses."""
    rng = np.random.default_rng(m * 100 + vote * 3 + role)
    ta, lits, fired, votes, cls2, keys = _step_inputs(rng, N, C, m, L,
                                                      N_STATES, T)
    votes[np.arange(N), cls2[:, role]] = vote
    votes[np.arange(N), cls2[:, 1 - role]] = rng.integers(-T // 2, T // 2 + 1,
                                                          N)
    want = _jax_step(ta, lits, fired, votes, cls2, keys, m, L, use_kernel)
    # the port's role keys: split(k_role, 3) = [k_act, k_s1, k_s2]
    role_keys = tr.split(torch.as_tensor(keys), 3)
    t = [torch.tensor(a) for a in (ta, lits, fired, votes, cls2)]
    stats = {}
    got = tta.ta_update_plain(*t, role_keys, **KW, stats=stats)
    assert got is t[0]                                    # in place
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != ta).any()
    assert stats["type1_rows"] > 0


def test_cpu_dispatch_is_the_plain_version_in_place_and_uncounted():
    rng = np.random.default_rng(1)
    ta, lits, fired, votes, cls2, keys = _step_inputs(rng, 3, C, 33, 130,
                                                      N_STATES, T)
    role_keys = tr.split(torch.as_tensor(keys), 3)
    t = [torch.tensor(a) for a in (ta, lits, fired, votes, cls2)]
    want = tta.ta_update_plain(t[0].clone(), *t[1:], role_keys, **KW)
    before = dict(ops.LAUNCHES)
    got = ops.ta_update_(*t, role_keys, **KW)
    assert got is t[0] and torch.equal(got, want)
    assert ops.LAUNCHES == before


def test_plain_refuses_equal_classes_and_bad_ids():
    rng = np.random.default_rng(2)
    ta, lits, fired, votes, cls2, keys = _step_inputs(rng, 3, C, 16, 128,
                                                      N_STATES, T)
    role_keys = tr.split(torch.as_tensor(keys), 3)
    t = [torch.tensor(a) for a in (ta, lits, fired, votes)]
    same = cls2.copy()
    same[1, 1] = same[1, 0]
    with pytest.raises(ValueError, match="same class for both roles of "
                                         "client 1"):
        tta.ta_update_plain(*t, torch.as_tensor(same), role_keys, **KW)
    out = cls2.copy()
    out[0, 1] = C
    with pytest.raises(ValueError, match="outside"):
        ops.ta_update_(*t, torch.as_tensor(out), role_keys, **KW)
    assert torch.equal(t[0], torch.as_tensor(ta))     # nothing was written


@pytest.mark.parametrize("shape", [
    dict(n_classes=3, n_clauses=33, n_features=65),     # L = 130, C·m = 99
    dict(n_classes=10, n_clauses=48, n_features=144)])  # fed_train's default
def test_unweighted_scan_matches_jax(shape):
    """Two epochs of the unit-weight scan (one draws.epoch_keys chain an
    epoch, one ta_update_ a sample step) against the reference's vmapped
    scan; weights never move."""
    n, S = 2, 5
    kw = dict(shape, n_states=N_STATES, s=5.0, T=T, weighted=False)
    jcfg, tcfg = jtm.TMConfig(**kw), ttm.TMConfig(**kw)
    rng = np.random.default_rng(shape["n_clauses"])
    xs = (rng.random((n, S, shape["n_features"])) < 0.4).astype(np.int32)
    ys = rng.integers(0, shape["n_classes"], (n, S)).astype(np.int32)
    jp = jax.vmap(lambda k: jtm.init_params(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(3), n))
    tp = ttm.init_params(tcfg, tr.split(tr.PRNGKey(3, "cpu"), n))
    a = jtm.train_batched(jp, jnp.asarray(xs), jnp.asarray(ys),
                          jax.random.split(jax.random.PRNGKey(4), n), jcfg,
                          epochs=2)
    b = ttm.train_batched(tp, torch.as_tensor(xs), torch.as_tensor(ys),
                          tr.split(tr.PRNGKey(4, "cpu"), n), tcfg, epochs=2)
    np.testing.assert_array_equal(np.asarray(a.ta_state), b.ta_state)
    np.testing.assert_array_equal(np.asarray(a.weights), b.weights)
    assert (b.ta_state != tp.ta_state).any()
    assert torch.equal(b.weights, tp.weights)
