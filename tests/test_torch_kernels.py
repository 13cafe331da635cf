"""The port's kernel path against the JAX package's, on inputs made with
numpy: ``epoch_draws`` and every kernel's plain version are bit-equal to
``repro.kernels`` (Pallas in interpret mode on the CPU).  The CUDA
kernels are held against these plain versions in test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import clause_eval as jce
from repro.kernels import draws as jdraws
from repro.kernels import ops as jops
from repro.kernels import ta_update as jta
from repro_torch import random as tr
from repro_torch.kernels import draws, ops, ref
from test_torch_gpu import (TA_P, VOTE_SHAPES, _draws,  # noqa: F401
                            _epoch_inputs, _t, _ta_inputs, _vote_inputs,
                            one_torch_thread)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,m,L,C", [(17, 33, 130, 3), (4, 16, 32, 10)])
def test_epoch_draws_bit_equal(seed, S, m, L, C):
    jk = jax.random.PRNGKey(seed)
    a = jdraws.epoch_draws(jk, S, m, L, C, 2.0 / 3.0, 1.0 / 3.0)
    b = draws.epoch_draws(tr.PRNGKey(seed, "cpu"), S, m, L, C, 2.0 / 3.0, 1.0 / 3.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # batched keys = vmap over per-client keys
    jks = jax.random.split(jk, 3)
    a = jax.vmap(lambda k: jdraws.epoch_draws(k, S, m, L, C, 0.8, 0.2))(jks)
    b = draws.epoch_draws(tr.split(tr.PRNGKey(seed, "cpu"), 3), S, m, L, C, 0.8, 0.2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("p", [0.2, 1.0 / 3.0, 2.0 / 3.0, 1e-7, 1.0])
def test_int_threshold(p):
    assert draws.int_threshold(p) == jdraws.int_threshold(p)


@pytest.mark.parametrize("shape", VOTE_SHAPES)
@pytest.mark.parametrize("predict", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_votes_batched_ref_matches_jax(shape, predict, seed):
    include, lits, wpol = _vote_inputs(np.random.default_rng(seed), *shape)
    want = np.asarray(jops.fused_votes_batched(
        jnp.asarray(include), jnp.asarray(lits), jnp.asarray(wpol),
        predict=predict))
    got = ref.fused_votes_batched_ref(*_t(include, lits, wpol), predict)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors dispatch to the plain version, uncounted
    before = dict(ops.LAUNCHES)
    np.testing.assert_array_equal(
        ops.fused_votes_batched(*_t(include, lits, wpol), predict).numpy(),
        want)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("shape", VOTE_SHAPES[:2])
@pytest.mark.parametrize("predict", [True, False])
def test_clause_outputs_and_fused_votes_ref_match_pallas(shape, predict):
    """Kernels 3 and 4 of the single-model path (C·m = 64 at L = 32, and
    the tile-unaligned C·m = 99 at L = 130), one model at a time, and the
    plain versions' leading batch axis."""
    N, C, m, L, B = shape
    include, lits, wpol = _vote_inputs(np.random.default_rng(5), *shape)
    fired = ref.clause_outputs_ref(*_t(include.reshape(N, C * m, L), lits),
                                   predict)
    votes = ref.fused_votes_ref(*_t(include, lits, wpol), predict)
    for n in range(N):
        want = jce.clause_outputs_pallas(
            jnp.asarray(include[n].reshape(C * m, L)), jnp.asarray(lits[n]),
            predict=predict, interpret=True)
        got = ops.clause_outputs(*_t(include[n].reshape(C * m, L), lits[n]),
                                 predict)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(fired[n].numpy(), np.asarray(want))
        want = jce.fused_votes_pallas(
            jnp.asarray(include[n]), jnp.asarray(lits[n]),
            jnp.asarray(wpol[n]), predict=predict, interpret=True)
        got = ops.fused_votes(*_t(include[n], lits[n], wpol[n]), predict)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(votes[n].numpy(), np.asarray(want))


@pytest.mark.parametrize("m,L", [(16, 128), (33, 130)])
def test_ta_update_ref_matches_pallas(m, L):
    """Kernel 5, one bank at a time and with the leading batch axis.  A
    third of the uniforms equal float32(p), which lies below p: a float64
    compare would move those states, the reference's float32 one does
    not."""
    NB, n_states = 3, 63
    args = _ta_inputs(np.random.default_rng(m), NB, m, L, n_states)
    kw = dict(p_inc=TA_P[0], p_dec=TA_P[1], n_states=n_states)
    got = ref.ta_update_ref(*_t(*args), **kw)
    assert got.dtype == torch.int32
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.ta_update(*_t(*args), **kw), got)
    assert ops.LAUNCHES == before
    for n in range(NB):
        want = jta.ta_update_pallas(*(jnp.asarray(a[n]) for a in args),
                                    interpret=True, **kw)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want))
    assert (got.numpy() != args[0]).any()
    u_inc = args[5]
    assert ((u_inc.astype(np.float64) < TA_P[0])
            != (u_inc < np.float32(TA_P[0]))).any()


@pytest.mark.parametrize("epochs", [1, 2])
def test_train_epoch_ref_matches_jax(epochs):
    """N = 4, S = 17, C = 3, m = 33, o = 65, fed the same numpy draws."""
    N, S, C, m, o, n_states, T = 4, 17, 3, 33, 65, 63, 15
    rng = np.random.default_rng(epochs)
    ta, w, lits = _epoch_inputs(rng, N, S, C, m, o, n_states)
    jta, jw = jnp.asarray(ta), jnp.asarray(w)
    tta, tw = _t(ta, w)
    for _ in range(epochs):
        cls2, u_act, coin = _draws(rng, N, S, C, m, 2 * o)
        jta, jw = jops.train_epoch_fused(
            jta, jw, jnp.asarray(lits), jnp.asarray(cls2),
            jnp.asarray(u_act), jnp.asarray(coin), n_states=n_states, T=T)
        tta, tw = ops.train_epoch_fused(tta, tw, *_t(lits, cls2, u_act, coin),
                                        n_states=n_states, T=T)
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (tta.numpy() != ta).any() and (tw.numpy() != w).any()


def test_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import clause_eval, ta_update, train_epoch
    include, lits, wpol = _vote_inputs(np.random.default_rng(0), 1, 2, 4,
                                       8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval.fused_votes_batched(*_t(include, lits, wpol))
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval.fused_votes(*_t(include[0], lits[0], wpol[0]))
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval.clause_outputs(*_t(include[0].reshape(8, 8), lits[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ta_update.ta_update(*_t(*_ta_inputs(np.random.default_rng(0), 1, 4,
                                            8)),
                            p_inc=0.9, p_dec=0.1, n_states=63)
    ta, w, lt = _epoch_inputs(np.random.default_rng(0), 1, 2, 2, 4, 4, 63)
    with pytest.raises(ValueError, match="CUDA"):
        train_epoch.train_epoch_fused(
            *_t(ta, w, lt, *_draws(np.random.default_rng(1), 1, 2, 2, 4, 8)),
            n_states=63, T=15)


@pytest.mark.parametrize("T", [15, 40, 1000])
def test_constant_divide_is_a_reciprocal_multiply(T):
    """The reference's p_act = (T - v) / (2.0 * T) runs, as XLA compiles
    it, as (T - v) * f32(1/2T), which is not the correctly rounded
    quotient for every v.  The port's plain version and kernel multiply
    by ref.reciprocal_f32, and so does accuracy's / B."""
    v = np.arange(-T, T + 1, dtype=np.int32)
    got = np.asarray(jax.jit(lambda v: (T - v) / (2.0 * T))(jnp.asarray(v)))
    num = (T - v).astype(np.float32)
    mul = num * np.float32(ref.reciprocal_f32(2 * T))
    np.testing.assert_array_equal(got.view(np.int32), mul.view(np.int32))
    assert (num / np.float32(2 * T) != mul).any()
    hits = jnp.asarray([1] * 7 + [0] * (T - 7), bool)
    want = np.float32(jnp.mean(hits))
    assert np.float32(7) * np.float32(ref.reciprocal_f32(T)) == want
