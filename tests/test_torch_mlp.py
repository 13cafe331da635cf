"""The port's MLP (``repro_torch.core.mlp``), FLIS's labellings and the
logit-margin confidence against the JAX package on the CPU.

``init`` draws the reference's bits, and so do the FLIS labellings given
the same similarity matrix (integer steps for DC; IEEE float32 adds and
divides and a row-major first maximum for HC).  The rest is float math:
the port's batched products and autograd against XLA's vmapped ``grad``
agree within ``TOL``, measured at about 1.2e-7 after 2 epochs of SGD at
these sizes (the ROADMAP's North star allows a tolerance here only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import confidence as jconfidence
from repro.core import mlp as jmlp
from repro.fl.runtime import strategy as jstrategy
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import confidence, mlp
from repro_torch.fl.runtime import strategy
from test_torch_gpu import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-6, rtol=1e-5)
F, H, C = 144, 16, 10


def _key(seed):
    return jax.random.PRNGKey(seed), convert.key_from_numpy(
        jax.random.PRNGKey(seed), "cpu")


def _bits(a, b):
    a, b = np.asarray(a), convert.to_numpy(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _inputs(seed, n=4, b=24):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, b, F)) < 0.3).astype(np.uint8)
    y = rng.integers(0, C, (n, b)).astype(np.int32)
    return x, y


def _stacked_init(seed, n):
    jk, tk = _key(seed)
    jp = jax.vmap(lambda k: jmlp.init(k, F, H, C))(jax.random.split(jk, n))
    tp = mlp.init(tr.split(tk, n), F, H, C)
    return jp, tp


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_init_bit_identical(seed):
    """One key, and a stacked cohort from split keys (the reference's
    vmapped init), give the reference's weights bit for bit."""
    jk, tk = _key(seed)
    jp, tp = jmlp.init(jk, F, H, C), mlp.init(tk, F, H, C)
    for k in ("w1", "b1", "w2", "b2"):
        _bits(jp[k], tp[k])
    js, ts = _stacked_init(seed, 5)
    for k in ("w1", "b1", "w2", "b2"):
        _bits(js[k], ts[k])
    assert mlp.n_bytes(tp) == jmlp.n_bytes(jp) == 4 * (F * H + H + H * C + C)


def test_apply_loss_accuracy_within_tolerance():
    """Logits, the mean cross-entropy with and without FedProx's
    proximal term, and the accuracy of a stacked cohort."""
    x, y = _inputs(1)
    jp, tp = _stacked_init(3, 4)
    jref, tref = _stacked_init(4, 4)
    logits = jax.vmap(jmlp.apply)(jp, x)
    np.testing.assert_allclose(convert.to_numpy(mlp.apply(
        tp, torch.as_tensor(x))), logits, **TOL)
    for mu, use_ref in ((0.0, False), (0.1, True), (0.7, True)):
        want = jax.vmap(lambda p, xx, yy, r: jmlp.loss_fn(
            p, xx, yy, mu, r if use_ref else None))(jp, x, y, jref)
        got = mlp.loss_fn(tp, torch.as_tensor(x), torch.as_tensor(y), mu,
                          tref if use_ref else None)
        np.testing.assert_allclose(convert.to_numpy(got), want, **TOL)
    acc = jax.vmap(jmlp.accuracy)(jp, x, y)
    _bits(acc, mlp.accuracy(tp, torch.as_tensor(x), torch.as_tensor(y)))
    mean = jmlp.tree_mean(jp)
    for k, v in mlp.tree_mean(tp).items():
        np.testing.assert_allclose(convert.to_numpy(v), mean[k], **TOL)


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_local_train_within_tolerance(prox_mu):
    """Two epochs of minibatch SGD (3 steps of 8 an epoch) for 4 clients
    at once: the same permutations, each client's gradient its own
    block of one autograd graph."""
    x, y = _inputs(2)
    jp, tp = _stacked_init(5, 4)
    jk, tk = _key(9)
    jref = jp if prox_mu > 0 else None

    def one(p, xx, yy, k, r):
        return jmlp.local_train(p, xx, yy, k, epochs=2, batch=8, lr=0.05,
                                prox_mu=prox_mu, prox_ref=r)

    want = jax.vmap(one)(jp, x, y, jax.random.split(jk, 4), jref)
    got = mlp.local_train(tp, torch.as_tensor(x), torch.as_tensor(y),
                          tr.split(tk, 4), epochs=2, batch=8, lr=0.05,
                          prox_mu=prox_mu,
                          prox_ref=tp if prox_mu > 0 else None)
    moved = 0.0
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(convert.to_numpy(got[k]), want[k], **TOL)
        moved = max(moved, float(np.abs(np.asarray(want[k] - jp[k])).max()))
    assert moved > 1e-3                     # the steps did move the model
    assert not got["w1"].requires_grad


def test_local_train_refuses_a_short_split():
    x, y = _inputs(2, b=6)
    _, tp = _stacked_init(5, 4)
    with pytest.raises(ValueError, match="do not fill a batch"):
        mlp.local_train(tp, torch.as_tensor(x), torch.as_tensor(y),
                        tr.split(tr.PRNGKey(0, "cpu"), 4), epochs=1,
                        batch=8, lr=0.05)


def test_full_fp32_restores_the_callers_setting():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with mlp.full_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_flatten_roundtrip_matches_the_reference_layout():
    jp, tp = _stacked_init(6, 3)
    layout = strategy._mlp_layout(F, H, C)
    flat = strategy._flatten_mlp(tp, layout)
    want = jax.vmap(lambda p: jstrategy._flatten_mlp(
        p, jstrategy._mlp_layout(F, H, C)))(jp)
    _bits(want, flat)
    back = strategy._unflatten_mlp(flat, layout)
    for k in tp:
        assert torch.equal(back[k], tp[k])


def test_logit_margin_confidence_within_tolerance():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 12, C)).astype(np.float32)
    logits[0, 0, 3] = logits[0, 0, 5] = logits[0, 0].max() + 1   # a tie
    want = jax.vmap(jconfidence.logit_margin_confidence)(logits)
    got = confidence.logit_margin_confidence(torch.as_tensor(logits))
    np.testing.assert_allclose(convert.to_numpy(got), want, **TOL)


def test_flis_similarity_within_tolerance():
    jp, tp = _stacked_init(8, 5)
    layout = strategy._mlp_layout(F, H, C)
    probe = _inputs(4, n=1, b=16)[0][0]
    jlay = jstrategy._mlp_layout(F, H, C)
    flat = jax.vmap(lambda p: jstrategy._flatten_mlp(p, jlay))(jp)
    want = jstrategy.flis_similarity(flat, jnp.asarray(probe), jlay)
    got = strategy.flis_similarity(strategy._flatten_mlp(tp, layout),
                                   torch.as_tensor(probe), layout)
    np.testing.assert_allclose(convert.to_numpy(got), want, **TOL)


def _sims():
    """Random, tied and at-threshold similarity matrices, with arrival
    masks: full, partial, one client, none."""
    rng = np.random.default_rng(11)
    out = []
    for k in (1, 2, 5, 9):
        a = rng.uniform(0.6, 1.0, (k, k)).astype(np.float32)
        sym = ((a + a.T) / 2).astype(np.float32)
        tied = np.round(sym * 4).astype(np.float32) / 4   # many equal pairs
        at = np.where(rng.random((k, k)) < 0.5, np.float32(0.9),
                      sym).astype(np.float32)
        at = np.minimum(at, at.T)
        for sim in (sym, tied, at):
            np.fill_diagonal(sim, 1.0)
            for arrive in (np.ones(k, bool), rng.random(k) < 0.6,
                           np.eye(1, k, 0, dtype=bool)[0],
                           np.zeros(k, bool)):
                out.append((sim, arrive))
    return out


@pytest.mark.parametrize("kind", ["dc", "hc"])
@pytest.mark.parametrize("max_slots", [1, 3, 8])
def test_flis_labels_bit_identical(kind, max_slots):
    """Given the same similarity, the port's DC and HC labels equal the
    JAX package's, on random, tied and at-threshold (0.9 exactly, the
    float32 compare) matrices under every arrival mask."""
    # jitted: the labellers' scans compile to the same program eagerly
    jfn = jax.jit(jstrategy.flis_dc_labels if kind == "dc"
                  else jstrategy.flis_hc_labels, static_argnums=(2, 3))
    tfn = strategy.flis_dc_labels if kind == "dc" \
        else strategy.flis_hc_labels
    merged = split = 0
    for sim, arrive in _sims():
        for thr in (0.9, 0.75):
            want = np.asarray(jfn(jnp.asarray(sim), jnp.asarray(arrive),
                                  thr, max_slots))
            got = tfn(torch.as_tensor(sim), torch.as_tensor(arrive), thr,
                      max_slots)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(convert.to_numpy(got), want)
            distinct = len(set(want[arrive].tolist()))
            merged += distinct < int(arrive.sum())
            split += distinct > 1
    # the cases did merge clients, and split them where rows allow
    assert merged > 0 and (split > 0 or max_slots == 1)
