"""repro_torch.core.tm against repro.core.tm: ``init_params``, the four
client-batched entry points (the weighted TM's fused epoch and the
unit-weight TM's per-sample scan) and the single-model API are bit-equal
at the shapes of test_tm.py's batched test (N = 4, S = 17, C = 3,
m = 33, o = 65)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tm as jtm
from repro_torch import random as tr
from repro_torch.core import clustering, confidence
from repro_torch.core import tm as ttm
from test_torch_gpu import one_torch_thread  # noqa: F401

CFG = dict(n_classes=3, n_clauses=33, n_features=65, n_states=63, s=3.0,
           T=15)
N, S, B = 4, 17, 9


@pytest.fixture(scope="module")
def trained():
    """Both packages' params after 2 epochs of train_batched, from the
    same keys and numpy data, plus an evaluation set."""
    jcfg, tcfg = jtm.TMConfig(**CFG), ttm.TMConfig(**CFG)
    rng = np.random.default_rng(0)
    xs = (rng.random((N, S, CFG["n_features"])) < 0.4).astype(np.int32)
    ys = rng.integers(0, CFG["n_classes"], (N, S)).astype(np.int32)
    xe = (rng.random((N, B, CFG["n_features"])) < 0.4).astype(np.int32)
    ye = rng.integers(0, CFG["n_classes"], (N, B)).astype(np.int32)
    jp = jax.vmap(lambda k: jtm.init_params(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(7), N))
    tp = ttm.init_params(tcfg, tr.split(tr.PRNGKey(7, "cpu"), N))
    jkeys = jax.random.split(jax.random.PRNGKey(8), N)
    tkeys = tr.split(tr.PRNGKey(8, "cpu"), N)
    jp = jtm.train_batched(jp, jnp.asarray(xs), jnp.asarray(ys), jkeys, jcfg,
                           epochs=2)
    tp = ttm.train_batched(tp, torch.as_tensor(xs), torch.as_tensor(ys),
                           tkeys, tcfg, epochs=2)
    return jcfg, tcfg, jp, tp, (xe, ye)


def test_init_params_bit_equal():
    for seed in (0, 3):
        jcfg, tcfg = jtm.TMConfig(**CFG), ttm.TMConfig(**CFG)
        a = jtm.init_params(jcfg, jax.random.PRNGKey(seed))
        b = ttm.init_params(tcfg, tr.PRNGKey(seed, "cpu"))
        np.testing.assert_array_equal(np.asarray(a.ta_state), b.ta_state)
        np.testing.assert_array_equal(np.asarray(a.weights), b.weights)
        assert b.ta_state.dtype == b.weights.dtype == torch.int32


def test_train_batched_bit_equal(trained):
    _, _, jp, tp, _ = trained
    np.testing.assert_array_equal(np.asarray(jp.ta_state), tp.ta_state)
    np.testing.assert_array_equal(np.asarray(jp.weights), tp.weights)


@pytest.mark.parametrize("weighted", [False, True])
def test_confidence_scores_batched_bit_equal(trained, weighted):
    jcfg, tcfg, jp, tp, (xe, _) = trained
    a = jtm.confidence_scores_batched(jp, jnp.asarray(xe), jcfg,
                                      weighted=weighted)
    b = ttm.confidence_scores_batched(tp, torch.as_tensor(xe), tcfg,
                                      weighted=weighted)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(a, axis=-1)),
        confidence.cluster_assignment(b).numpy())


@pytest.mark.parametrize("weighted_tm", [True, False])
def test_predict_and_accuracy_batched_bit_equal(trained, weighted_tm):
    jcfg, tcfg, jp, tp, (xe, ye) = trained
    jcfg = dataclasses.replace(jcfg, weighted=weighted_tm)
    tcfg = dataclasses.replace(tcfg, weighted=weighted_tm)
    a = jtm.predict_batched(jp, jnp.asarray(xe), jcfg)
    b = ttm.predict_batched(tp, torch.as_tensor(xe), tcfg)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    a = jtm.accuracy_batched(jp, jnp.asarray(xe), jnp.asarray(ye), jcfg)
    b = ttm.accuracy_batched(tp, torch.as_tensor(xe), torch.as_tensor(ye),
                             tcfg)
    assert b.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  b.numpy().view(np.int32))


def test_argmax_ties_go_to_the_lowest_class():
    """Eq.-1 votes clipped to ±T tie at +T: the first class wins, as in
    jnp.argmax (test_tm.py's saturation regression, batched)."""
    cfg = ttm.TMConfig(n_classes=2, n_clauses=4, n_features=2, n_states=63,
                       s=3.0, T=1)
    ta = torch.ones((1, 2, 4, 4), dtype=torch.int32)
    ta[0, 0, 0, 0] = ta[0, 1, 0, 0] = cfg.n_states + 1
    w = torch.ones((1, 2, 4), dtype=torch.int32)
    w[0, 0, 0], w[0, 1, 0] = 2, 3
    x = torch.tensor([[[1, 0]]])
    p = ttm.TMParams(ta, w)
    assert int(ttm.predict_batched(p, x, cfg)[0, 0]) == 0
    assert float(ttm.accuracy_batched(p, x, torch.zeros((1, 1)), cfg)[0]) == 1


def test_aggregate_matches_reference_formula():
    from repro.core import clustering as jcl
    rng = np.random.default_rng(1)
    ups = rng.integers(0, 9, (12, 7)).astype(np.float32)
    asg = rng.integers(-1, 4, 12).astype(np.int32)
    prev = rng.random((5, 7)).astype(np.float32)
    a = jcl.aggregate(jnp.asarray(ups), jnp.asarray(asg), 5, jnp.asarray(prev))
    b = clustering.aggregate(torch.as_tensor(ups), torch.as_tensor(asg), 5,
                             torch.as_tensor(prev))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_unweighted_train_batched_bit_equal():
    """weighted=False trains through the per-sample scan: the JAX
    package's vmap(train) (its jnp path, which it pins equal to its
    kernel path) and the port's batched scan agree; weights never move."""
    jcfg = jtm.TMConfig(**CFG, weighted=False)
    tcfg = ttm.TMConfig(**CFG, weighted=False)
    rng = np.random.default_rng(2)
    xs = (rng.random((N, 6, CFG["n_features"])) < 0.4).astype(np.int32)
    ys = rng.integers(0, CFG["n_classes"], (N, 6)).astype(np.int32)
    jp = jax.vmap(lambda k: jtm.init_params(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(4), N))
    tp = ttm.init_params(tcfg, tr.split(tr.PRNGKey(4, "cpu"), N))
    a = jtm.train_batched(jp, jnp.asarray(xs), jnp.asarray(ys),
                          jax.random.split(jax.random.PRNGKey(5), N), jcfg,
                          epochs=2)
    b = ttm.train_batched(tp, torch.as_tensor(xs), torch.as_tensor(ys),
                          tr.split(tr.PRNGKey(5, "cpu"), N), tcfg, epochs=2)
    np.testing.assert_array_equal(np.asarray(a.ta_state), b.ta_state)
    np.testing.assert_array_equal(np.asarray(a.weights), b.weights)
    assert (b.ta_state != tp.ta_state).any()
    assert torch.equal(b.weights, tp.weights)


@pytest.fixture(scope="module", params=[True, False],
                ids=["weighted", "unit_weight"])
def single(request):
    """One model trained by both packages' single-model ``train`` (the
    fused epoch at N = 1, or the per-sample scan), and a test set."""
    kw = dict(CFG, weighted=request.param)
    jcfg, tcfg = jtm.TMConfig(**kw), ttm.TMConfig(**kw)
    rng = np.random.default_rng(6)
    xs = (rng.random((S, CFG["n_features"])) < 0.4).astype(np.int32)
    ys = rng.integers(0, CFG["n_classes"], S).astype(np.int32)
    jp = jtm.train(jtm.init_params(jcfg, jax.random.PRNGKey(1)),
                   jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(2),
                   jcfg, epochs=2)
    tp = ttm.train(ttm.init_params(tcfg, tr.PRNGKey(1, "cpu")),
                   torch.as_tensor(xs), torch.as_tensor(ys),
                   tr.PRNGKey(2, "cpu"), tcfg, epochs=2)
    xe = (rng.random((B, CFG["n_features"])) < 0.4).astype(np.int32)
    ye = rng.integers(0, CFG["n_classes"], B).astype(np.int32)
    return jcfg, tcfg, jp, tp, xe, ye


def test_single_model_train_bit_equal(single):
    _, _, jp, tp, _, _ = single
    np.testing.assert_array_equal(np.asarray(jp.ta_state), tp.ta_state)
    np.testing.assert_array_equal(np.asarray(jp.weights), tp.weights)


def test_single_model_train_epoch_bit_equal(single):
    jcfg, tcfg, jp, tp, xe, ye = single
    a = jtm.train_epoch(jp, jnp.asarray(xe), jnp.asarray(ye),
                        jax.random.PRNGKey(9), jcfg)
    b = ttm.train_epoch(tp, torch.as_tensor(xe), torch.as_tensor(ye),
                        tr.PRNGKey(9, "cpu"), tcfg)
    np.testing.assert_array_equal(np.asarray(a.ta_state), b.ta_state)
    np.testing.assert_array_equal(np.asarray(a.weights), b.weights)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_single_model_predict_and_accuracy_bit_equal(single, use_kernel):
    """Against both of the reference's paths: its jnp forward pass and its
    fused-votes kernel in interpret mode."""
    jcfg, tcfg, jp, tp, xe, ye = single
    jcfg = dataclasses.replace(jcfg, use_kernel=use_kernel)
    a = jtm.predict(jp, jnp.asarray(xe), jcfg)
    b = ttm.predict(tp, torch.as_tensor(xe), tcfg)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    a = jtm.accuracy(jp, jnp.asarray(xe), jnp.asarray(ye), jcfg)
    b = ttm.accuracy(tp, torch.as_tensor(xe), torch.as_tensor(ye), tcfg)
    assert b.dtype == torch.float32 and b.shape == ()
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  b.numpy().view(np.int32))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_single_model_forward_and_confidence_bit_equal(single, use_kernel):
    jcfg, tcfg, jp, tp, xe, _ = single
    jcfg = dataclasses.replace(jcfg, use_kernel=use_kernel)
    for predict in (False, True):
        for a, b in zip(jtm.forward(jp, jnp.asarray(xe), jcfg, predict),
                        ttm.forward(tp, torch.as_tensor(xe), tcfg, predict)):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for weighted in (False, True):
        a = jtm.confidence_scores(jp, jnp.asarray(xe), jcfg, weighted)
        b = ttm.confidence_scores(tp, torch.as_tensor(xe), tcfg, weighted)
        assert b.dtype == torch.int32 and b.shape == (CFG["n_classes"],)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
