"""repro_torch.random is bit-equal to jax.random (threefry, partitionable
mode) over several seeds and shapes, including batched keys: bits,
uniform (also with bounds), bernoulli, randint, and the float draws of
the data path — normal, exponential, loggamma, dirichlet at the alphas
the partition uses (10000, 0.05, 1.0) and 0.3, and categorical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as tr
from test_torch_gpu import one_torch_thread  # noqa: F401

SEEDS = [0, 42, 2**31 - 1]
SHAPES = [(), (1,), (7,), (5, 13), (33, 130)]


def _key(seed):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed, "cpu")


def _eq(a, b):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    b = b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    jk, tk = _key(seed)
    _eq(jk, tk)
    for n in (1, 2, 3, 17):
        _eq(jax.random.split(jk, n), tr.split(tk, n))
    for data in (0, 1, 0x5C4ED, 2**32 - 1):
        _eq(jax.random.fold_in(jk, data), tr.fold_in(tk, data))
    # batched keys = vmap over keys
    jks = jax.random.split(jk, 4)
    _eq(jax.vmap(lambda k: jax.random.split(k, 3))(jks),
        tr.split(tr.split(tk, 4), 3))
    _eq(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks),
        tr.fold_in(tr.split(tk, 4), 9))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = _key(seed)
    _eq(jax.random.bits(jk, shape, jnp.uint32), tr.bits(tk, shape))
    _eq(jax.random.uniform(jk, shape), tr.uniform(tk, shape))
    for p in (0.5, 0.1, 2.0 / 3.0):
        _eq(jax.random.bernoulli(jk, p, shape), tr.bernoulli(tk, p, shape))
    _eq(jax.random.bits(jk, shape, jnp.uint32) >> 9,
        tr.mantissa_bits(tk, shape))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(1, 10), (1, 3), (0, 7), (-5, 1000), (4, 4)])
def test_randint(seed, lo, hi):
    jk, tk = _key(seed)
    for shape in ((), (6,), (3, 11)):
        _eq(jax.random.randint(jk, shape, lo, hi),
            tr.randint(tk, shape, lo, hi))


def test_batched_keys_match_vmap():
    jks = jax.random.split(jax.random.PRNGKey(5), 6)
    tks = tr.split(tr.PRNGKey(5, "cpu"), 6)
    _eq(jax.vmap(lambda k: jax.random.uniform(k, (4, 9)))(jks),
        tr.uniform(tks, (4, 9)))
    _eq(jax.vmap(lambda k: jax.random.randint(k, (), 1, 10))(jks),
        tr.randint(tks, (), 1, 10))
    _eq(jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, (3, 5, 7)))(jks),
        tr.bernoulli(tks, 0.5, (3, 5, 7)))


def test_chunked_hash_matches_one_pass(monkeypatch):
    """Hashing in chunks of counters changes nothing."""
    tk = tr.split(tr.PRNGKey(3, "cpu"), 3)
    whole = tr.bits(tk, (41, 37))
    monkeypatch.setitem(tr._CHUNK, "cpu", 50)
    torch.testing.assert_close(tr.bits(tk, (41, 37)), whole, rtol=0, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_with_bounds(seed):
    jk, tk = _key(seed)
    for lo, hi in ((-1.0, 3.0), (0.1, 0.7), (-0.99999994, 1.0)):
        _eq(jax.random.uniform(jk, (500,), minval=lo, maxval=hi),
            tr.uniform(tk, (500,), lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (40, 50)])
def test_normal_exponential(seed, shape):
    jk, tk = _key(seed)
    _eq(jax.random.normal(jk, shape), tr.normal(tk, shape))
    _eq(jax.random.exponential(jk, shape), tr.exponential(tk, shape))


ALPHAS = [10000.0, 0.05, 1.0, 0.3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("alpha", ALPHAS + [2.5])
def test_loggamma(seed, alpha):
    """400 lanes a call: the boost below 1, rejections, and the inner
    redraw of v <= 0 (frequent at alpha near 1) all occur."""
    jk, tk = _key(seed)
    a = np.full((400,), alpha, np.float32)
    _eq(jax.random.loggamma(jk, jnp.asarray(a)),
        tr.loggamma(tk, torch.from_numpy(a)))
    _eq(jax.random.loggamma(jk, jnp.float32(alpha), (3, 5)),
        tr.loggamma(tk, alpha, (3, 5)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("n_classes,shape", [
    (10, (20,)), (10, (6,)), (62, (5,)), (20, None), (6, None)])
def test_dirichlet(seed, alpha, n_classes, shape):
    """Client mixtures (n, C) and pool shares (C,), as the partition
    draws them; 62 classes sum in XLA's windowed order."""
    jk, tk = _key(seed)
    a = np.full((n_classes,), alpha, np.float32)
    _eq(jax.random.dirichlet(jk, jnp.asarray(a), shape),
        tr.dirichlet(tk, torch.from_numpy(a), shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(seed):
    """Unbatched, and with a batch of keys and logits (the written-out
    vmap of the partition's label draw), from log(p + 1e-9)."""
    jk, tk = _key(seed)
    rng = np.random.default_rng(seed % 1000)
    p = rng.dirichlet(np.full(10, 0.3), 4).astype(np.float32)
    logits = np.asarray(jnp.log(jnp.asarray(p) + 1e-9))
    _eq(jax.random.categorical(jk, jnp.asarray(logits[0]), shape=(300,)),
        tr.categorical(tk, torch.from_numpy(logits[0]), (300,)))
    jks, tks = jax.random.split(jk, 4), tr.split(tk, 4)
    _eq(jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(50,)))(
        jks, jnp.asarray(logits)),
        tr.categorical(tks, torch.from_numpy(logits), (50,)))


def test_gumbel_at_equals_gumbel():
    """The gumbel values at chosen flat positions, row by row with a key
    a row, are those of the whole draw."""
    tks = tr.split(tr.PRNGKey(9, "cpu"), 3)
    whole = tr.gumbel(tks, (4, 25))
    ctr = torch.tensor([[0, 7, 99], [3, 3, 50], [98, 1, 2]])
    got = tr.gumbel_at(tks, ctr)
    want = torch.gather(whole.reshape(3, 100), 1, ctr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
