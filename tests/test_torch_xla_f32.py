"""repro_torch.xla_f32 equals XLA:CPU's float32 functions bit for bit:
``log`` (jax.jit(jnp.log)) over 6,000,000 seeded normal values over many
decades, and ``exp``, ``log1p``, ``sqrt``, ``rsqrt``, ``erf_inv`` and the
sum over the last axis against ``jax.jit`` of the same function over
seeded sweeps; each also at the special inputs (zeros, subnormals, which
XLA flushes, infinities, nan).  For ``rsqrt``: every cell of the x86
estimate's table, and Marsaglia-Tsang's ``c = rsqrt(a - 1/3)/3`` over
1,000,000 alphas in [1, 20000] and at the data path's four, with no
result that differs.  Its fma helper rounds a·b + c once, as hardware
FMA."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import xla_f32
from test_torch_gpu import one_torch_thread  # noqa: F401

F32 = np.finfo(np.float32)
# (lo, hi) in decades: below one, above one, near FLT_MIN, the rest
RANGES = [(1e-7, 1.0), (1.0, 1e4), (2e-38, 1e-30), (1e-30, 1e-7),
          (1e4, 3e38), (0.5, 2.0)]
_jlog = jax.jit(jnp.log)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("lo,hi", RANGES)
def test_log_bit_identical_to_xla(lo, hi):
    rng = np.random.default_rng(RANGES.index((lo, hi)))
    x = np.exp(rng.uniform(np.log(lo), np.log(hi), 1_000_000)
               ).astype(np.float32)
    want = _bits(_jlog(x))
    got = _bits(xla_f32.log(torch.from_numpy(x)).numpy())
    bad = np.flatnonzero(want != got)
    assert bad.size == 0, (f"{bad.size} differ, first at x={x[bad[0]]!r}: "
                           f"{want[bad[0]]:#x} != {got[bad[0]]:#x}")


def test_log_special_inputs():
    sub = np.array([1e-40, 1e-45, F32.smallest_subnormal], np.float32)
    x = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, -3.5, np.inf, -np.inf, np.nan,
                  F32.tiny, -F32.tiny, F32.max, np.nextafter(
                      np.float32(1), np.float32(0))], np.float32),
        sub, -sub]).astype(np.float32)
    want = np.asarray(_jlog(x))
    got = xla_f32.log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(want[ok]), _bits(got[ok]))
    # denormals are flushed: subnormals of either sign give -inf
    assert np.all(got[-6:] == -np.inf)


def test_log_on_any_shape_and_dtype():
    x = torch.tensor([[0.25, 2.0], [8.0, 1e-3]], dtype=torch.float64)
    out = xla_f32.log(x)
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    np.testing.assert_array_equal(
        _bits(out.numpy()), _bits(_jlog(x.numpy().astype(np.float32))))


def test_fma_rounds_once():
    """Against the exact a·b + c: random float32 triples, and a case
    whose float64 sum lands on a float32 midpoint (a second rounding
    to even would go the wrong way)."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(2000).astype(np.float32)
               * np.float32(2.0) ** rng.integers(-20, 20, 2000
                                                 ).astype(np.float32)
               for _ in range(3))
    a[0], b[0], c[0] = (np.float32(2.0 ** -24 * (1 + 2.0 ** -23)),
                        np.float32(1 - 2.0 ** -23),
                        np.float32(1 + 2.0 ** -23))
    got = xla_f32.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))           # within one ulp of exact
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        ties = [v for v, d in zip(cands, dist) if d == best]
        want = ties[0] if len(ties) == 1 else next(
            v for v in ties if _bits(v) % 2 == 0)
        assert _bits(got[i]) == _bits(want), (i, a[i], b[i], c[i])
    assert got[0] == np.float32(1 + 2.0 ** -23)


def _same_bits(want, got):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(nan, np.isnan(got))
    bad = np.flatnonzero(_bits(want)[~nan] != _bits(got)[~nan])
    assert bad.size == 0, (f"{bad.size} of {want.size} differ, first "
                           f"{want[~nan][bad[0]]!r} != {got[~nan][bad[0]]!r}")


def _decades(rng, lo, hi, n):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.float32)


SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, np.inf, -np.inf,
                    np.nan, 1e-40, -1e-40, F32.smallest_subnormal, F32.tiny,
                    -F32.tiny, F32.max, -F32.max, 88.72, -87.5, -88.5,
                    0.41421357, -0.41421357, 0.99999994, -0.99999994,
                    2.0, -2.0], np.float32)


def _sweep(name, rng):
    """Seeded float32 inputs that cover each function's branches."""
    u = lambda lo, hi, n: rng.uniform(lo, hi, n).astype(np.float32)
    if name == "exp":       # both clamps, the flushed tail near -87.3
        parts = [u(-100, 100, 400_000), u(-1, 1, 200_000),
                 -_decades(rng, 1e-7, 90, 200_000), u(-88.5, -86, 100_000)]
    elif name == "log1p":   # the rational branch and log(1 + a)
        parts = [u(-1, 1, 400_000), -_decades(rng, 1e-8, 1, 200_000),
                 _decades(rng, 1e-8, 1e6, 200_000), u(-0.42, 0.42, 100_000)]
    elif name == "sqrt":
        parts = [u(0, 10, 300_000), _decades(rng, 1e-37, 3e38, 300_000)]
    elif name == "rsqrt":
        parts = [u(0.5, 20000, 300_000), _decades(rng, 1e-37, 3e38, 300_000)]
    else:                   # erf_inv: both polynomials, near ±1
        parts = [u(-1, 1, 500_000), 1 - _decades(rng, 1e-7, 1e-2, 100_000),
                 -1 + _decades(rng, 1e-7, 1e-2, 100_000)]
    return np.concatenate(parts + [SPECIAL]).astype(np.float32)


JAX_FN = {"exp": jnp.exp, "log1p": jnp.log1p, "sqrt": jnp.sqrt,
          "rsqrt": jax.lax.rsqrt, "erf_inv": jax.lax.erf_inv}


@pytest.mark.parametrize("name", sorted(JAX_FN))
def test_function_bit_identical_to_xla(name):
    x = _sweep(name, np.random.default_rng(sorted(JAX_FN).index(name)))
    _same_bits(jax.jit(JAX_FN[name])(x),
               getattr(xla_f32, name)(torch.from_numpy(x)).numpy())


def test_flush_to_zero():
    """Subnormal results flush to zero; subnormal inputs read as zero."""
    x = torch.tensor([-87.5, -88.0, 1e-40, -1e-40], dtype=torch.float32)
    assert xla_f32.exp(x[:2]).tolist() == [0.0, 0.0]
    assert xla_f32.exp(x[2:]).tolist() == [1.0, 1.0]
    assert xla_f32.log1p(x[2:]).tolist() == [0.0, 0.0]
    assert xla_f32.rsqrt(x[2:3]).item() == np.inf


def test_rsqrt_estimate_table_every_cell():
    """Each of the estimate's 2048 cells (exponent parity × the top 10
    mantissa bits), with random low bits, over many exponents."""
    rng = np.random.default_rng(5)
    cell = np.arange(2048, dtype=np.int64)
    ex = (cell >> 10) + 2 * rng.integers(1, 126, (64, 2048))
    bits = (ex << 23) | ((cell & 0x3FF) << 13) | rng.integers(0, 1 << 13,
                                                               (64, 2048))
    x = bits.astype(np.int32).view(np.float32).ravel()
    _same_bits(jax.jit(jax.lax.rsqrt)(x),
               xla_f32.rsqrt(torch.from_numpy(x)).numpy())


def test_gamma_c_over_an_alpha_sweep():
    """``c = rsqrt(d)·f32(1/3)``, ``d = a - f32(1/3)``, as the gamma
    sampler computes it with the alpha a runtime value: 0 of 1,000,000
    alphas in [1, 20000] differ, nor do the data path's four (10000,
    0.05 and 0.3 boosted by 1, 1.0)."""
    third = np.float32(1.0 / 3.0)
    rng = np.random.default_rng(6)
    a = np.concatenate([rng.uniform(1, 20000, 1_000_000),
                        [10000.0, 1.05, 1.0, 1.3]]).astype(np.float32)
    want = jax.jit(lambda v: jax.lax.rsqrt(v - third) * third)(a)
    got = xla_f32.rsqrt(torch.from_numpy(a) - float(third)) * float(third)
    _same_bits(want, got.numpy())


@pytest.mark.parametrize("n", [1, 6, 10, 20, 32, 33, 62, 100, 257, 1100])
def test_reduce_sum_order(n):
    """One chain up to 32 elements; past that, windows of 32 over a
    zero-padded row, and the window sums reduced the same way."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((7, n)) * np.exp(rng.uniform(-20, 20, (7, n)))
         ).astype(np.float32)
    _same_bits(jax.jit(lambda v: jnp.sum(v, axis=-1))(x),
               xla_f32.reduce_sum(torch.from_numpy(x)).numpy())
