"""repro_torch.xla_f32.log equals XLA:CPU's float32 log (jax.jit(jnp.log))
bit for bit: 6,000,000 seeded normal values over many decades, and the
special inputs.  Its fma helper rounds a·b + c once, as hardware FMA."""
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
