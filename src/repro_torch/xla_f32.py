"""XLA:CPU's float32 transcendentals, bit for bit, in torch ops.

The JAX package runs its float32 math through XLA, whose CPU backend
lowers ``log`` to Eigen's ``plog_float`` and lets LLVM contract its
multiply-adds into FMAs.  torch's own ``log`` rounds differently in
about one result in seven, so a port path that must reproduce a
reference draw (the Gumbel top-k of a weighted ``choice``) uses the
function here instead.  It is torch ops on a tensor of any device.

``log(x)``, as compiled for x86-64 with FMA:

* the mantissa ``m`` is taken into [0.5, 1) and the exponent ``e``
  computed; below ``sqrt(0.5)`` (as float32), ``x = (m - 1) + m`` and
  ``e -= 1``, else ``x = m - 1``;
* with ``x2 = x·x`` and ``x3 = x2·x`` (plain products), the polynomial
  is evaluated Estrin-style, every step a single-rounding FMA except the
  two marked plain::

      y  = fma(fma(x, p0, p1), x, p2)
      y1 = fma(fma(x, q0, q1), x, q2)
      Y  = fma(y, x3, y1)
      y2 = fma(fma(x, r0, r1), x, r2)
      Y  = fma(Y, x3, y2)
      Y  = fma(Y, x3, e·ln2lo)              e·ln2lo a plain product
      r  = fma(-0.5, x2, x) + Y             the + a plain sum
      r  = fma(ln2hi, e, r)

* 0 and subnormal inputs of either sign give ``-inf`` (denormals are
  flushed to zero), other negative inputs ``nan``, ``inf`` gives
  ``inf``, and ``nan`` stays ``nan``.

The contraction pattern was read off XLA's object code for this
function on an x86-64 host with FMA (jax 0.9.0).  To read it again:
run ``jax.jit(jnp.log)`` on a float32 vector with
``XLA_FLAGS=--xla_dump_to=DIR``; ``DIR/*ir-with-opt.ll`` holds the
algorithm and its constants, and ``objdump -d`` of the dumped
``*obj-file*.o`` shows which multiply-adds became ``vfmadd``.

Each FMA runs in float64 and is rounded once to float32: the float64
product of two float32 values is exact, and the sum is rounded to odd
before the final rounding, which then equals a single rounding of the
exact ``a·b + c``.
"""
from __future__ import annotations

import struct

import torch


def _f32(bits64: int) -> float:
    """A float32 constant from its float64 spelling (as in the .ll)."""
    return struct.unpack("<d", bits64.to_bytes(8, "little"))[0]


_SQRTHF = _f32(0x3FE6A09E60000000)
_P = (_f32(0x3FB2043760000000), _f32(0xBFBD7A3700000000),
      _f32(0x3FBDE4A340000000))
_Q = (_f32(0xBFBFCBA9E0000000), _f32(0x3FC23D37E0000000),
      _f32(0xBFC555CA00000000))
_R = (_f32(0x3FC999D580000000), _f32(0xBFCFFFFF80000000),
      _f32(0x3FD5555540000000))
_LN2LO = _f32(0xBF2BD01060000000)
_LN2HI = _f32(0x3FE6300000000000)
_FLT_MIN_BITS = 0x00800000


def fma(a, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 (IEEE fused multiply-add).

    Arguments are float32 tensors or Python floats that are float32
    values.  The product is exact in float64; the float64 sum is made
    round-to-odd (its error, from a two-sum, sets the last bit) so that
    rounding it to float32 rounds the exact result once."""
    like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))

    def d(t):
        return t.to(torch.float64) if isinstance(t, torch.Tensor) \
            else torch.tensor(t, dtype=torch.float64, device=like.device)

    p = d(a) * d(b)
    c64 = d(c)
    s = p + c64
    bp = s - c64                    # two-sum: s + err == p + c exactly
    err = (p - bp) + (c64 - (s - bp))
    bits = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(s)
    odd = (bits & 1) == 1
    # toward the exact value: away from zero when err has s's sign
    away = (err > 0) == (s > 0)
    fixed = torch.where(away, bits + 1, bits - 1)
    bits = torch.where(inexact & ~odd, fixed, bits)
    return bits.view(torch.float64).to(torch.float32)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``, bit for bit (module docstring)."""
    x = torch.as_tensor(x).to(torch.float32)
    bits = x.view(torch.int32)
    normal = bits >= _FLT_MIN_BITS          # also rejects negatives
    clamped = torch.where(normal, bits, _FLT_MIN_BITS)
    e = ((clamped >> 23) & 0xFF) - 126
    m = ((clamped & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    xm = m - 1.0
    xm = torch.where(small, xm + m, xm)
    e = (e - small.to(torch.int32)).to(torch.float32)

    x2 = xm * xm
    x3 = x2 * xm
    y = fma(fma(xm, _P[0], _P[1]), xm, _P[2])
    y1 = fma(fma(xm, _Q[0], _Q[1]), xm, _Q[2])
    Y = fma(y, x3, y1)
    y2 = fma(fma(xm, _R[0], _R[1]), xm, _R[2])
    Y = fma(Y, x3, y2)
    Y = fma(Y, x3, e * _LN2LO)
    r = fma(-0.5, x2, xm) + Y
    r = fma(_LN2HI, e, r)

    r = torch.where(x < 0, torch.nan, r)
    flushed = (bits & 0x7FFFFFFF) < _FLT_MIN_BITS          # ±0, subnormal
    r = torch.where(flushed, -torch.inf, r)
    r = torch.where(torch.isposinf(x), torch.inf, r)
    return torch.where(torch.isnan(x), x, r)
