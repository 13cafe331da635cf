"""XLA:CPU's float32 math, bit for bit, in torch ops.

The JAX package runs its float32 math through XLA, whose CPU backend
emits its own approximations and lets LLVM contract a multiply into the
add that takes it (an FMA) wherever the product has no other use.
torch's functions round differently, so a port path that must reproduce
a reference draw (a Gumbel top-k, a Dirichlet or normal draw) uses the
functions here instead.  Each is torch ops on a tensor of any device.

* ``log`` is Eigen's ``plog_float``: the mantissa ``m`` is taken into
  [0.5, 1) and the exponent ``e`` computed; below ``sqrt(0.5)``,
  ``x = (m - 1) + m`` and ``e -= 1``, else ``x = m - 1``; with
  ``x2 = x·x`` and ``x3 = x2·x`` (plain products), an Estrin-style
  polynomial whose steps are single-rounding FMAs except the two marked
  plain::

      y  = fma(fma(x, p0, p1), x, p2)
      y1 = fma(fma(x, q0, q1), x, q2)
      Y  = fma(y, x3, y1)
      y2 = fma(fma(x, r0, r1), x, r2)
      Y  = fma(Y, x3, y2)
      Y  = fma(Y, x3, e·ln2lo)              e·ln2lo a plain product
      r  = fma(-0.5, x2, x) + Y             the + a plain sum
      r  = fma(ln2hi, e, r)

  0 and subnormal inputs of either sign give ``-inf`` (denormals are
  flushed), other negatives ``nan``, ``inf`` gives ``inf``.
* ``log1p(a)`` is ``log(1 + a)`` unless ``|a| < 0.41421357``, where it
  is ``a + fma(a², -0.5, a³·(N(a)/D(a)))`` with ``N`` and ``D`` Horner
  chains of FMAs (``a³ = a·a²`` and its product with the quotient
  rounded).
* ``exp`` is Cephes' ``expf``: the input clamped to [-88.38, 88.72],
  ``n = floor(fma(x, log2 e, 0.5))`` clamped to [-127, 127], the
  reduced ``z = x - n·C1 - n·C2`` (two FMAs), a degree-5 Horner chain of
  FMAs ``y``, then ``(1 + fma(y, z·z, z))·2**n``; ``2**-127`` is built
  from a zero exponent field, so it is 0.
* ``sqrt`` is the correctly rounded square root.
* ``rsqrt`` is the x86 estimate ``vrsqrtps`` and two Newton-Raphson
  steps ``y = fma(-0.5·y, fma(x·y, y, -1), y)``; zeros, infinities,
  subnormals and negatives take the estimate alone.  The estimate has a
  12-bit mantissa that depends only on the parity of the input's
  exponent and the top 10 bits of its mantissa; ``_RSQRT_EST`` holds it,
  as ``tools/rsqrt_estimate_table.py`` reads it off an Intel x86-64 host
  (another vendor's estimate may differ, and so may the reference's
  results there).
* ``erf_inv`` is Giles' single-precision approximation as XLA expands
  it: ``w = -log1p(-x·x)``; for ``w < 5`` the polynomial in ``w - 2.5``,
  else in ``sqrt(w) - 3``, each a Horner chain of FMAs, times ``x``
  (``±1`` give ``±inf``).
* ``reduce_sum`` adds along the last axis in XLA:CPU's order: one
  sequential chain from 0 up to 32 elements; longer rows are padded
  with zeros on both sides (the odd one on the right) to a multiple of
  32, summed in windows of 32 and the window sums reduced the same way.

XLA:CPU runs with denormals flushed to zero: each function here takes a
subnormal input as a zero of its sign and flushes a subnormal result to
one (``ftz``).

The algorithms and their FMAs were read off XLA's code for the calls the
reference makes (``jax.random.dirichlet``, ``normal``, ``gumbel`` and
the standalone ``jnp`` functions) on an x86-64 host with FMA, jax 0.9.0.
To read them again: run the call with ``XLA_FLAGS=--xla_dump_to=DIR``;
``DIR/*ir-with-opt.ll`` holds the algorithm and its constants as float64
spellings of float32 values, and ``objdump -d`` of the dumped
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

_LOG1P_SMALL = _f32(0x3FDA8279A0000000)
_LOG1P_DEN = tuple(_f32(h) for h in (    # after a leading 1
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
_LOG1P_NUM = tuple(_f32(h) for h in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000))

_EXP_LO, _EXP_HI = _f32(0xC055F33340000000), _f32(0x4056333340000000)
_LOG2E = _f32(0x3FF7154760000000)
_EXP_C1, _EXP_C2 = _f32(0x3FE6300000000000), _f32(0xBF2BD01060000000)
_EXP_P = tuple(_f32(h) for h in (
    0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000,
    0x3FA5553820000000, 0x3FC5555540000000)) + (0.5,)

# Giles' coefficients, highest order first: w < 5, then w >= 5
_ERFINV_CENTRAL = tuple(_f32(h) for h in (
    0x3E5E2CB100000000, 0x3E970966C0000000, 0xBECD8E6AE0000000,
    0xBED26B5820000000, 0x3F2CA65B60000000, 0xBF548A8100000000,
    0xBF711C9DE0000000, 0x3FCF91EC60000000, 0x3FF805C5E0000000))
_ERFINV_TAIL = tuple(_f32(h) for h in (
    0xBF2A3E1360000000, 0x3F1A76AD60000000, 0x3F561B8E40000000,
    0xBF6E17BCE0000000, 0x3F77824F60000000, 0xBF7F38BAE0000000,
    0x3F8354AFC0000000, 0x3FF006DB60000000, 0x4006A9EFC0000000))

# the rsqrtss estimate's 12-bit mantissa by (exponent parity, top 10
# mantissa bits), even exponents first (tools/rsqrt_estimate_table.py)
_RSQRT_EST = (
    "69f69c69a69769469168e68c68968668368067e67b67867567367066d66a66766566265f"
    "65d65a65765465264f64c64a64764464163f63c63963763463162f62c62962762462161f"
    "61c61961761461260f60c60a6076056025ff5fd5fa5f85f55f25f05ed5eb5e85e65e35e0"
    "5de5db5d95d65d45d15cf5cc5ca5c75c45c25bf5bd5ba5b85b55b35b05ae5ab5a95a75a4"
    "5a259f59d59a59859559359058e58b58958758458257f57d57a57857657357156e56c56a"
    "56756556256055e55b55955755455254f54d54b54854654454153f53d53a538536533531"
    "52f52c52a52852552352151e51c51a51851551351150e50c50a5085055035014ff4fc4fa"
    "4f84f64f34f14ef4ed4ea4e84e64e44e14df4dd4db4d94d64d44d24d04ce4cb4c94c74c5"
    "4c34c04be4bc4ba4b84b64b34b14af4ad4ab4a94a64a44a24a049e49c49a497495493491"
    "48f48d48b48948648448248047e47c47a47847647447146f46d46b46946746546346145f"
    "45d45b45945745545245044e44c44a44844644444244043e43c43a43843643443243042e"
    "42c42a42842642442242041e41c41a41841641441241040e40c40a4084064044024003fe"
    "3fd3fb3f93f73f53f33f13ef3ed3eb3e93e73e53e33e13e03de3dc3da3d83d63d43d23d0"
    "3ce3cc3cb3c93c73c53c33c13bf3bd3bc3ba3b83b63b43b23b03ae3ad3ab3a93a73a53a3"
    "3a13a039e39c39a39839639539339138f38d38b38a38838638438238137f37d37b379378"
    "37637437237036f36d36b36936736636436236035e35d35b35935735635435235034f34d"
    "34b34934834634434234133f33d33b33a33833633433333132f32e32c32a328327325323"
    "32232031e31c31b31931731631431231130f30d30b30a3083063053033013002fe2fc2fb"
    "2f92f72f62f42f22f12ef2ed2ec2ea2e82e72e52e32e22e02df2dd2db2da2d82d62d52d3"
    "2d12d02ce2cd2cb2c92c82c62c52c32c12c02be2bc2bb2b92b82b62b42b32b12b02ae2ac"
    "2ab2a92a82a62a52a32a12a029e29d29b29a29829629529329229028f28d28b28a288287"
    "28528428228127f27e27c27a27927727627427327127026e26d26b26a268267265263262"
    "26025f25d25c25a25925725625425325125024e24d24b24a24824724524424224123f23e"
    "23d23b23a23823723523423223122f22e22c22b22922822622522422222121f21e21c21b"
    "21921821621521421221120f20e20c20b20a2082072052042022012001fe1fd1fb1fa1f8"
    "1f71f61f41f31f11f01ef1ed1ec1ea1e91e81e61e51e31e21e11df1de1dc1db1da1d81d7"
    "1d51d41d31d11d01cf1cd1cc1ca1c91c81c61c51c41c21c11bf1be1bd1bb1ba1b91b71b6"
    "1b51b31b21b01af1ae1ac1ab1aa1a81a71a61a41a31a21a019f19e19c19b19a198197196"
    "19419319219018f18e18c18b18a18818718618518318218117f17e17d17b17a179177176"
    "17517417217117016e16d16c16b16916816716516416316216015f15e15c15b15a159157"
    "15615515315215115014e14d14c14b14914814714614414314214113f13e13d13c13a139"
    "13813713513413313213012f12e12d12b12a12912812612512412312212011f11e11d11b"
    "11a11911811711511411311211010f10e10d10c10a1091081071061041031021011000fe"
    "0fd0fc0fb0fa0f80f70f60f50f40f20f10f00ef0ee0ed0eb0ea0e90e80e70e50e40e30e2"
    "0e10e00de0dd0dc0db0da0d90d70d60d50d40d30d20d00cf0ce0cd0cc0cb0c90c80c70c6"
    "0c50c40c30c10c00bf0be0bd0bc0bb0b90b80b70b60b50b40b30b10b00af0ae0ad0ac0ab"
    "0a90a80a70a60a50a40a30a20a009f09e09d09c09b09a099098096095094093092091090"
    "08f08e08c08b08a08908808708608508408208108007f07e07d07c07b07a079078076075"
    "07407307207107006f06e06d06c06b06906806706606506406306206106005f05e05d05b"
    "05a05905805705605505405305205105004f04e04d04c04a049048047046045044043042"
    "04104003f03e03d03c03b03a03903803703603403303203103002f02e02d02c02b02a029"
    "02802702602502402302202102001f01e01d01c01b01a019018017016015014013012011"
    "01000f00e00d00c00b00a009008007006005004003002001ffeffaff6ff2feefeafe6fe2"
    "fdefdafd6fd2fcefcbfc7fc3fbffbbfb7fb3faffabfa7fa4fa0f9cf98f94f90f8cf89f85"
    "f81f7df79f76f72f6ef6af66f63f5ff5bf57f54f50f4cf48f45f41f3df39f36f32f2ef2b"
    "f27f23f20f1cf18f15f11f0df0af06f02effefbef7ef4ef0eedee9ee5ee2edeedbed7ed3"
    "ed0eccec9ec5ec2ebeebaeb7eb3eb0eacea9ea5ea2e9ee9be97e94e90e8de89e86e82e7f"
    "e7be78e75e71e6ee6ae67e63e60e5de59e56e52e4fe4ce48e45e41e3ee3be37e34e31e2d"
    "e2ae26e23e20e1ce19e16e12e0fe0ce09e05e02dffdfbdf8df5df1deedebde8de4de1dde"
    "ddbdd7dd4dd1dcedcadc7dc4dc1dbedbadb7db4db1daedaada7da4da1d9ed9bd97d94d91"
    "d8ed8bd88d84d81d7ed7bd78d75d72d6fd6bd68d65d62d5fd5cd59d56d53d50d4dd49d46"
    "d43d40d3dd3ad37d34d31d2ed2bd28d25d22d1fd1cd19d16d13d10d0dd0ad07d04d01cfe"
    "cfbcf8cf5cf2cefcecce9ce6ce3ce0cddcdbcd8cd5cd2ccfccccc9cc6cc3cc0cbdcbacb8"
    "cb5cb2cafcacca9ca6ca3ca1c9ec9bc98c95c92c8fc8dc8ac87c84c81c7ec7cc79c76c73"
    "c70c6ec6bc68c65c62c60c5dc5ac57c54c52c4fc4cc49c47c44c41c3ec3cc39c36c33c31"
    "c2ec2bc28c26c23c20c1ec1bc18c15c13c10c0dc0bc08c05c03c00bfdbfbbf8bf5bf3bf0"
    "bedbebbe8be5be3be0bddbdbbd8bd5bd3bd0bcebcbbc8bc6bc3bc0bbebbbbb9bb6bb3bb1"
    "baebacba9ba7ba4ba1b9fb9cb9ab97b95b92b8fb8db8ab88b85b83b80b7eb7bb79b76b73"
    "b71b6eb6cb69b67b64b62b5fb5db5ab58b55b53b50b4eb4bb49b46b44b41b3fb3db3ab38"
    "b35b33b30b2eb2bb29b26b24b22b1fb1db1ab18b15b13b11b0eb0cb09b07b05b02b00afd"
    "afbaf9af6af4af1aefaedaeaae8ae5ae3ae1adeadcadaad7ad5ad3ad0aceacbac9ac7ac4"
    "ac2ac0abdabbab9ab6ab4ab2aafaadaabaa8aa6aa4aa2a9fa9da9ba98a96a94a91a8fa8d"
    "a8ba88a86a84a82a7fa7da7ba78a76a74a72a6fa6da6ba69a66a64a62a60a5da5ba59a57"
    "a55a52a50a4ea4ca49a47a45a43a41a3ea3ca3aa38a36a33a31a2fa2da2ba28a26a24a22"
    "a20a1da1ba19a17a15a13a10a0ea0ca0aa08a06a04a019ff9fd9fb9f99f79f59f29f09ee"
    "9ec9ea9e89e69e49e19df9dd9db9d99d79d59d39d19ce9cc9ca9c89c69c49c29c09be9bc"
    "9ba9b79b59b39b19af9ad9ab9a99a79a59a39a199f99d99b99999799499299098e98c98a"
    "98898698498298097e97c97a97897697497297096e96c96a96896696496296095e95c95a"
    "95895695495295094e94c94a94894694494294093e93c93a93893793593393192f92d92b"
    "92992792592392191f91d91b91991791691491291090e90c90a9089069049029008ff8fd"
    "8fb8f98f78f58f38f18ef8ed8ec8ea8e88e68e48e28e08de8dc8db8d98d78d58d38d18cf"
    "8ce8cc8ca8c88c68c48c28c18bf8bd8bb8b98b78b58b48b28b08ae8ac8aa8a98a78a58a3"
    "8a189f89e89c89a89889689589389188f88d88c88a88888688488388187f87d87b87a878"
    "87687487287186f86d86b86a86886686486286185f85d85b85a85885685485385184f84d"
    "84c84a84884684584384183f83e83c83a83883783583383183082e82c82b829827825824"
    "82282081f81d81b81981881681481381180f80d80c80a8088078058038028007fe7fd7fb"
    "7f97f77f67f47f27f17ef7ed7ec7ea7e87e77e57e37e27e07de7dd7db7d97d87d67d47d3"
    "7d17d07ce7cc7cb7c97c77c67c47c27c17bf7be7bc7ba7b97b77b57b47b27b07af7ad7ac"
    "7aa7a87a77a57a47a27a079f79d79b79a79879779579379279078f78d78b78a788787785"
    "78478278077f77d77c77a77877777577477277176f76d76c76a76976776676476276175f"
    "75e75c75b75975875675475375175074e74d74b74a74874774574474274073f73d73c73a"
    "73973773673473373173072e72d72b72a72872772572372272071f71d71c71a719717716"
    "71471371171070e70d70b70a7087077057047037017006fe6fd6fb6fa6f86f76f56f46f2"
    "6f16ef6ee6ec6eb6e96e86e66e56e46e26e16df6de6dc6db6d96d86d66d56d36d26d16cf"
    "6ce6cc6cb6c96c86c66c56c46c26c16bf6be6bc6bb6ba6b86b76b56b46b26b16b06ae6ad"
    "6ab6aa6a86a76a66a46a36a1"
)

_RSQRT_TABLE = tuple(int(h[i:i + 3], 16)
                     for h in ("".join(_RSQRT_EST),)
                     for i in range(0, len(h), 3))
_REDUCE_WINDOW = 32


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


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values flushed to zeros of their sign, as
    XLA:CPU's flush-to-zero / denormals-are-zero modes do."""
    sub = (x.view(torch.int32) & 0x7FFFFFFF) < _FLT_MIN_BITS
    return torch.where(sub, x * 0.0, x)


def _as_f32(x) -> torch.Tensor:
    """A float32 tensor, subnormals taken as zeros (denormals-are-zero)."""
    return ftz(torch.as_tensor(x).to(torch.float32))


def _log_core(x: torch.Tensor) -> torch.Tensor:
    """``plog_float`` on positive normal float32 values (others clamped
    to ``FLT_MIN``)."""
    bits = x.view(torch.int32)
    clamped = torch.where(bits >= _FLT_MIN_BITS, bits, _FLT_MIN_BITS)
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
    return fma(_LN2HI, e, r)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``, bit for bit (module docstring)."""
    x = _as_f32(x)
    r = _log_core(x)
    r = torch.where(x < 0, torch.nan, r)
    r = torch.where(x == 0, -torch.inf, r)
    r = torch.where(torch.isposinf(x), torch.inf, r)
    return torch.where(torch.isnan(x), x, r)


def log1p(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p``, bit for bit (module docstring)."""
    a = _as_f32(a)
    den = 1.0 + a * 0.0                  # a·0 + 1: the chain's first term
    for c in _LOG1P_DEN:
        den = fma(den, a, c)
    num = _LOG1P_NUM[0] + a * 0.0
    for c in _LOG1P_NUM[1:]:
        num = fma(num, a, c)
    a2 = a * a
    small = a + fma(a2, -0.5, (a * a2) * (num / den))
    return ftz(torch.where(a.abs() < _LOG1P_SMALL, small, log(a + 1.0)))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``exp``, bit for bit (module docstring)."""
    x = _as_f32(x)
    x = torch.where(x < _EXP_LO, _EXP_LO, x)     # nan passes both clamps
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    n = torch.floor(fma(x, _LOG2E, 0.5))
    n = torch.where(n < -127.0, -127.0, n)
    n = torch.where(n > 127.0, 127.0, n)
    z = fma(-_EXP_C1, n, x)
    z = fma(-_EXP_C2, n, z)
    y = fma(z, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, z, c)
    y = 1.0 + fma(y, z * z, z)
    n_int = torch.where(torch.isnan(n), 0.0, n).to(torch.int32)
    return ftz(y * ((n_int + 127) << 23).view(torch.float32))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's ``vsqrtps``): the
    float64 root rounded once more, which is exact for a square root."""
    return _as_f32(x).to(torch.float64).sqrt().to(torch.float32)


def _rsqrt_estimate(x: torch.Tensor) -> torch.Tensor:
    """``rsqrtss`` on float32 values with no subnormal: positive normals
    from the table, the rest as the instruction gives them."""
    table = torch.tensor(_RSQRT_TABLE, dtype=torch.int32, device=x.device)
    bits = x.view(torch.int32)
    ex = (bits >> 23) & 0xFF
    idx = ((ex & 1) << 10) | ((bits >> 13) & 0x3FF)
    out_ex = 126 + torch.div(128 - ex, 2, rounding_mode="floor")
    est = ((out_ex << 23) | (table[idx.long()] << 11)).view(torch.float32)
    est = torch.where(x == 0, torch.where(bits < 0, -torch.inf, torch.inf),
                      est)
    est = torch.where(x < 0, torch.nan, est)
    est = torch.where(torch.isposinf(x), 0.0, est)
    return torch.where(torch.isnan(x), x, est)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``rsqrt``, bit for bit on an Intel host
    (module docstring)."""
    x = _as_f32(x)
    y0 = _rsqrt_estimate(x)
    y = y0
    for _ in range(2):
        y = fma(y * -0.5, fma(x * y, y, -1.0), y)
    # zeros, negatives and infinities keep the estimate (nan stays nan)
    estimate_only = (x <= 0) | torch.isinf(x)
    return torch.where(estimate_only, y0, y)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``erf_inv``, bit for bit (module docstring)."""
    x = _as_f32(x)
    lw = log1p(x * -x)                   # -w
    central = lw > -5.0
    t = torch.where(central, -2.5 - lw, sqrt(-lw) - 3.0)
    a = [torch.where(central, c, d)
         for c, d in zip(_ERFINV_CENTRAL, _ERFINV_TAIL)]
    p = fma(a[0], t, a[1])
    for c in a[2:]:
        p = fma(t, p, c)
    return ftz(x * torch.where(x.abs() == 1.0, torch.inf, p))


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 sum over the last axis, in its order (module
    docstring): (..., n) → (...)."""
    x = _as_f32(x)
    n = x.shape[-1]
    if n > _REDUCE_WINDOW:
        pad = -n % _REDUCE_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        windows = x.reshape(*x.shape[:-1], -1, _REDUCE_WINDOW)
        return reduce_sum(reduce_sum(windows))
    s = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(n):
        s = s + x[..., j]
    return s
