"""Counterpart of the part of ``jax.random`` the TPFL round uses.

Bit-exact to ``jax.random`` with its default threefry implementation in
``jax_threefry_partitionable=True`` mode (the default since jax 0.5):

* a key is a tensor whose last axis holds two uint32 words, ``(..., 2)``;
  leading axes are a batch of keys, the written-out form of ``jax.vmap``
  over keys, so every function here maps over them;
* ``split`` and ``fold_in`` hash the counter ``(0, i)`` / ``(0, data)``
  under the key; ``bits`` hashes the flat iota counter ``(0, i)`` over the
  output shape and XORs the two hash words;
* ``uniform`` keeps the top 23 bits as an f32 mantissa in [1, 2) and
  subtracts 1; ``bernoulli`` is ``uniform < p``; ``randint`` draws two
  words per value (from ``split(key)``) and folds them into the span with
  jax's modular recipe;
* ``permutation`` is jax's sort-based shuffle (stable sorts of the ids by
  fresh 32-bit words, ``ceil(3·ln n / ln(2**32 - 1))`` rounds);
  ``gumbel`` is ``-log(-log(uniform(minval=tiny)))`` in jax's default
  ("low") mode; ``choice`` without replacement is a permutation's head,
  or with weights the top k of ``gumbel + log(p)``; ``categorical``
  (with replacement) is the argmax of ``gumbel + logits``;
* ``normal`` is ``sqrt(2)·erf_inv(u)``, u uniform on (-1, 1);
  ``exponential`` is ``-log1p(-u)``;
* ``loggamma`` is Marsaglia and Tsang's method as jax lowers it under
  ``vmap``: one key a lane, ``split(key, n)`` over the flattened
  output; a lane below 1 is boosted to ``a + 1`` and corrected in log
  space with an exponential draw.  Each lane's rejection loop, and the
  inner loop that redraws a normal until ``v > 0``, runs as a masked
  loop over the lanes still drawing, each advancing its own key chain
  only; ``dirichlet`` is the softmax of ``loggamma`` over the last axis.

The float32 math (``log``, ``log1p``, ``exp``, ``erf_inv``, ``rsqrt``,
the softmax's sum, the FMAs XLA contracts) is XLA:CPU's, bit for bit
(:mod:`repro_torch.xla_f32`), not torch's.

torch has no uint32 arithmetic.  Keys and ``bits`` hold uint32 words in
int64 tensors; the hash itself runs on int32 tensors, whose adds wrap
modulo 2**32, with right shifts masked to be logical.  Large draws are
hashed a chunk of counters at a time, so a caller never holds more than
a chunk of temporaries at once.

Not ported yet: ``jax_threefry_partitionable=False`` mode and ``choice``
with replacement (see ROADMAP.md).
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as devices
from repro_torch import xla_f32

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# hashed elements per pass: cache-sized on the CPU, large on the GPU
_CHUNK = {"cpu": 1 << 16, "cuda": 1 << 24}


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 0..2**32-1) as wrapping int32 tensors."""
    return x.to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Wrapping int32 back to uint32 words in int64."""
    return x.to(torch.int64) & _M32


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int32 tensors whose
    adds wrap modulo 2**32; right shifts are masked to be logical."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + k0
    x1 = x1 + k1
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1 >>= 32 - r
            x1 &= (1 << r) - 1
            x1 |= tmp
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += i + 1
    return x0, x1


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 on broadcastable int64 tensors holding uint32 words.
    Returns the two hashed words, as uint32 words in int64."""
    if x1.is_meta:               # shapes only (``ModelConfig.param_count``)
        shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape,
                                       x1.shape)
        return (torch.empty(shape, dtype=torch.int64, device="meta"),) * 2
    h0, h1 = _threefry(_i32(k0), _i32(k1), _i32(x0), _i32(x1))
    return _u32(h0), _u32(h1)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & M)``,
    with a 32-bit seed's high word 0 (jax's default 32-bit mode), on
    ``device`` (the GPU unless the caller names another)."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _M32
    return torch.tensor([hi, seed & _M32], dtype=torch.int64,
                        device=devices.resolve(device))


def _words(key: torch.Tensor):
    if key.shape[-1:] != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is an int64 (..., 2) tensor of uint32 "
                         f"words, got {key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) → (..., num, 2)."""
    k0, k1 = _words(key)
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None],
                          torch.zeros_like(ctr), ctr)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit ``data``: (..., 2) → (..., 2)."""
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(k0),
                          torch.full_like(k0, int(data) & _M32))
    return torch.stack([b0, b1], dim=-1)


def _bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` as wrapping int32 words, (..., *shape)."""
    shape = tuple(shape)
    k0, k1 = _words(key)
    batch = k0.shape
    k0, k1 = _i32(k0.reshape(-1, 1)), _i32(k1.reshape(-1, 1))
    size = math.prod(shape)
    if size >= 1 << 31:
        raise NotImplementedError("bits: 2**31 or more values per key")
    out = torch.empty((k0.shape[0], size), dtype=torch.int32,
                      device=key.device)
    chunk = _CHUNK["cuda" if key.is_cuda else "cpu"]
    step = max(1, chunk // max(1, k0.shape[0]))
    for c0 in range(0, size, step):
        ctr = torch.arange(c0, min(c0 + step, size), dtype=torch.int32,
                           device=key.device)[None]
        h0, h1 = _threefry(k0, k1, torch.zeros_like(ctr), ctr)
        out[:, c0:c0 + ctr.shape[1]] = h0 ^ h1
    return out.reshape(batch + shape)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (uint32): (..., 2) → (..., *shape) int64 words."""
    return _u32(_bits32(key, shape))


def mantissa_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``bits(key, shape) >> 9`` as int32: the 23 bits ``uniform`` uses.

    ``uniform(key, s) < p  ⟺  mantissa_bits(key, s) < ceil(f32(p)·2**23)``.
    """
    return _mantissa_(_bits32(key, shape))


def _mantissa_(b: torch.Tensor) -> torch.Tensor:
    """Hashed words (int32) to their top 23 bits, in place."""
    b >>= 9
    b &= (1 << 23) - 1
    return b


def _unit(m: torch.Tensor) -> torch.Tensor:
    """23 mantissa bits (int32) as the float32 in [0, 1) they encode."""
    return (m | 0x3F800000).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval): the unit
    draw scaled by ``f32(maxval - minval)`` and shifted in one FMA, then
    clamped below at ``minval``."""
    f = _unit(mantissa_bits(key, shape))
    if (minval, maxval) == (0.0, 1.0):     # the FMA and clamp keep f as is
        return f
    lo = torch.tensor(minval, dtype=torch.float32).item()
    span = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    return torch.clamp_min(xla_f32.fma(f, span, lo), lo)


def bernoulli(key: torch.Tensor, p, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < float32(p)``."""
    u = uniform(key, shape)
    p = torch.as_tensor(p, dtype=torch.float32, device=u.device)
    return u < p


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` for int32 with Python-int bounds."""
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    if span > 1 << 31:
        raise NotImplementedError("randint: spans above 2**31")
    k = split(key)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    mult = (2 ** 16 % span) ** 2 % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (..., 2) → (..., n) int32.

    jax's ``_shuffle``: each round splits the key, draws one 32-bit word
    per id from the subkey and stable-sorts the ids by them."""
    x = torch.arange(n, device=key.device).expand(key.shape[:-1] + (n,))
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        ks = split(key)
        key = ks[..., 0, :]
        order = torch.sort(bits(ks[..., 1, :], (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x.to(torch.int32)


def _gumbel(m: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = (_unit(m) + tiny).clamp_min(tiny)
    return -xla_f32.log(-xla_f32.log(u))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, jax's default ("low") mode:
    ``-log(-log(u))``, u uniform on [tiny, 1), with XLA:CPU's ``log``."""
    return _gumbel(mantissa_bits(key, shape))


def gumbel_at(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """The values ``gumbel(key, shape)`` takes at the flat output
    positions ``counters`` (int64, below 2**31), without drawing the
    rest: keys (..., 2) and counters (..., M), one key a row of
    counters."""
    k0, k1 = _words(key)
    k0, k1 = _i32(k0), _i32(k1)
    out = torch.empty(counters.shape, dtype=torch.float32,
                      device=counters.device)
    if counters.numel() == 0:
        return out
    k0, k1 = (torch.broadcast_to(k[..., None], counters.shape[:-1] + (1,))
              for k in (k0, k1))
    lead = counters.reshape(-1, counters.shape[-1])
    k0, k1 = k0.reshape(-1, 1), k1.reshape(-1, 1)
    flat = out.view(-1, counters.shape[-1])
    chunk = _CHUNK["cuda" if counters.is_cuda else "cpu"]
    step = max(1, chunk // max(1, lead.shape[1]))
    for r0 in range(0, lead.shape[0], step):
        ctr = lead[r0:r0 + step].to(torch.int32)
        h0, h1 = _threefry(k0[r0:r0 + step], k1[r0:r0 + step],
                           torch.zeros_like(ctr), ctr)
        flat[r0:r0 + step] = _gumbel(_mantissa_(h0 ^ h1))
    return out


def choice(key: torch.Tensor, n: int, k: int, replace: bool = False,
           p: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False, p=p)``:
    (..., 2) → (..., k) int32 ids of ``arange(n)``.

    Uniform: the head of :func:`permutation`.  Weighted: the Gumbel
    top-k, the k largest of ``gumbel(key, (n,)) + log(p)``, ties to the
    lower id as ``lax.top_k`` breaks them."""
    if replace:
        raise NotImplementedError("choice: sampling with replacement")
    if not 0 < k <= n:
        raise ValueError(f"choice: cannot take {k} of {n} without "
                         f"replacement")
    if p is None:
        return permutation(key, n)[..., :k]
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    if p.shape != (n,):
        raise ValueError(f"choice: p has shape {tuple(p.shape)}, not ({n},)")
    g = gumbel(key, (n,)) + xla_f32.log(p)
    top = torch.sort(g, dim=-1, descending=True, stable=True).indices
    return top[..., :k].to(torch.int32)


_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
_ONE_THIRD = float(torch.tensor(1.0 / 3.0, dtype=torch.float32))
_SQUEEZE = float(torch.tensor(0.0331, dtype=torch.float32))
# jax's normal draws u on (nextafter(-1, 0), 1)
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``f32(sqrt 2)·erf_inv(u)``."""
    if key.is_meta:              # shapes only (``ModelConfig.param_count``)
        return torch.empty(key.shape[:-1] + tuple(shape),
                           dtype=torch.float32, device="meta")
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return xla_f32.ftz(xla_f32.erf_inv(u) * _SQRT2)


def exponential(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential`` in float32: ``-log1p(-u)``."""
    return -xla_f32.log1p(-uniform(key, shape))


def _redraw_normal(keys: torch.Tensor, c: torch.Tensor):
    """Marsaglia-Tsang's inner loop, lane by lane: from each lane's key,
    split off normals until ``v = fma(c, x, 1)`` is positive.  Returns
    (x, v)."""
    keys = keys.clone()
    x = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    v = torch.full_like(x, -1.0)
    lanes = torch.arange(c.numel(), device=c.device)
    while lanes.numel():
        ks = split(keys[lanes])
        keys[lanes] = ks[:, 0]
        xl = normal(ks[:, 1])
        vl = xla_f32.fma(c[lanes], xl, 1.0)
        x[lanes], v[lanes] = xl, vl
        lanes = lanes[vl <= 0]
    return x, v


def _rejects(X, V, U, d) -> torch.Tensor:
    """Marsaglia-Tsang's loop condition: the squeeze test and the log
    test both fail to accept."""
    squeeze = xla_f32.fma(-(X * X), _SQUEEZE, 1.0)
    bound = xla_f32.fma(X, 0.5, d * ((1.0 - V) + xla_f32.log(V)))
    return (U >= squeeze) & (xla_f32.log(U) >= bound)


def loggamma(key: torch.Tensor, a, shape=None) -> torch.Tensor:
    """``jax.random.loggamma(key, a, shape)`` in float32: the log of a
    Gamma(a) draw a lane, one key ``(2,)`` for the whole output."""
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = tuple(a.shape) if shape is None else tuple(shape)
    a = torch.broadcast_to(a, shape).reshape(-1)
    n = a.numel()
    boost = a >= 1.0
    alpha = torch.where(boost, a, a + 1.0)
    d = alpha - _ONE_THIRD
    c = xla_f32.rsqrt(d) * _ONE_THIRD
    ks = split(split(key, n))
    keys, sub = ks[:, 0].clone(), ks[:, 1]
    # (X, V, U) = (0, 1, 2) rejects in every lane: all lanes start
    X = torch.zeros(n, dtype=torch.float32, device=key.device)
    V = torch.ones_like(X)
    U = torch.full_like(X, 2.0)
    lanes = torch.arange(n, device=key.device)
    while lanes.numel():
        k3 = split(keys[lanes], 3)
        keys[lanes] = k3[:, 0]
        x, v = _redraw_normal(k3[:, 1], c[lanes])
        X[lanes], V[lanes] = x * x, (v * v) * v
        U[lanes] = uniform(k3[:, 2])
        lanes = lanes[_rejects(X[lanes], V[lanes], U[lanes], d[lanes])]
    log_u = xla_f32.log1p(-uniform(sub))          # -exponential(sub)
    inv = (1.0 / a.to(torch.float64)).to(torch.float32)   # = f32 1 / a
    log_boost = torch.where(boost | (log_u == 0), 0.0, log_u * inv)
    out = (xla_f32.log(d) + xla_f32.log(V)) + log_boost
    return out.reshape(shape)


def dirichlet(key: torch.Tensor, alpha, shape=None) -> torch.Tensor:
    """``jax.random.dirichlet(key, alpha, shape)`` in float32: the
    softmax of ``loggamma`` over the last axis (XLA:CPU's ``exp``, sum
    order and flush-to-zero)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    shape = tuple(alpha.shape[:-1]) if shape is None else tuple(shape)
    lg = loggamma(key, alpha, shape + tuple(alpha.shape[-1:]))
    e = xla_f32.exp(lg - lg.amax(-1, keepdim=True))
    return xla_f32.ftz(e / xla_f32.reduce_sum(e)[..., None])


def categorical(key: torch.Tensor, logits: torch.Tensor, shape=()
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` (with
    replacement, ``axis=-1``): the argmax of ``gumbel + logits``, ties
    to the lower index.  A batch of keys (..., 2) takes logits (..., C)
    with the same leading axes (the written-out ``vmap``): (..., *shape)
    int32 draws."""
    shape = tuple(shape)
    logits = torch.as_tensor(logits, dtype=torch.float32, device=key.device)
    g = gumbel(key, shape + tuple(logits.shape[-1:]))
    lead = logits.shape[:-1]
    logits = logits.reshape(lead + (1,) * len(shape) + logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1).to(torch.int32)
