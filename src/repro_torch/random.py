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
  or with weights the top k of ``gumbel + log(p)``.  The two ``log``
  calls are XLA:CPU's float32 ``log`` (:mod:`repro_torch.xla_f32`),
  bit for bit, not torch's.

torch has no uint32 arithmetic.  Keys and ``bits`` hold uint32 words in
int64 tensors; the hash itself runs on int32 tensors, whose adds wrap
modulo 2**32, with right shifts masked to be logical.  Large draws are
hashed a chunk of counters at a time, so a caller never holds more than
a chunk of temporaries at once.

Not ported yet: ``jax_threefry_partitionable=False`` mode, ``dirichlet``,
``categorical`` and ``choice`` with replacement (see ROADMAP.md).
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
    b = _bits32(key, shape)
    b >>= 9
    b &= (1 << 23) - 1
    return b


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [0, 1)."""
    m = mantissa_bits(key, shape)
    m |= 0x3F800000
    return m.view(torch.float32) - 1.0


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


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, jax's default ("low") mode:
    ``-log(-log(u))``, u uniform on [tiny, 1), with XLA:CPU's ``log``."""
    tiny = torch.finfo(torch.float32).tiny
    u = (uniform(key, shape) + tiny).clamp_min(tiny)
    return -xla_f32.log(-xla_f32.log(u))


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
