"""Threefry-2x32 and the key discipline of ``jax.random`` in plain PyTorch.

A frozen copy written from the algorithm (Salmon et al., SC'11; JAX's
default PRNG in its ``jax_threefry_partitionable`` mode): the benchmark's
reference works out every random draw of a TPFL round again from the
same key, independently of the program under test.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; leading
axes are a batch of keys.  ``split`` and ``fold_in`` hash the counter
``(0, i)`` / ``(0, data)`` under the key; ``bits`` hashes the flat
counter ``(0, i)`` of each output element and XORs the two words;
``uniform`` keeps the top 23 bits as a float32 in [0, 1).

The hash runs on int32 tensors whose adds wrap modulo 2**32; right
shifts are masked so that they act as logical shifts.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _s32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 as wrapping int32."""
    return x.to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def hash32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable int32 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: words ``(seed >> 32, seed & M32)``, the high
    word 0 for a seed that fits 32 signed bits."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & M32
    return torch.tensor([hi, seed & M32], dtype=torch.int64, device=device)


def _pair(key: torch.Tensor):
    return _s32(key[..., 0]), _s32(key[..., 1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) → (..., num, 2)."""
    k0, k1 = _pair(key)
    ctr = torch.arange(num, dtype=torch.int32, device=key.device)
    h0, h1 = hash32(k0[..., None], k1[..., None], torch.zeros_like(ctr), ctr)
    return torch.stack([_u32(h0), _u32(h1)], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k0, k1 = _pair(key)
    d = int(data) & M32
    d = d - (1 << 32) if d >= 1 << 31 else d
    h0, h1 = hash32(k0, k1, torch.zeros_like(k0), torch.full_like(k0, d))
    return torch.stack([_u32(h0), _u32(h1)], dim=-1)


def bits_at(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """The int32 words of ``bits(key, shape)`` at flat positions
    ``counters`` (int32, broadcast against the key's leading axes)."""
    k0, k1 = _pair(key)
    h0, h1 = hash32(k0, k1, torch.zeros_like(counters), counters)
    return h0 ^ h1


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """uint32 words (int64) of shape ``(..., *shape)``."""
    shape = tuple(shape)
    n = math.prod(shape)
    ctr = torch.arange(n, dtype=torch.int32, device=key.device)
    lead = key.shape[:-1]
    b = bits_at(key.reshape(-1, 1, 2), ctr[None])
    return _u32(b).reshape(lead + shape)


def mantissa(b32: torch.Tensor) -> torch.Tensor:
    """The top 23 bits of int32 hash words, as int32."""
    return (b32 >> 9) & ((1 << 23) - 1)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 on [0, 1): the 23 mantissa bits over 2**23."""
    m = mantissa(_s32(bits(key, shape)))
    return m.to(torch.float32) * (1.0 / (1 << 23))


def randint(key: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """int32 draws on [lo, hi): two words a value from ``split(key)``,
    folded into the span as ``(hi_w % span · (2**16 % span)**2 % span
    + lo_w % span) % span`` in uint32 arithmetic."""
    span = hi - lo
    k = split(key)
    hw, lw = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    mult = (2 ** 16 % span) ** 2 % span
    off = ((((hw % span) * mult) & M32) + (lw % span)) & M32
    return (lo + off % span).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax's sort-based shuffle of ``arange(n)``: per round, split the
    key and stable-sort the ids by one fresh word each."""
    x = torch.arange(n, device=key.device)
    for _ in range(math.ceil(3 * math.log(max(1, n)) / math.log(M32))):
        ks = split(key)
        key = ks[0]
        order = torch.sort(bits(ks[1], (n,)), stable=True).indices
        x = x[order]
    return x
