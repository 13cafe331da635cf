"""One epoch's feedback randomness for the fused epoch kernel.

Counterpart of ``repro/kernels/draws.py``, bit-identical to it through
:mod:`repro_torch.random`, with the same key discipline:

* per sample ``i``: ``k_neg, k_t, k_n = split(keys[i], 3)`` where
  ``keys = split(epoch_key, n_samples)``; the negative-class offset is
  ``randint(k_neg, (), 1, C)``;
* per role (target ``k_t`` / negative ``k_n``):
  ``k_act, k_s1, k_s2 = split(k, 3)`` — activation uniforms from
  ``k_act``, the Type-I increment / decrement coins from ``k_s1`` /
  ``k_s2``.

The coins are stored pre-compared, two bits per (clause, literal) in one
int8 plane, via the int-domain compare
``uniform(k, s) < p  ⟺  (bits(k, s) >> 9) < ceil(float32(p) · 2**23)``.

Keys may carry leading batch axes (one epoch key per client); the
outputs then carry them too.  The coin plane is built a few samples at a
time, so the hash words of a whole epoch (2 × 4 bytes per coin) are
never held at once.

The key chain (:func:`epoch_keys`) and the draws from the role keys
(:func:`role_draws`) are apart: on the GPU the fused epoch kernel, and
the TA-transition kernel of the unit-weight scan, take the role keys
and hash only the draws they read, in the kernel
(``csrc/threefry.h``); the plain versions, and the CPU, draw the whole
planes (:func:`role_draws`, or ``random.uniform`` per sample step).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random as rnd

_MANTISSA = float(1 << 23)
_CHUNK = 1 << 25      # coin elements hashed per pass, per plane


def int_threshold(p: float) -> int:
    """uniform(k, s) < p  ⟺  (bits(k, s) >> 9) < int_threshold(p)."""
    return math.ceil(float(np.float32(p)) * _MANTISSA)


def epoch_keys(key: torch.Tensor, n_samples: int, n_classes: int):
    """The epoch's key chain for keys ``(..., 2)``: returns
    ``(offsets, role_keys)``:

    * ``offsets``   (..., S) int32 — negative-class offset in [1, C);
    * ``role_keys`` (..., S, 2, 3, 2) uint32 words in int64 —
      ``[k_act, k_s1, k_s2]`` of role 0 (target) and 1 (negative).

    A few hashes per sample: the fused epoch kernel draws the rest from
    ``role_keys`` itself."""
    keys = rnd.split(key, n_samples)                      # (..., S, 2)
    sub = rnd.split(keys, 3)                              # (..., S, 3, 2)
    offsets = rnd.randint(sub[..., 0, :], (), 1, n_classes)
    return offsets, rnd.split(sub[..., 1:, :], 3)


def role_draws(role_keys: torch.Tensor, n_clauses: int, n_literals: int,
               p_inc: float, p_dec: float):
    """``(u_act, coin)`` of role keys ``(..., S, 2, 3, 2)``:

    * ``u_act`` (..., S, 2, m) float32 — role 0 target, 1 negative;
    * ``coin``  (..., S, 2, m, L) int8 — bit 1 ``u < p_inc``,
      bit 2 ``u < p_dec``.
    """
    m, L = n_clauses, n_literals
    t_inc, t_dec = int_threshold(p_inc), int_threshold(p_dec)
    *batch, n_samples = role_keys.shape[:-3]
    batch = tuple(batch)
    u_act = rnd.uniform(role_keys[..., 0, :], (m,))
    coin = torch.empty(batch + (n_samples, 2, m, L), dtype=torch.int8,
                       device=role_keys.device)
    per_sample = max(1, math.prod(batch) * 2 * m * L)
    step = max(1, _CHUNK // per_sample)
    for s0 in range(0, n_samples, step):
        s1 = min(s0 + step, n_samples)
        k1 = role_keys[..., s0:s1, :, 1, :]
        k2 = role_keys[..., s0:s1, :, 2, :]
        c = (rnd.mantissa_bits(k1, (m, L)) < t_inc).to(torch.int8)
        c += 2 * (rnd.mantissa_bits(k2, (m, L)) < t_dec).to(torch.int8)
        coin[..., s0:s1, :, :, :] = c
    return u_act, coin


def epoch_draws(key: torch.Tensor, n_samples: int, n_clauses: int,
                n_literals: int, n_classes: int, p_inc: float,
                p_dec: float):
    """Returns ``(offsets, u_act, coin)`` for keys ``(..., 2)``: the
    :func:`epoch_keys` offsets and the :func:`role_draws` of its role
    keys."""
    offsets, role_keys = epoch_keys(key, n_samples, n_classes)
    return (offsets, *role_draws(role_keys, n_clauses, n_literals, p_inc,
                                 p_dec))
