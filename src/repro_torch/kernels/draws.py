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


def epoch_draws(key: torch.Tensor, n_samples: int, n_clauses: int,
                n_literals: int, n_classes: int, p_inc: float,
                p_dec: float):
    """Returns ``(offsets, u_act, coin)`` for keys ``(..., 2)``:

    * ``offsets`` (..., S) int32 — negative-class offset in [1, C);
    * ``u_act``   (..., S, 2, m) float32 — role 0 target, 1 negative;
    * ``coin``    (..., S, 2, m, L) int8 — bit 1 ``u < p_inc``,
      bit 2 ``u < p_dec``.
    """
    m, L = n_clauses, n_literals
    t_inc, t_dec = int_threshold(p_inc), int_threshold(p_dec)
    batch = key.shape[:-1]
    keys = rnd.split(key, n_samples)                      # (..., S, 2)
    sub = rnd.split(keys, 3)                              # (..., S, 3, 2)
    offsets = rnd.randint(sub[..., 0, :], (), 1, n_classes)
    role = rnd.split(sub[..., 1:, :], 3)                  # (..., S, 2, 3, 2)
    u_act = rnd.uniform(role[..., 0, :], (m,))
    coin = torch.empty(batch + (n_samples, 2, m, L), dtype=torch.int8,
                       device=key.device)
    per_sample = max(1, math.prod(batch) * 2 * m * L)
    step = max(1, _CHUNK // per_sample)
    for s0 in range(0, n_samples, step):
        s1 = min(s0 + step, n_samples)
        k1 = role[..., s0:s1, :, 1, :]
        k2 = role[..., s0:s1, :, 2, :]
        c = (rnd.mantissa_bits(k1, (m, L)) < t_inc).to(torch.int8)
        c += 2 * (rnd.mantissa_bits(k2, (m, L)) < t_dec).to(torch.int8)
        coin[..., s0:s1, :, :, :] = c
    return offsets, u_act, coin
