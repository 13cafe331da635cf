"""The key chain of one local epoch (``csrc/key_chain.cu``) and its plain
version.

For N clients of S samples each: the class pairs ``cls2`` (N, S, 2)
int32, ``[y, (y + offset) % C]`` with the negative-class offset
``randint(k_neg, (), 1, C)``, and the role keys ``role_keys``
(N, S, 2, 3, 2) uint32 words in int64, ``[k_act, k_s1, k_s2]`` of the
target and the negative role: what the fused epoch
(:func:`repro_torch.kernels.train_epoch.train_epoch_fused`) and the TA
transition of the unit-weight scan draw from.  The keys are the epoch
keys, or with ``epoch`` the clients' keys, whose
``split(key, epochs)[epoch]`` is the epoch key.

The kernel computes it in one launch, one thread a (client, sample)
(``threefry::sample_chain``).  Its plain version, :func:`key_chain_plain`,
is the composition the JAX package's chain is held against on the CPU:
:func:`repro_torch.kernels.draws.epoch_keys`, then the class pairs.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.kernels import _build, draws

_LABELS = (torch.int32, torch.int64)   # read as held; others converted


def _check(keys: torch.Tensor, ys: torch.Tensor, n_classes: int) -> None:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"key_chain: keys must be int64 (N, 2), got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if ys.dim() != 2 or ys.shape[0] != keys.shape[0]:
        raise ValueError(f"key_chain: ys must be (N, S) with N = "
                         f"{keys.shape[0]}, got {tuple(ys.shape)}")
    if n_classes < 1:
        raise ValueError(f"key_chain: n_classes must be at least 1, got "
                         f"{n_classes}")


def key_chain(keys: torch.Tensor, ys: torch.Tensor, n_classes: int,
              epoch: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """keys (N, 2) int64 and labels ys (N, S) on one CUDA device →
    ``(cls2, role_keys)`` in one launch.  ``epoch`` None: the keys are the
    epoch keys; else the clients' keys, split into epochs on the card."""
    _check(keys, ys, n_classes)
    if not (keys.is_cuda and ys.device == keys.device):
        raise ValueError("key_chain: keys and ys must lie on one CUDA "
                         "device; CPU tensors go to key_chain_plain")
    if ys.dtype not in _LABELS:
        ys = ys.to(torch.int64)
    N, S = ys.shape
    if N * S >= 1 << 31:
        raise ValueError(f"key_chain: N · S = {N * S} reaches 2**31")
    cls2 = torch.empty((N, S, 2), dtype=torch.int32, device=keys.device)
    role_keys = torch.empty((N, S, 2, 3, 2), dtype=torch.int64,
                            device=keys.device)
    if N * S == 0:
        return cls2, role_keys
    err = _build.function("key_chain")(
        cls2.data_ptr(), role_keys.data_ptr(), keys.data_ptr(),
        keys.stride(0), keys.stride(1), ys.data_ptr(),
        int(ys.dtype == torch.int64), ys.stride(0), ys.stride(1), N, S,
        int(n_classes), -1 if epoch is None else int(epoch),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check("key_chain", err)
    return cls2, role_keys


def key_chain_plain(keys: torch.Tensor, ys: torch.Tensor, n_classes: int,
                    epoch: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`key_chain`, on either device:
    ``draws.epoch_keys`` of the epoch keys (``split(keys, epoch + 1)`` at
    ``epoch`` where it is given), then ``[y, (y + offset) % C]``."""
    _check(keys, ys, n_classes)
    if epoch is not None:
        keys = rnd.split(keys, epoch + 1)[:, epoch]
    offs, role_keys = draws.epoch_keys(keys, ys.shape[1], n_classes)
    ys32 = ys.to(torch.int32)
    cls2 = torch.stack([ys32, (ys32 + offs) % n_classes],
                       dim=-1).contiguous()                 # (N, S, 2)
    return cls2, role_keys
