"""CUDA wrapper of the fused training-epoch kernel (``csrc/train_epoch.cu``).

Counterpart of ``repro/kernels/train_epoch.py::train_epoch_pallas`` fed by
``repro/kernels/draws.py::epoch_draws``: it takes the epoch's role keys
(:func:`repro_torch.kernels.draws.epoch_keys`) instead of the drawn
uniforms and coin plane, and the kernel hashes the draws it reads.  The
kernel writes new banks and weights: callers may still hold the inputs,
as they may with immutable JAX arrays.  Its plain version is
:func:`train_epoch_plain`: the same draws made with
:func:`draws.role_draws`, then :func:`ref.train_epoch_ref`.

The launcher has two plans (``csrc/epoch_plan.h``): the shared plan
keeps each block's include bits in shared memory and is the plan of
every shape it holds; the global plan keeps them in an (N, C, m, W)
device buffer this wrapper allocates, for shapes whose bits no cluster
holds (62 classes of 300 clauses at L = 1568).  ``inc_global=True``
forces the global plan at any shape, to hold and time it beside the
shared plan; nothing on the training path sets it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, draws, ref

_DTYPES = {"ta": torch.int32, "w": torch.int32, "lits": torch.int32,
           "cls2": torch.int32, "role_keys": torch.int64}
_NO_PLAN = -1            # the launcher's code for a shape it cannot hold
# launches by plan (each also counted in LAUNCHES["train_epoch_fused"])
PLAN_LAUNCHES = {"shared": 0, "global": 0}
_PLANS: dict = {}        # (device, N, C, m, L, forced) -> Plan


class Plan(NamedTuple):
    cluster: int     # blocks per client (one cluster); the grid is (K, N)
    owned: int       # the most clauses a block owns
    smem: int        # dynamic shared memory a block, bytes
    waves: int       # rounds of N clusters the card takes
    smallest: int    # the smallest cluster that holds the include bits
    kmax: int        # the most blocks a cluster may take on this card
    #                  (16 with the non-portable opt-in, else 8)
    inc_global: int  # 1: the include bits lie in device memory


def plan(N: int, C: int, m: int, L: int, inc_global: bool = False) -> Plan:
    """The launcher's plan of an epoch over N clients of (C, m, L) banks on
    the current CUDA device (it queries the device's cluster occupancy and
    launches nothing); ``inc_global`` forces the global plan.  Raises
    ``ValueError`` for a shape the kernel cannot hold."""
    out = (ctypes.c_int * 7)()
    err = _build.function("train_epoch_plan")(N, C, m, L, int(inc_global),
                                              out)
    if err == _NO_PLAN:
        raise ValueError(_no_plan(N, C, m, L))
    if err != 0:
        raise RuntimeError(f"train_epoch_plan: CUDA error {err}")
    return Plan(*out)


def _no_plan(N, C, m, L) -> str:
    return (f"train_epoch_fused: no launch plan for (N, C, m, L) = "
            f"({N}, {C}, {m}, {L}): a block's weights and staged samples "
            f"need the shared memory of more blocks than a cluster may take "
            f"(16, or 8 without the non-portable opt-in), m·L or a "
            f"client's include words reach 2**31, or the device runs no "
            f"such cluster")


def train_epoch_fused(ta: torch.Tensor, w: torch.Tensor, lits: torch.Tensor,
                      cls2: torch.Tensor, role_keys: torch.Tensor, *,
                      n_states: int, T: int, p_inc: float, p_dec: float,
                      inc_global: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """ta (N,C,m,L) i32, w (N,C,m) i32, lits (N,S,L) i32 0/1,
    cls2 (N,S,2) i32, role_keys (N,S,2,3,2) int64 uint32 words
    (:func:`draws.epoch_keys`) → (ta, w) after one epoch, one launch, with
    the Type I coins drawn at ``p_inc`` / ``p_dec``.  TA states must lie in
    [1, 2·n_states], as every state the TM produces does.
    ``inc_global`` forces the global plan (module docstring).  Raises
    ``ValueError`` for a shape the kernel cannot hold (see :func:`plan`)."""
    args = {"ta": ta, "w": w, "lits": lits, "cls2": cls2,
            "role_keys": role_keys}
    for name, a in args.items():
        if not a.is_cuda:
            raise ValueError(f"train_epoch_fused: {name} is not a CUDA "
                             f"tensor; CPU tensors go to train_epoch_plain")
        if a.dtype != _DTYPES[name]:
            raise ValueError(f"train_epoch_fused: {name} must be "
                             f"{_DTYPES[name]}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"train_epoch_fused: {name} must be "
                             f"contiguous")
    N, C, m, L = ta.shape
    S = lits.shape[1]
    want = {"w": (N, C, m), "lits": (N, S, L), "cls2": (N, S, 2),
            "role_keys": (N, S, 2, 3, 2)}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"train_epoch_fused: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if cls2.numel() and (int(cls2.min()) < 0 or int(cls2.max()) >= C):
        raise ValueError("train_epoch_fused: class ids outside [0, C)")
    key = (torch.cuda.current_device(), N, C, m, L, bool(inc_global))
    p = _PLANS.get(key)
    if p is None and N > 0:
        p = _PLANS[key] = plan(N, C, m, L, inc_global)
    inc = (torch.empty((N, C, m, (L + 31) // 32), dtype=torch.int32,
                       device=ta.device) if p is not None and p.inc_global
           else None)
    ta_out, w_out = torch.empty_like(ta), torch.empty_like(w)
    err = _build.function("train_epoch_fused")(
        ta_out.data_ptr(), w_out.data_ptr(), ta.data_ptr(), w.data_ptr(),
        lits.data_ptr(), cls2.data_ptr(), role_keys.data_ptr(),
        None if inc is None else inc.data_ptr(), N, C, m, L, S,
        int(n_states), int(T), draws.int_threshold(p_inc),
        draws.int_threshold(p_dec), int(inc_global),
        torch.cuda.current_stream(ta.device).cuda_stream)
    if err == _NO_PLAN:
        raise ValueError(_no_plan(N, C, m, L))
    _build.check("train_epoch_fused", err)
    if p is not None:
        PLAN_LAUNCHES["global" if p.inc_global else "shared"] += 1
    return ta_out, w_out


def train_epoch_plain(ta: torch.Tensor, w: torch.Tensor, lits: torch.Tensor,
                      cls2: torch.Tensor, role_keys: torch.Tensor, *,
                      n_states: int, T: int, p_inc: float, p_dec: float,
                      stats: dict | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`train_epoch_fused`, on either device:
    the role keys' activation uniforms and coin plane
    (:func:`draws.role_draws`), then :func:`ref.train_epoch_ref` (which
    fills ``stats`` if given)."""
    m, L = ta.shape[2:]
    u_act, coin = draws.role_draws(role_keys, m, L, p_inc, p_dec)
    return ref.train_epoch_ref(ta, w, lits, cls2, u_act, coin,
                               n_states=n_states, T=T, stats=stats)
