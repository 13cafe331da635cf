"""CUDA wrappers of the clause-evaluation kernels (``csrc/clause_eval.cu``).

Counterparts of ``repro/kernels/clause_eval.py``'s three kernels, with
their results: :func:`clause_outputs` (``clause_outputs_pallas``),
:func:`fused_votes` (``fused_votes_pallas``) and
:func:`fused_votes_batched` (``fused_votes_batched_pallas``).  Each is its
own launch with its own count.  The plain versions are the functions of
the same names in :mod:`repro_torch.kernels.ref`.

The two vote wrappers share one kernel (``votes_mma_kernel``): it takes
the include plane as the bool bytes ``tm.include_mask`` gives, the
literals as the int32 ``tm.literals`` gives and ``wpol`` as int32 at any
strides, so a call at those dtypes is one device operation (the output is
``torch.empty``).  The C launcher plans its thread-block clusters, its
passes over the samples and its shared-memory rings from the shape;
:func:`plan` asks it for that plan.  ``clause_outputs`` takes the include
plane and ``1 - lits`` as 0/1 bytes, padded with zero bytes to a multiple
of 4 literals so it can count violations four literals per ``popc``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build


def _bytes(a: torch.Tensor, lp: int) -> torch.Tensor:
    """0/1 values as a contiguous uint8 plane padded to ``lp`` columns."""
    if a.shape[-1] == lp:
        if a.dtype == torch.bool:
            return a.contiguous().view(torch.uint8)
        return a.to(torch.uint8).contiguous()
    out = torch.zeros(a.shape[:-1] + (lp,), dtype=torch.uint8,
                      device=a.device)
    out[..., :a.shape[-1]] = a
    return out


def _cuda(fn: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{fn}: the kernel takes CUDA tensors; CPU tensors "
                         f"go to kernels.ref")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def clause_outputs(include: torch.Tensor, lits: torch.Tensor,
                   predict: bool = False) -> torch.Tensor:
    """include (CM,L) or (NB,CM,L) 0/1; lits (B,L) or (NB,B,L) 0/1 →
    fired (B,CM) or (NB,B,CM) int32, one launch."""
    _cuda("clause_outputs", include, lits)
    if include.ndim not in (2, 3) or lits.ndim != include.ndim:
        raise ValueError("clause_outputs: include (CM,L) with lits (B,L), "
                         "or include (NB,CM,L) with lits (NB,B,L)")
    lead = include.shape[:-2]
    CM, L = include.shape[-2:]
    B = lits.shape[-2]
    if lits.shape != lead + (B, L):
        raise ValueError(f"clause_outputs: shapes disagree: include "
                         f"{tuple(include.shape)}, lits {tuple(lits.shape)}")
    lp = -(-L // 4) * 4
    inc = _bytes(include, lp)
    nlit = _bytes(1 - lits.to(torch.int32), lp)
    out = torch.empty(lead + (B, CM), dtype=torch.int32,
                      device=include.device)
    fn = _build.function("clause_outputs")
    err = fn(inc.data_ptr(), nlit.data_ptr(), out.data_ptr(),
             lead[0] if lead else 1, CM, lp // 4, B, int(bool(predict)),
             _stream(include))
    _build.check("clause_outputs", err)
    return out


class Plan(NamedTuple):
    """How ``votes_mma_kernel`` covers one call, as the launcher plans it
    (``plan_votes`` in ``csrc/votes_plan.h``): ``cluster`` blocks per
    (client, class) split its 16-clause tiles (and, with more than 8
    samples a pass, stage the samples once between them); ``ks`` warps
    of a block split one tile's chunks; ``samples`` samples are staged per pass
    (every sample in one pass when they fit); ``nt`` n-tiles of 8 samples
    is the kernel's instantiation; ``stages`` the shared-memory ring
    stages of each warp; ``smem`` and ``static_smem`` its dynamic and
    static shared memory in bytes."""
    cluster: int
    ks: int
    samples: int
    nt: int
    stages: int
    smem: int
    static_smem: int


def plan(N: int, C: int, m: int, L: int, B: int, sms: int) -> Plan:
    """The launcher's plan of a vote call (include (N,C,m,L), B samples)
    on a card with ``sms`` SMs, from the built kernel library (so
    ``nvcc``); it touches no device.  Raises ``ValueError`` for a shape
    the kernel cannot hold."""
    return plan_from(_build.function("votes_plan"), N, C, m, L, B, sms)


def plan_from(query, N: int, C: int, m: int, L: int, B: int,
              sms: int) -> Plan:
    """:func:`plan` through ``query``, a ctypes binding of ``votes_plan``
    (the kernel library's, or ``csrc/votes_plan.h`` built alone by a host
    compiler)."""
    out = (ctypes.c_int * 7)()
    if query(N, C, m, L, B, sms, out) != 0:
        raise ValueError(f"votes_plan: no plan for N={N} C={C} m={m} L={L} "
                         f"B={B} on {sms} SMs")
    return Plan(*out)


def vote_operands(include: torch.Tensor, lits: torch.Tensor,
                  wpol: torch.Tensor):
    """The three planes as the kernel reads them: include as contiguous
    0/1 bytes (a bool or uint8 plane as it is), lits as contiguous int32,
    wpol as int32 at its own strides (an expanded plane stays expanded).
    Only other dtypes, or a non-contiguous include or lits, are copied."""
    if include.dtype not in (torch.bool, torch.uint8):
        include = include != 0
    if not include.is_contiguous():
        include = include.contiguous()
    if lits.dtype != torch.int32 or not lits.is_contiguous():
        lits = lits.to(torch.int32).contiguous()
    if wpol.dtype != torch.int32:
        wpol = wpol.to(torch.int32)
    return include, lits, wpol


def _votes(fn: str, include, lits, wpol, predict, lead) -> torch.Tensor:
    """Launch ``fn`` (``fused_votes`` or ``fused_votes_batched``) on
    include (*lead,C,m,L), lits (*lead,B,L), wpol (*lead,C,m): the only
    device work is the kernel (the output is ``torch.empty``); the
    launcher plans the grid from the shape."""
    C, m, L = include.shape[-3:]
    B = lits.shape[-2]
    out = include.new_empty(lead + (B, C), dtype=torch.int32)
    if out.numel() == 0:
        return out
    inc, lit, wp = vote_operands(include, lits, wpol)
    # the raw handle of torch's current stream (what
    # torch.cuda.current_stream().cuda_stream returns, without the object)
    stream = torch._C._cuda_getCurrentRawStream(inc.get_device())
    err = _build.function(fn)(
        inc.data_ptr(), lit.data_ptr(), wp.data_ptr(), out.data_ptr(), *lead,
        C, m, L, B, *wp.stride(), int(bool(predict)), stream)
    _build.check(fn, err)
    return out


def fused_votes(include: torch.Tensor, lits: torch.Tensor,
                wpol: torch.Tensor, predict: bool = True) -> torch.Tensor:
    """include (C,m,L) 0/1; lits (B,L) 0/1; wpol (C,m) int → unclipped
    Eq.-1 votes (B,C) int32 of one model, one launch."""
    if include.ndim != 3 or lits.ndim != 2 or wpol.ndim != 2:
        raise ValueError("fused_votes: include (C,m,L), lits (B,L), "
                         "wpol (C,m)")
    C, m, L = include.shape
    B = lits.shape[0]
    if lits.shape != (B, L) or wpol.shape != (C, m):
        raise ValueError(f"fused_votes: shapes disagree: include "
                         f"{tuple(include.shape)}, lits {tuple(lits.shape)},"
                         f" wpol {tuple(wpol.shape)}")
    _cuda("fused_votes", include, lits, wpol)
    return _votes("fused_votes", include, lits, wpol, predict, ())


def fused_votes_batched(include: torch.Tensor, lits: torch.Tensor,
                        wpol: torch.Tensor, predict: bool = True
                        ) -> torch.Tensor:
    """include (N,C,m,L) 0/1; lits (N,B,L) 0/1; wpol (N,C,m) int →
    unclipped Eq.-1 votes (N,B,C) int32, one launch."""
    if include.ndim != 4 or lits.ndim != 3 or wpol.ndim != 3:
        raise ValueError("fused_votes_batched: include (N,C,m,L), "
                         "lits (N,B,L), wpol (N,C,m)")
    N, C, m, L = include.shape
    B = lits.shape[1]
    if lits.shape != (N, B, L) or wpol.shape != (N, C, m):
        raise ValueError(f"fused_votes_batched: shapes disagree: include "
                         f"{tuple(include.shape)}, lits {tuple(lits.shape)},"
                         f" wpol {tuple(wpol.shape)}")
    _cuda("fused_votes_batched", include, lits, wpol)
    return _votes("fused_votes_batched", include, lits, wpol, predict, (N,))
