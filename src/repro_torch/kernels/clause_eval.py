"""CUDA wrappers of the clause-evaluation kernels (``csrc/clause_eval.cu``).

Counterparts of ``repro/kernels/clause_eval.py``'s three kernels, with
their results: :func:`clause_outputs` (``clause_outputs_pallas``),
:func:`fused_votes` (``fused_votes_pallas``) and
:func:`fused_votes_batched` (``fused_votes_batched_pallas``).  Each is its
own launch with its own count.  The kernels take the include plane and
``1 - lits`` as 0/1 bytes, padded with zero bytes to a multiple of 4
literals so they can count violations four literals per ``popc``.  The
plain versions are the functions of the same names in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

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


def fused_votes(include: torch.Tensor, lits: torch.Tensor,
                wpol: torch.Tensor, predict: bool = True) -> torch.Tensor:
    """include (C,m,L) 0/1; lits (B,L) 0/1; wpol (C,m) int → unclipped
    Eq.-1 votes (B,C) int32 of one model, one launch."""
    _cuda("fused_votes", include, lits, wpol)
    if include.ndim != 3 or lits.ndim != 2 or wpol.ndim != 2:
        raise ValueError("fused_votes: include (C,m,L), lits (B,L), "
                         "wpol (C,m)")
    C, m, L = include.shape
    B = lits.shape[0]
    if lits.shape != (B, L) or wpol.shape != (C, m):
        raise ValueError(f"fused_votes: shapes disagree: include "
                         f"{tuple(include.shape)}, lits {tuple(lits.shape)},"
                         f" wpol {tuple(wpol.shape)}")
    lp = -(-L // 4) * 4
    inc = _bytes(include, lp)
    nlit = _bytes(1 - lits.to(torch.int32), lp)
    wp = wpol.to(torch.int32).contiguous()
    out = torch.empty((B, C), dtype=torch.int32, device=include.device)
    fn = _build.function("fused_votes")
    err = fn(inc.data_ptr(), nlit.data_ptr(), wp.data_ptr(), out.data_ptr(),
             C, m, lp // 4, B, int(bool(predict)), _stream(include))
    _build.check("fused_votes", err)
    return out


def fused_votes_batched(include: torch.Tensor, lits: torch.Tensor,
                        wpol: torch.Tensor, predict: bool = True
                        ) -> torch.Tensor:
    """include (N,C,m,L) 0/1; lits (N,B,L) 0/1; wpol (N,C,m) int →
    unclipped Eq.-1 votes (N,B,C) int32, one launch."""
    _cuda("fused_votes_batched", include, lits, wpol)
    if include.ndim != 4 or lits.ndim != 3 or wpol.ndim != 3:
        raise ValueError("fused_votes_batched: include (N,C,m,L), "
                         "lits (N,B,L), wpol (N,C,m)")
    N, C, m, L = include.shape
    B = lits.shape[1]
    if lits.shape != (N, B, L) or wpol.shape != (N, C, m):
        raise ValueError(f"fused_votes_batched: shapes disagree: include "
                         f"{tuple(include.shape)}, lits {tuple(lits.shape)},"
                         f" wpol {tuple(wpol.shape)}")
    lp = -(-L // 4) * 4
    inc = _bytes(include, lp)
    nlit = _bytes(1 - lits.to(torch.int32), lp)
    wp = wpol.to(torch.int32).contiguous()
    out = torch.empty((N, B, C), dtype=torch.int32, device=include.device)
    fn = _build.function("fused_votes_batched")
    err = fn(inc.data_ptr(), nlit.data_ptr(), wp.data_ptr(), out.data_ptr(),
             N, C, m, lp // 4, B, int(bool(predict)), _stream(include))
    _build.check("fused_votes_batched", err)
    return out
