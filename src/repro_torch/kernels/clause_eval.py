"""CUDA wrapper of the fused-votes kernel (``csrc/clause_eval.cu``).

Counterpart of ``repro/kernels/clause_eval.py::fused_votes_batched_pallas``,
with the same signature and result.  The kernel takes the include plane
and ``1 - lits`` as 0/1 bytes, padded with zero bytes to a multiple of 4
literals so it can count violations four literals per ``popc``.  Its
plain version is :func:`repro_torch.kernels.ref.fused_votes_batched_ref`.
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


def fused_votes_batched(include: torch.Tensor, lits: torch.Tensor,
                        wpol: torch.Tensor, predict: bool = True
                        ) -> torch.Tensor:
    """include (N,C,m,L) 0/1; lits (N,B,L) 0/1; wpol (N,C,m) int →
    unclipped Eq.-1 votes (N,B,C) int32, one launch."""
    if not (include.is_cuda and lits.is_cuda and wpol.is_cuda):
        raise ValueError("fused_votes_batched: the kernel takes CUDA "
                         "tensors; CPU tensors go to kernels.ref")
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
             N, C, m, lp // 4, B, int(bool(predict)),
             torch.cuda.current_stream(include.device).cuda_stream)
    _build.check("fused_votes_batched", err)
    return out
