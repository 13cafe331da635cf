"""CUDA wrapper of the TA-transition kernel (``csrc/ta_update.cu``).

Counterpart of ``repro/kernels/ta_update.py::ta_update_pallas``, with the
same arguments and result, and an optional leading batch axis of banks
(the training scan updates one class's bank of every client in one
launch).  Its plain version is :func:`repro_torch.kernels.ref.ta_update_ref`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build


def ta_update(ta: torch.Tensor, lit: torch.Tensor, fired: torch.Tensor,
              type1: torch.Tensor, type2: torch.Tensor, u_inc: torch.Tensor,
              u_dec: torch.Tensor, *, p_inc: float, p_dec: float,
              n_states: int) -> torch.Tensor:
    """ta (...,m,L) int32; lit (...,1,L) 0/1; fired/type1/type2 (...,m,1)
    0/1; u_inc/u_dec (...,m,L) float32 → new ta (...,m,L) int32, one
    launch.  The leading axes (none or one) are the same on every input."""
    args = {"ta": ta, "lit": lit, "fired": fired, "type1": type1,
            "type2": type2, "u_inc": u_inc, "u_dec": u_dec}
    for name, a in args.items():
        if not a.is_cuda:
            raise ValueError(f"ta_update: {name} is not a CUDA tensor; CPU "
                             f"tensors go to kernels.ref")
    if ta.ndim not in (2, 3) or ta.dtype != torch.int32:
        raise ValueError("ta_update: ta is int32 (m,L) or (NB,m,L)")
    lead, (m, L) = ta.shape[:-2], ta.shape[-2:]
    want = {"lit": lead + (1, L), "fired": lead + (m, 1),
            "type1": lead + (m, 1), "type2": lead + (m, 1),
            "u_inc": lead + (m, L), "u_dec": lead + (m, L)}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"ta_update: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    for name in ("u_inc", "u_dec"):
        if args[name].dtype != torch.float32:
            raise ValueError(f"ta_update: {name} must be float32")

    def i32(a):
        return a.to(torch.int32).contiguous()

    ta_c, u_inc, u_dec = ta.contiguous(), u_inc.contiguous(), \
        u_dec.contiguous()
    flags = [i32(a) for a in (lit, fired, type1, type2)]
    out = torch.empty_like(ta_c)
    fn = _build.function("ta_update")
    err = fn(ta_c.data_ptr(), *(f.data_ptr() for f in flags),
             u_inc.data_ptr(), u_dec.data_ptr(), out.data_ptr(),
             lead[0] if lead else 1, m, L, float(np.float32(p_inc)),
             float(np.float32(p_dec)), int(n_states),
             torch.cuda.current_stream(ta.device).cuda_stream)
    _build.check("ta_update", err)
    return out
