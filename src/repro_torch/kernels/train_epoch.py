"""CUDA wrapper of the fused training-epoch kernel (``csrc/train_epoch.cu``).

Counterpart of ``repro/kernels/train_epoch.py::train_epoch_pallas``, with
the same signature and result.  The kernel updates the banks in place, so
the wrapper hands it copies: callers may still hold the inputs, as they
may with immutable JAX arrays.  Its plain version is
:func:`repro_torch.kernels.ref.train_epoch_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {"ta": torch.int32, "w": torch.int32, "lits": torch.int32,
           "cls2": torch.int32, "u_act": torch.float32, "coin": torch.int8}


def train_epoch_fused(ta: torch.Tensor, w: torch.Tensor, lits: torch.Tensor,
                      cls2: torch.Tensor, u_act: torch.Tensor,
                      coin: torch.Tensor, *, n_states: int, T: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """ta (N,C,m,L) i32, w (N,C,m) i32, lits (N,S,L) i32 0/1,
    cls2 (N,S,2) i32, u_act (N,S,2,m) f32, coin (N,S,2,m,L) i8 →
    (ta, w) after one epoch, one launch.  TA states must lie in
    [1, 2·n_states], as every state the TM produces does."""
    args = {"ta": ta, "w": w, "lits": lits, "cls2": cls2, "u_act": u_act,
            "coin": coin}
    for name, a in args.items():
        if not a.is_cuda:
            raise ValueError(f"train_epoch_fused: {name} is not a CUDA "
                             f"tensor; CPU tensors go to kernels.ref")
        if a.dtype != _DTYPES[name]:
            raise ValueError(f"train_epoch_fused: {name} must be "
                             f"{_DTYPES[name]}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"train_epoch_fused: {name} must be "
                             f"contiguous")
    N, C, m, L = ta.shape
    S = lits.shape[1]
    want = {"w": (N, C, m), "lits": (N, S, L), "cls2": (N, S, 2),
            "u_act": (N, S, 2, m), "coin": (N, S, 2, m, L)}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"train_epoch_fused: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if cls2.numel() and (int(cls2.min()) < 0 or int(cls2.max()) >= C):
        raise ValueError("train_epoch_fused: class ids outside [0, C)")
    ta_out, w_out = ta.clone(), w.clone()
    fn = _build.function("train_epoch_fused")
    err = fn(ta_out.data_ptr(), w_out.data_ptr(), lits.data_ptr(),
             cls2.data_ptr(), u_act.data_ptr(), coin.data_ptr(),
             N, C, m, L, S, int(n_states), int(T),
             torch.cuda.current_stream(ta.device).cuda_stream)
    _build.check("train_epoch_fused", err)
    return ta_out, w_out
