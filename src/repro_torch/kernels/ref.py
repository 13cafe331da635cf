"""Plain PyTorch versions of the port's kernels.

Each function is the semantic reference of the CUDA kernel of the same
name (``csrc/*.cu``) and of the JAX package's kernel it ports:

* :func:`clause_outputs_ref` — ``clause_eval.py::clause_outputs_pallas``;
* :func:`fused_votes_ref` — ``clause_eval.py::fused_votes_pallas``;
* :func:`fused_votes_batched_ref` — ``clause_eval.py::fused_votes_batched_pallas``;
* :func:`ta_update_ref` — ``ta_update.py::ta_update_pallas``;
* :func:`train_epoch_ref` — ``train_epoch.py::train_epoch_pallas``.

``kernels/ops.py`` runs them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them on the GPU.  They run on
either device.  Violation counts go through a float32 matrix product of
0/1 operands: every count is an integer below 2**24, so it is exact in
any summation order and at any matmul precision torch may pick.
"""
from __future__ import annotations

import numpy as np
import torch


def reciprocal_f32(d: int) -> float:
    """The correctly rounded float32 of 1/d.

    The JAX package's ``x / c`` by a compile-time constant ``c`` (the
    activation probability's ``/ 2T``, ``jnp.mean``'s ``/ B``) runs, as
    XLA compiles it, as ``x * f32(1/c)``: the port multiplies by this
    value to see the very same float32 result."""
    return float(np.float32(1.0) / np.float32(d))


def clause_outputs_ref(include: torch.Tensor, lits: torch.Tensor,
                       predict: bool = False) -> torch.Tensor:
    """include (..., CM, L) 0/1; lits (..., B, L) 0/1 → fired (..., B, CM)
    int32.  A clause fires iff no included literal is 0 in the sample;
    empty clauses fire during learning, not during prediction."""
    if include.shape[-1] >= 1 << 24:
        raise ValueError("clause_outputs_ref: L must stay below 2**24")
    nlit = (1 - lits.to(torch.int32)).to(torch.float32)
    viol = torch.matmul(nlit, include.to(torch.float32).transpose(-1, -2))
    fired = (viol == 0).to(torch.int32)
    if predict:
        nonempty = include.to(torch.int32).sum(-1) > 0
        fired = fired * nonempty.unsqueeze(-2).to(torch.int32)
    return fired


def fused_votes_ref(include: torch.Tensor, lits: torch.Tensor,
                    wpol: torch.Tensor, predict: bool = True) -> torch.Tensor:
    """include (..., C, m, L); lits (..., B, L); wpol (..., C, m) → votes
    (..., B, C) int32: the unclipped Eq.-1 votes of one model (or of a
    leading batch of models); predict mode drops empty clauses."""
    C, m, L = include.shape[-3:]
    fired = clause_outputs_ref(include.reshape(include.shape[:-3]
                                               + (C * m, L)), lits, predict)
    contrib = fired.unflatten(-1, (C, m)) * wpol.to(torch.int32)[..., None,
                                                                 :, :]
    return contrib.sum(-1, dtype=torch.int32)


def ta_update_ref(ta: torch.Tensor, lit: torch.Tensor, fired: torch.Tensor,
                  type1: torch.Tensor, type2: torch.Tensor,
                  u_inc: torch.Tensor, u_dec: torch.Tensor, *, p_inc: float,
                  p_dec: float, n_states: int) -> torch.Tensor:
    """Type I / Type II TA transition of one clause bank (or of a leading
    batch of banks).

    ta (..., m, L) int32 in [1, 2N]; lit (..., 1, L) 0/1;
    fired / type1 / type2 (..., m, 1) 0/1; u_inc / u_dec (..., m, L)
    float32 uniforms.  Type I: +1 on fired ∧ lit with probability p_inc,
    −1 on ¬(fired ∧ lit) with probability p_dec; Type II: +1 on
    fired ∧ ¬lit ∧ excluded; then the clamp to [1, 2N].  The uniforms are
    compared with float32(p), as the reference does."""
    litb, firedb = lit != 0, fired != 0
    t1, t2 = type1 != 0, type2 != 0
    up1 = t1 & firedb & litb & (u_inc < float(np.float32(p_inc)))
    down1 = t1 & ((firedb & ~litb) | ~firedb) & (
        u_dec < float(np.float32(p_dec)))
    up2 = t2 & firedb & ~litb & (ta <= n_states)
    delta = up1.to(torch.int32) - down1.to(torch.int32) + up2.to(torch.int32)
    return (ta + delta).clamp(1, 2 * n_states).to(torch.int32)


def fused_votes_batched_ref(include: torch.Tensor, lits: torch.Tensor,
                            wpol: torch.Tensor, predict: bool = True
                            ) -> torch.Tensor:
    """include (N,C,m,L); lits (N,B,L); wpol (N,C,m) → votes (N,B,C) i32:
    :func:`fused_votes_ref` with the client axis N in front."""
    if include.ndim != 4:
        raise ValueError("fused_votes_batched_ref: include is (N,C,m,L)")
    return fused_votes_ref(include, lits, wpol, predict)


def train_epoch_ref(ta: torch.Tensor, w: torch.Tensor, lits: torch.Tensor,
                    cls2: torch.Tensor, u_act: torch.Tensor,
                    coin: torch.Tensor, *, n_states: int, T: int,
                    stats: dict | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One TM epoch over N stacked clients, sample by sample.

    ta (N,C,m,L) i32, w (N,C,m) i32, lits (N,S,L) 0/1, cls2 (N,S,2) i32
    [target, negative], u_act (N,S,2,m) f32, coin (N,S,2,m,L) i8 (bit 1:
    increment hit, bit 2: decrement hit) → new (ta, w).  Step (s, role)
    evaluates the clauses of class ``cls2[:, s, role]``, forms the
    ±T-clipped vote and the activation ``u_act < (T ∓ v) · f32(1/2T)``
    (see :func:`reciprocal_f32`), then
    applies Type I / Type II feedback and the weight update.

    Given a ``stats`` dict, it sets ``stats["type1_rows"]`` to the number
    of (client, step, clause) rows that took Type I feedback: the only
    coin rows the epoch reads."""
    ta, w = ta.clone(), w.clone()
    n_type1 = torch.zeros((), dtype=torch.int64, device=ta.device)
    N, C, m, L = ta.shape
    rows = torch.arange(N, device=ta.device)
    pos = torch.arange(m, device=ta.device) % 2 == 0
    pol = torch.where(pos, 1, -1).to(torch.int32)
    for i in range(2 * lits.shape[1]):
        s, role = divmod(i, 2)
        is_target = role == 0
        cls = cls2[:, s, role].long()
        lit = lits[:, s]                                    # (N, L)
        bank, wc = ta[rows, cls], w[rows, cls]              # (N,m,L), (N,m)
        fired = clause_outputs_ref(bank > n_states, lit[:, None])[:, 0] > 0
        votes = (fired.to(torch.int32) * pol * wc).sum(-1, dtype=torch.int32)
        v = votes.clamp(-T, T)
        num = (T - v if is_target else T + v).to(torch.float32)
        p_act = num * torch.full_like(num, reciprocal_f32(2 * T))
        active = u_act[:, s, role] < p_act[:, None]         # (N, m)
        t1 = (pos if is_target else ~pos) & active
        t2 = (~pos if is_target else pos) & active
        n_type1 += t1.sum()

        litb = (lit != 0)[:, None, :]
        fb = fired[:, :, None]
        cn = coin[:, s, role]
        up1 = t1[:, :, None] & fb & litb & ((cn & 1) == 1)
        down1 = t1[:, :, None] & ((fb & ~litb) | ~fb) & ((cn & 2) == 2)
        up2 = t2[:, :, None] & fb & ~litb & (bank <= n_states)
        delta = (up1.to(torch.int32) - down1.to(torch.int32)
                 + up2.to(torch.int32))
        ta[rows, cls] = (bank + delta).clamp(1, 2 * n_states)
        winc = (t1 & fired).to(torch.int32)
        wdec = (t2 & fired).to(torch.int32)
        w[rows, cls] = (wc + winc - wdec).clamp(min=0)
    if stats is not None:
        stats["type1_rows"] = int(n_type1)
    return ta, w
