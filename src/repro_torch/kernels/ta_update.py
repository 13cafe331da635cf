"""The TA transition of one sample step (``csrc/ta_update.cu``) and its
plain version.

Counterpart of ``repro/kernels/ta_update.py::ta_update_pallas`` together
with the draws its caller, ``repro/core/tm.py::_feedback_one_class``,
makes for it: both feedback roles of every client of a step, on the
target and the negative class bank, from the step's role keys
(:func:`repro_torch.kernels.draws.epoch_keys`).  The kernel draws the
activations and the Type I coins from those keys itself (``csrc/threefry.h``)
and updates the banks in place, in one launch.  Its plain version,
:func:`ta_update_plain`, draws the reference's uniform planes with
:mod:`repro_torch.random` and applies :func:`ref.ta_update_ref` to the
target bank, then to the negative one.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.kernels import _build, draws, ref

_NO_PLAN = -1            # the launcher's code for a shape it cannot take
_MAX_GRID = 2048         # csrc/ta_update.cu's kMaxGrid: list lengths a launch
_DTYPES = {"ta": torch.int32, "lits": torch.int32, "fired": torch.int32,
           "votes": torch.int32, "cls2": torch.int32,
           "role_keys": torch.int64}


class Plan(NamedTuple):
    grid: int        # blocks of the cooperative launch
    smem: int        # dynamic shared memory a block, bytes
    vec4: bool       # states read and written 128 bits at a time


def _scratch_words(N: int, m: int, L: int) -> int:
    """Listed rows (8 words each), literal bits and one list length a
    block."""
    return 8 * 2 * N * m + N * ((L + 31) // 32) + _MAX_GRID


def plan(N: int, C: int, m: int, L: int) -> Plan:
    """The launcher's plan of one step over N clients of (C, m, L) banks
    (contiguous, as the wrapper takes them) on the current CUDA device; it
    launches nothing.  Raises ``ValueError`` for a shape the kernel cannot
    take."""
    out = (ctypes.c_int * 3)()
    err = _build.function("ta_update_plan")(N, C, m, L,
                                            _scratch_words(N, m, L),
                                            int(L % 4 == 0), out)
    if err == _NO_PLAN:
        raise ValueError(_no_plan(N, C, m, L))
    if err != 0:
        raise RuntimeError(f"ta_update_plan: CUDA error {err}")
    return Plan(out[0], out[1], bool(out[2]))


def _no_plan(N, C, m, L) -> str:
    return (f"ta_update_: no launch for (N, C, m, L) = ({N}, {C}, {m}, "
            f"{L}): m·L or N·C·m reaches 2**31, C is below 2, or the "
            f"literal bits of all N clients exceed a block's shared memory")


def _check_classes(cls2: torch.Tensor, C: int) -> None:
    """Both roles update in place from the same clause outputs: their
    classes must be two different banks."""
    c = cls2.to("cpu")
    if c.numel() and (int(c.min()) < 0 or int(c.max()) >= C):
        raise ValueError(f"ta_update_: class ids outside [0, {C})")
    same = (c[:, 0] == c[:, 1]).nonzero()
    if same.numel():
        raise ValueError(f"ta_update_: cls2 {tuple(cls2.shape)} names the "
                         f"same class for both roles of client "
                         f"{int(same[0, 0])}")


def ta_update_(ta: torch.Tensor, lits: torch.Tensor, fired: torch.Tensor,
               votes: torch.Tensor, cls2: torch.Tensor,
               role_keys: torch.Tensor, *, T: int, p_inc: float,
               p_dec: float, n_states: int) -> torch.Tensor:
    """One sample step of N clients in place, one launch: ta (N,C,m,L)
    int32 contiguous, lits (N,L) int32 0/1, fired (N,C,m) int32 (the
    step's clause outputs in learning mode), votes (N,C) int32, cls2 (N,2)
    int32 [target, negative], role_keys (N,2,3,2) int64 uint32 words (the
    step's slice of :func:`draws.epoch_keys`).  lits, cls2 and role_keys
    may be a strided slice of an epoch's tensors (their rows contiguous).
    Votes are clipped to ±T here; TA states must lie in [1, 2·n_states],
    as every state the TM produces does.  Returns ``ta``."""
    args = {"ta": ta, "lits": lits, "fired": fired, "votes": votes,
            "cls2": cls2, "role_keys": role_keys}
    for name, a in args.items():
        if not a.is_cuda:
            raise ValueError(f"ta_update_: {name} is not a CUDA tensor; CPU "
                             f"tensors go to ta_update_plain")
        if a.dtype != _DTYPES[name]:
            raise ValueError(f"ta_update_: {name} must be {_DTYPES[name]}, "
                             f"got {a.dtype}")
    if ta.ndim != 4 or not ta.is_contiguous():
        raise ValueError("ta_update_: ta is a contiguous (N,C,m,L) tensor")
    N, C, m, L = ta.shape
    want = {"lits": (N, L), "fired": (N, C, m), "votes": (N, C),
            "cls2": (N, 2), "role_keys": (N, 2, 3, 2)}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"ta_update_: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if not (fired.is_contiguous() and votes.is_contiguous()
            and lits.stride(-1) == 1 and cls2.stride(-1) == 1
            and role_keys[:1].is_contiguous()):
        raise ValueError("ta_update_: fired and votes must be contiguous, "
                         "and the rows of lits, cls2 and role_keys")
    if m * L >= 1 << 31 or N * C * m >= 1 << 31:
        raise ValueError(_no_plan(N, C, m, L))
    if N == 0:
        return ta
    _check_classes(cls2, C)
    words = _scratch_words(N, m, L)
    scratch = torch.empty(words, dtype=torch.int32, device=ta.device)
    err = _build.function("ta_update")(
        ta.data_ptr(), lits.data_ptr(), fired.data_ptr(), votes.data_ptr(),
        cls2.data_ptr(), role_keys.data_ptr(), scratch.data_ptr(), N, C, m,
        L, lits.stride(0), cls2.stride(0), role_keys.stride(0), words,
        int(n_states), int(T), draws.int_threshold(p_inc),
        draws.int_threshold(p_dec),
        torch.cuda.current_stream(ta.device).cuda_stream)
    if err == _NO_PLAN:
        raise ValueError(_no_plan(N, C, m, L))
    _build.check("ta_update", err)
    return ta


def ta_update_plain(ta: torch.Tensor, lits: torch.Tensor,
                    fired: torch.Tensor, votes: torch.Tensor,
                    cls2: torch.Tensor, role_keys: torch.Tensor, *, T: int,
                    p_inc: float, p_dec: float, n_states: int,
                    stats: dict | None = None) -> torch.Tensor:
    """The plain version of :func:`ta_update_`, on either device, in place
    on ``ta``: per role, the activation uniforms of ``k_act`` and the
    uniform planes of ``k_s1`` / ``k_s2`` (:mod:`repro_torch.random`), then
    :func:`ref.ta_update_ref` on the target bank, then on the negative one.
    Each clause is active with probability (T ∓ v) · f32(1/2T)
    (``ref.reciprocal_f32``).  Given a ``stats`` dict, it sets
    ``stats["type1_rows"]`` and ``stats["type2_rows"]`` to the rows that
    took Type I feedback and the fired rows that took Type II: the rows the
    kernel reads and writes."""
    N, C, m, L = ta.shape
    _check_classes(cls2, C)
    rows = torch.arange(N, device=ta.device)
    pos = torch.arange(m, device=ta.device) % 2 == 0
    counts = {"type1_rows": 0, "type2_rows": 0}
    for role in (0, 1):
        is_target = role == 0
        cls = cls2[:, role].long()
        k_act, k_s1, k_s2 = role_keys[:, role].unbind(-2)
        v = votes[rows, cls].clamp(-T, T)
        num = (T - v if is_target else T + v).to(torch.float32)
        p_act = num * torch.full_like(num, ref.reciprocal_f32(2 * T))
        active = rnd.uniform(k_act, (m,)) < p_act[:, None]     # (N, m)
        type1 = (pos if is_target else ~pos) & active
        type2 = (~pos if is_target else pos) & active
        f = fired[rows, cls]                                    # (N, m)
        ta[rows, cls] = ref.ta_update_ref(
            ta[rows, cls], lits[:, None], f[..., None], type1[..., None],
            type2[..., None], rnd.uniform(k_s1, (m, L)),
            rnd.uniform(k_s2, (m, L)), p_inc=p_inc, p_dec=p_dec,
            n_states=n_states)
        if stats is not None:
            counts["type1_rows"] += int(type1.sum())
            counts["type2_rows"] += int((type2 & (f != 0)).sum())
    if stats is not None:
        stats.update(counts)
    return ta
