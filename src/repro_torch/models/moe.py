"""Mixture-of-Experts layer: top-k router + capacity-based dispatch.

Counterpart of ``repro/models/moe.py``.  Dispatch (default
``impl="capacity"``): each batch row sorts its T·top_k slots by expert id
(a stable sort) and scatters them into a fixed ``(E, capacity)`` buffer,
overflow dropped (GShard/Switch semantics); the expert FFNs run as
batched dense einsums over the buffer.  ``impl="capacity_global"`` sorts
all rows' slots together; ``impl="ragged"`` runs each expert's contiguous
group of sorted slots through its own products, no drops (the reference's
``jax.lax.ragged_dot``, as one ``torch.matmul`` an expert).

The reference's ``.at[...].set(mode="drop")`` and ``.at[...].get(mode=
"fill")`` become a sink row past the buffer's end that is written and
dropped, or read as zeros.  Each token is repeated ``top_k`` times
(an ``expand``, whose backward is a sum) and its copies are permuted
into sorted order; its ``top_k`` expert outputs are gathered back
through the inverse of the sort and summed over the k slots.  Every
gather is over a permutation, or repeats only the dropped sink row, so
no backward adds two values into one element with atomics: a training
step repeats bit for bit on the card.

``jax.lax.top_k`` breaks ties toward the lower expert id; ``torch.topk``
promises no order, so the router takes the head of a stable descending
sort.

On a mesh (:mod:`repro_torch.sharding.mesh_ops`) each rank holds its
batch block, replicated over ``model``.  The router's load-balance
statistics are means over the whole batch (summed over the batch axes),
and ``impl="capacity_global"`` places each slot where the whole batch's
stable sort puts it (each expert's count on the batch blocks before
this rank's is added to its rank in the group), against the whole
batch's capacity: the reference's semantics, which XLA keeps when it
partitions.  :func:`_constrain_ep` is the reference's expert-parallel
branch (``REPRO_SHARD_MOE=1``).
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import mesh_ops


def _constrain_ep(cfg: ModelConfig) -> tuple[int, int] | None:
    """The reference's ``REPRO_SHARD_MOE=1`` knob pins the dispatch buffer
    to expert-parallel sharding, the expert axis over ``model``, where
    ``cfg.moe.sharding == "ep"``, the mesh has ``model`` and ``model``
    divides the experts.  Here it returns (ranks along ``model``, this
    rank's index) where that holds (``model`` of size > 1; the capacity
    dispatchers read it, ``"ragged"`` does not), else ``None``, and the
    model code then keeps the expert banks as this rank's ``E/M``
    experts.

    Each rank builds the whole buffer from its batch block (its tokens
    are replicated over ``model``) and runs only its experts.  The
    outputs rejoin by gathering ``out_buf`` over ``model``
    (:func:`repro_torch.sharding.mesh_ops.gather_out`): the combine then
    runs on every rank on the whole buffer, as in one process, so it
    adds each token's ``k`` slots in the one-process order, and its
    backward is a cut.  A per-expert partial combine and an
    ``all_reduce`` would move ``T·d`` floats instead of ``E·cap·d``, but
    add the slots in another order."""
    if os.environ.get("REPRO_SHARD_MOE") != "1" or cfg.moe is None \
            or cfg.moe.sharding != "ep":
        return None
    m, i = mesh_ops.model_split()
    if m == 1 or cfg.moe.n_experts % m:
        return None
    return m, i


def moe_init(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """As the reference: the router's normal times ``d ** -0.5`` in
    float32; each expert bank's normal cast to bfloat16 *before* the
    scale, which multiplies as a bfloat16 value."""
    m = cfg.moe
    d = cfg.d_model
    ks = rnd.split(key, 5)

    def bank(k, shape, scale):
        w = rnd.normal(k, shape).to(layers.PARAM_DTYPE)
        return w * torch.tensor(scale, dtype=layers.PARAM_DTYPE,
                                device=key.device)

    p = {
        "router": rnd.normal(ks[0], (d, m.n_experts)) * d ** -0.5,
        "gate": bank(ks[1], (m.n_experts, d, m.d_expert), d ** -0.5),
        "up": bank(ks[2], (m.n_experts, d, m.d_expert), d ** -0.5),
        "down": bank(ks[3], (m.n_experts, m.d_expert, d),
                     m.d_expert ** -0.5),
    }
    if m.n_shared:
        p["shared"] = layers.mlp_init(ks[4], d, m.n_shared * m.d_expert)
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties to the lower index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(params: dict, xf: torch.Tensor, cfg: ModelConfig):
    """xf: (S, d) → (topk weights (S,k), ids (S,k), aux loss)."""
    m = cfg.moe
    logits = xf.float() @ params["router"]                    # (S, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = top_k(probs, m.top_k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)    # renormalize
    # Switch-style load balance: E · Σ_e f_e · P_e
    counts = torch.bincount(ids.reshape(-1), minlength=m.n_experts)
    axes = mesh_ops.batch_axes()
    if axes:        # means over the whole batch
        n = mesh_ops.current_mesh().block(axes)[0]
        me = mesh_ops.reduce_sum(probs.sum(0), axes, "batch") \
            / (probs.shape[0] * n)
        ce = mesh_ops.reduce_plain(counts, axes, "batch").float() \
            * (1.0 / (ids.numel() * n))
    else:
        me = probs.mean(0)                                     # (E,)
        ce = counts.float() * (1.0 / ids.numel())
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_coef
    return w, ids, aux


def _run_experts(params: dict, buf: torch.Tensor, cfg: ModelConfig,
                 dim: int) -> torch.Tensor:
    """The expert FFNs over a buffer whose axis ``dim`` is the experts';
    under :func:`_constrain_ep` only this rank's experts run, on this
    rank's banks, and their outputs are gathered over ``model``."""
    ep = _constrain_ep(cfg)
    if ep is None:
        return _expert_ffn(params, buf)
    per = cfg.moe.n_experts // ep[0]
    out = _expert_ffn(params, buf.narrow(dim, ep[1] * per, per))
    return mesh_ops.gather_out(out, dim, ("model",), "experts")


def _dispatch_input(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The tokens entering the dispatch: under :func:`_constrain_ep` each
    rank's gradient reaches them through its own experts only, so it is
    summed over ``model`` (the router's, computed whole, is not)."""
    if _constrain_ep(cfg) is None:
        return x
    return mesh_ops.copy_in(x, ("model",), "experts")


def _expert_ffn(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """buf: (..., E, cap, d) → (..., E, cap, d) batched dense SwiGLU."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", buf, params["gate"]))
    h = g * torch.einsum("...ecd,edf->...ecf", buf, params["up"])
    return torch.einsum("...ecf,efd->...ecd", h, params["down"])


def _sorted_slots(ids: torch.Tensor):
    """Slots (..., T·k) sorted by expert id, stably: the sort order, the
    sorted ids and the inverse order."""
    order = torch.sort(ids, dim=-1, stable=True).indices
    sorted_ids = torch.gather(ids, -1, order)
    inv = torch.argsort(order, dim=-1)
    return order, sorted_ids, inv


def _repeat_tokens(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., T, d) → (..., T·k, d): each token k times in a row, slot
    t·k + i, as a view whose backward sums the k copies."""
    *lead, T, d = x.shape
    return x.unsqueeze(-2).expand(*lead, T, k, d).reshape(*lead, T * k, d)


def _rank_in_group(sorted_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each sorted slot's rank among the slots of its expert."""
    counts = F.one_hot(sorted_ids, n_experts).sum(-2)          # (..., E)
    starts = torch.cumsum(counts, dim=-1) - counts             # exclusive
    idx = torch.arange(sorted_ids.shape[-1], device=sorted_ids.device)
    return idx - torch.gather(starts, -1, sorted_ids)


def _combine(ys: torch.Tensor, w_sorted: torch.Tensor, inv: torch.Tensor,
             k: int) -> torch.Tensor:
    """Weighted expert outputs back to their tokens: ys (..., T·k, d) and
    weights (..., T·k) in sorted order → (..., T, d) float32, the sum of
    each token's k slots."""
    idx = inv[..., None].expand(inv.shape + (ys.shape[-1],))
    yw = torch.gather(ys.float(), -2, idx) \
        * torch.gather(w_sorted, -1, inv)[..., None]
    return yw.reshape(yw.shape[:-2] + (-1, k, yw.shape[-1])).sum(-2)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25,
              impl: str = "capacity") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) → (y (B, T, d), aux loss scalar)."""
    m = cfg.moe
    B, T, d = x.shape
    S = B * T
    xf = x.reshape(S, d)
    w, ids, aux = _route(params, xf, cfg)

    if impl == "capacity":
        y = _dispatch_per_row(params, x, w.reshape(B, T, m.top_k),
                              ids.reshape(B, T, m.top_k), cfg,
                              capacity_factor)
        if m.n_shared:
            y = y + layers.mlp_apply(params["shared"], xf).reshape(B, T, d)
        return y.to(x.dtype), aux

    k = m.top_k
    order, sorted_ids, inv = _sorted_slots(ids.reshape(-1))
    w_sorted = w.reshape(-1)[order]

    if impl == "ragged":
        xs = _repeat_tokens(xf, k)[order]                      # (S·k, d)
        counts = torch.bincount(sorted_ids, minlength=m.n_experts).tolist()
        parts, lo = [], 0
        for e, n in enumerate(counts):
            xe = xs[lo:lo + n]
            g = F.silu(xe @ params["gate"][e])
            parts.append((g * (xe @ params["up"][e])) @ params["down"][e])
            lo += n
        ys = torch.cat(parts, dim=0)                           # (S·k, d)
        y = _combine(ys, w_sorted, inv, k)
    else:
        axes = mesh_ops.batch_axes()
        n_blocks = mesh_ops.current_mesh().block(axes)[0] if axes else 1
        cap = max(int(S * n_blocks * k * capacity_factor / m.n_experts), 1)
        cap = -(-cap // 8) * 8                                  # align
        pos_in_e = _rank_in_group(sorted_ids, m.n_experts)
        if axes:        # the slots of the batch blocks before this one
            pos_in_e = pos_in_e + _earlier_counts(sorted_ids, m.n_experts,
                                                  axes)[sorted_ids]
        keep = pos_in_e < cap
        sink = m.n_experts * cap
        dest = torch.where(keep, sorted_ids * cap + pos_in_e, sink)
        xs = _dispatch_input(_repeat_tokens(xf, k), cfg)[order]  # (S·k, d)
        buf = x.new_zeros((sink + 1, d)).index_put((dest,), xs)
        out_buf = _run_experts(
            params, buf[:sink].reshape(m.n_experts, cap, d), cfg, 0)
        ys = torch.cat([out_buf.reshape(sink, d),
                        out_buf.new_zeros((1, d))])[dest]       # (S·k, d)
        y = _combine(ys, w_sorted * keep, inv, k)

    if m.n_shared:
        y = y + layers.mlp_apply(params["shared"], xf)
    return y.reshape(B, T, d).to(x.dtype), aux


def _earlier_counts(sorted_ids: torch.Tensor, n_experts: int,
                    axes: tuple[str, ...]) -> torch.Tensor:
    """Each expert's slots on the batch blocks before this rank's (the
    ranks of its line over ``axes`` with a lower index), from every
    block's counts gathered over ``axes``."""
    counts = torch.bincount(sorted_ids, minlength=n_experts)
    every = mesh_ops.gather_plain(counts[None], 0, axes, "batch")
    _, me = mesh_ops.current_mesh().block(axes)
    return every[:me].sum(0)


def _dispatch_per_row(params: dict, x: torch.Tensor, w: torch.Tensor,
                      ids: torch.Tensor, cfg: ModelConfig,
                      capacity_factor: float) -> torch.Tensor:
    """Row-local capacity dispatch.  x: (B,T,d); w/ids: (B,T,k)."""
    m = cfg.moe
    B, T, d = x.shape
    k = m.top_k
    cap = max(int(T * k * capacity_factor / m.n_experts), 1)
    cap = -(-cap // 4) * 4

    order, sorted_ids, inv = _sorted_slots(ids.reshape(B, T * k))
    pos_in_e = _rank_in_group(sorted_ids, m.n_experts)
    keep = pos_in_e < cap
    sink = m.n_experts * cap
    dest = torch.where(keep, sorted_ids * cap + pos_in_e, sink)

    xs = torch.gather(_repeat_tokens(_dispatch_input(x, cfg), k), 1,
                      order[..., None].expand(B, T * k, d))    # (B, T·k, d)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, T * k)
    buf = x.new_zeros((B, sink + 1, d)).index_put((bidx, dest), xs)
    out = _run_experts(params, buf[:, :sink].reshape(B, m.n_experts, cap, d),
                       cfg, 1)
    out = torch.cat([out.reshape(B, sink, d), out.new_zeros((B, 1, d))], 1)

    ys = torch.gather(out, 1, dest[..., None].expand(B, T * k, d))
    wk = torch.gather(w.reshape(B, T * k), -1, order) * keep
    return _combine(ys, wk, inv, k)


def moe_apply_dense_ref(params: dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """O(E) dense oracle (every expert on every token) for unit tests."""
    m = cfg.moe
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    w, ids, aux = _route(params, xf, cfg)
    g = F.silu(torch.einsum("sd,edf->sef", xf, params["gate"]))
    h = g * torch.einsum("sd,edf->sef", xf, params["up"])
    ye = torch.einsum("sef,efd->sed", h, params["down"])       # (S, E, d)
    mask = F.one_hot(ids, m.n_experts).float()                 # (S, k, E)
    comb = torch.einsum("sk,ske->se", w, mask)
    y = torch.einsum("se,sed->sd", comb, ye.float())
    if m.n_shared:
        y = y + layers.mlp_apply(params["shared"], xf)
    return y.reshape(B, T, d).to(x.dtype), aux
