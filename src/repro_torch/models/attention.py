"""Attention family: GQA/MQA (qk-norm, sliding window) and DeepSeek MLA.

Counterpart of ``repro/models/attention.py``.  Training/prefill attention
runs through the reference's flash-style *blockwise* softmax
(:func:`_blockwise_attn`): a loop over query blocks and, inside it, over
KV blocks with running (max, denom, acc) statistics in float32, query
heads grouped onto their KV head; the (T, S) score matrix is never
materialized.  Its backward (:class:`_Flash`) recomputes each score block
from ``(q, k, v, out, lse)``, FlashAttention's trade of FLOPs for memory,
as the reference's custom VJP does.  It is a plain PyTorch loop on
purpose, not a library attention: a hand-written Hopper kernel is held
against it.

Under causal masking a KV block that lies wholly past a query block's
last row is skipped: every score in it is masked, so it would add exact
zeros (its ``p`` underflows to 0 against a finite running max).

Decode attends a single query over a KV cache:
  * full cache     — (B, S, Hkv, Dh), append at `pos` (clamped at S − 1);
  * sliding window — ring buffer of size W, position-validity masked;
  * int8 cache     — :class:`QuantKVCache`, one bf16 scale per (slot,
    head), ``torch.round`` half to even as ``jnp.round``;
  * MLA            — compressed latent cache (c_kv ‖ k_rope), the
    *absorbed* formulation (W_UK folded into the query, W_UV into the
    output) so decode FLOPs/bytes scale with kv_lora, not H·Dh.

On a model mesh whose decode caches are held as ``rules.cache_specs``'
blocks, the sequence cut over ``model`` (context parallelism, what the
reference gets from XLA's partitioner), a rank holds its block of slots:
only the block holding a step's slot writes it, and the softmax is split
over the blocks (each block's max, sum and unnormalized output, combined
by :func:`repro_torch.sharding.mesh_ops.context_softmax`).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.sharding import mesh_ops

NEG_INF = -1e30

# REPRO_NO_FLASH_VJP=1: plain autograd through the online-softmax loops
# (every score block kept for the backward pass), as in the reference.
_USE_FLASH_VJP = os.environ.get("REPRO_NO_FLASH_VJP", "") != "1"


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention with a hand-written backward
# ---------------------------------------------------------------------------

def _blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_block: int = 512, kv_block: int = 512) -> torch.Tensor:
    """q: (B,T,H,Dq); k: (B,S,Hkv,Dq); v: (B,S,Hkv,Dv) → (B,T,H,Dv)."""
    args = (bool(causal), int(window), int(q_block), int(kv_block))
    if not _USE_FLASH_VJP:
        out, _ = _flash_fwd_impl(q, k, v, *args)
        return _unpad(out, q).to(v.dtype)
    return _Flash.apply(q, k, v, *args)


def _unpad(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, Tp, Hkv, G, Dv) grouped and padded → (B, T, H, Dv)."""
    B, T, H, _ = q.shape
    return out.reshape(B, -1, H, out.shape[-1])[:, :T]


def _mask_block(q_pos, k_pos, S, causal, window):
    mask = k_pos[None, :] < S
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def _blocks(q, k, v, q_block, kv_block):
    B, T, H, Dq = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    qb, kb = min(q_block, T), min(kv_block, S)
    nq, nk = -(-T // qb), -(-S // kb)
    return B, T, H, Dq, S, Hkv, Dv, H // Hkv, qb, kb, nq, nk


def _pad_time(a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows appended along axis 1 up to length ``n``."""
    return F.pad(a, (0, 0) * (a.ndim - 2) + (0, n - a.shape[1]))


def _skipped(causal, qi, qb, ki, kb) -> bool:
    """A KV block wholly after the query block's last row: all masked."""
    return causal and ki * kb > qi * qb + qb - 1


def _flash_fwd_impl(q, k, v, causal, window, q_block, kv_block):
    """Returns (out, lse): out (B, Tp, Hkv, G, Dv) float32, lse = m +
    log l (B, Tp, Hkv, G)."""
    B, T, H, Dq, S, Hkv, Dv, G, qb, kb, nq, nk = _blocks(q, k, v, q_block,
                                                         kv_block)
    scale = Dq ** -0.5
    dev = q.device
    kp = _pad_time(k, nk * kb)
    vp = _pad_time(v, nk * kb)
    # (B, nq, qb, Hkv, G, Dq) — grouped query heads share a KV head
    qg = _pad_time(q, nq * qb).reshape(B, nq, qb, Hkv, G, Dq).float() * scale
    outs, lses = [], []
    for qi in range(nq):
        qblk = qg[:, qi]                                   # (B,qb,Hkv,G,Dq)
        q_pos = qi * qb + torch.arange(qb, device=dev)
        m = torch.full((B, qb, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, qb, Hkv, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qb, Hkv, G, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            if _skipped(causal, qi, qb, ki, kb):
                break
            kblk = kp[:, ki * kb:(ki + 1) * kb].float()
            vblk = vp[:, ki * kb:(ki + 1) * kb].float()
            k_pos = ki * kb + torch.arange(kb, device=dev)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk)
            mask = _mask_block(q_pos, k_pos, S, causal, window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vblk)
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
        lses.append(m + torch.log(torch.clamp_min(l, 1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _flash_bwd(causal, window, q_block, kv_block, res, do):
    q, k, v, out, lse = res                      # out/lse padded+grouped f32
    B, T, H, Dq, S, Hkv, Dv, G, qb, kb, nq, nk = _blocks(q, k, v, q_block,
                                                         kv_block)
    scale = Dq ** -0.5
    dev = q.device
    qp = _pad_time(q, nq * qb).reshape(B, nq, qb, Hkv, G, Dq).float()
    kp = _pad_time(k, nk * kb).reshape(B, nk, kb, Hkv, Dq).float()
    vp = _pad_time(v, nk * kb).reshape(B, nk, kb, Hkv, Dv).float()
    dop = _pad_time(do.float(), nq * qb).reshape(B, nq, qb, Hkv, G, Dv)
    outg = out.reshape(B, nq, qb, Hkv, G, Dv)
    lseg = lse.reshape(B, nq, qb, Hkv, G)
    # D_i = Σ_d do·o  (B, nq, qb, Hkv, G)
    dstat = (dop * outg).sum(-1)

    dq = torch.zeros((B, nq, qb, Hkv, G, Dq), dtype=torch.float32,
                     device=dev)
    dks, dvs = [], []
    for kj in range(nk):
        kblk, vblk = kp[:, kj], vp[:, kj]
        k_pos = kj * kb + torch.arange(kb, device=dev)
        dkj = torch.zeros((B, kb, Hkv, Dq), dtype=torch.float32, device=dev)
        dvj = torch.zeros((B, kb, Hkv, Dv), dtype=torch.float32, device=dev)
        for qi in range(nq):
            if _skipped(causal, qi, qb, kj, kb):
                continue
            qblk, doblk = qp[:, qi], dop[:, qi]
            q_pos = qi * qb + torch.arange(qb, device=dev)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk) * scale
            mask = _mask_block(q_pos, k_pos, S, causal, window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            p = torch.exp(s - lseg[:, qi][..., None])      # (B,qb,Hkv,G,kb)
            dvj = dvj + torch.einsum("bqhgk,bqhgd->bkhd", p, doblk)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", doblk, vblk)
            ds = p * (dp - dstat[:, qi][..., None]) * scale
            dq[:, qi] += torch.einsum("bqhgk,bkhd->bqhgd", ds, kblk)
            dkj = dkj + torch.einsum("bqhgk,bqhgd->bkhd", ds, qblk)
        dks.append(dkj)
        dvs.append(dvj)
    dq = dq.reshape(B, nq * qb, H, Dq)[:, :T].to(q.dtype)
    dk = torch.cat(dks, dim=1)[:, :S].to(k.dtype)
    dv = torch.cat(dvs, dim=1)[:, :S].to(v.dtype)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Blockwise attention whose backward recomputes the score blocks
    (the reference's ``jax.custom_vjp`` ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_block,
                                   kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_block, kv_block)
        return _unpad(out, q).to(v.dtype)

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None


def _softmax_v(s: torch.Tensor, v: torch.Tensor, eq: str,
               seq: tuple[str, ...]) -> torch.Tensor:
    """``einsum(eq, softmax(s), v)``, the softmax over the last axis of
    the float32 scores ``s``.  Where the sequence is cut over ``seq``
    (context parallelism) each rank holds its slots: it computes its
    block's max, ``Σ exp(s − max)`` and unnormalized ``exp(s − max)·v``,
    and :func:`repro_torch.sharding.mesh_ops.context_softmax` combines
    them over the axes."""
    if not seq:
        return torch.einsum(eq, torch.softmax(s, dim=-1), v)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    return mesh_ops.context_softmax(m, e.sum(dim=-1),
                                    torch.einsum(eq, e, v), seq)


def _decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, seq: tuple[str, ...] = ()
                 ) -> torch.Tensor:
    """Single-step attention.  q: (B,H,Dq); k,v: (B,S,Hkv,D*);
    valid: (B,S) bool → (B,H,Dv); ``seq``: the axes the cache's slots
    are cut over (:func:`_softmax_v`)."""
    B, H, Dq = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dq).float() * Dq ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    out = _softmax_v(s, v.float(), "bhgk,bkhd->bhgd", seq)
    return out.reshape(B, H, -1).to(v.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_cache, Hkv, Dh)
    v: torch.Tensor
    pos: torch.Tensor      # (B,) next absolute position


class QuantKVCache(NamedTuple):
    """int8 KV cache: K/V stored as int8 with one bf16 scale per (slot,
    head), per-vector absmax; dequantized on the fly in the attention
    read."""
    k_q: torch.Tensor      # (B, S, Hkv, Dh) int8
    v_q: torch.Tensor
    k_scale: torch.Tensor  # (B, S, Hkv) bf16
    v_scale: torch.Tensor
    pos: torch.Tensor


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., Dh) → int8 codes + per-vector scale."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), \
        scale.to(torch.bfloat16)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None].float()


def gqa_init(key: torch.Tensor, cfg: ModelConfig) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    ks = rnd.split(key, 4)
    p = {
        "wq": dense_init(ks[0], d, cfg.n_heads * dh),
        "wk": dense_init(ks[1], d, cfg.n_kv_heads * dh),
        "wv": dense_init(ks[2], d, cfg.n_kv_heads * dh),
        "wo": dense_init(ks[3], cfg.n_heads * dh, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, key.device)
        p["k_norm"] = rmsnorm_init(dh, key.device)
    return p


def _qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig):
    B, T, _ = x.shape
    dh = cfg.d_head
    q = (x @ params["wq"]).reshape(B, T, cfg.n_heads, dh)
    k = (x @ params["wk"]).reshape(B, T, cfg.n_kv_heads, dh)
    v = (x @ params["wv"]).reshape(B, T, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, window: int = 0) -> torch.Tensor:
    """Training / prefill forward.  x: (B, T, d)."""
    q, k, v = _qkv(params, x, positions, cfg)
    out = _blockwise_attn(q, k, v, causal=True,
                          window=window or cfg.window)
    B, T, _, _ = q.shape
    return out.reshape(B, T, -1) @ params["wo"]


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int = 0, quantized: bool = False,
                   device=None) -> KVCache | QuantKVCache:
    dev = devices.resolve(device)
    s = min(window, max_len) if window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quantized:
        sshape = shape[:-1]
        return QuantKVCache(
            k_q=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_q=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=dev),
            pos=pos)
    return KVCache(k=torch.zeros(shape, dtype=layers.ACT_DTYPE, device=dev),
                   v=torch.zeros(shape, dtype=layers.ACT_DTYPE, device=dev),
                   pos=pos)


def _put(cache: torch.Tensor, at, value: torch.Tensor,
         mine: torch.Tensor | None = None) -> torch.Tensor:
    """``cache.at[at].set(value)``: a new tensor, the value cast to the
    cache's dtype.  ``mine`` (B,): the rows whose slot this rank's block
    holds; the other rows keep what their slot ``at`` holds (a rank that
    does not own a row's slot changes nothing)."""
    value = value.to(cache.dtype)
    if mine is not None:
        keep = mine.reshape((-1,) + (1,) * (value.ndim - 1))
        value = torch.where(keep, value, cache[at])
    return cache.index_put(at, value)


def decode_slot(pos: torch.Tensor, S: int, window: int) -> torch.Tensor:
    """The cache slot a decode step writes: ``pos % S`` in a ring buffer
    (windowed), else ``pos`` appended, clamped at ``S − 1``."""
    w = min(window, S) if window else 0
    return pos % S if w > 0 else torch.clamp_max(pos, S - 1)


def _slot_block(slot: torch.Tensor, S_loc: int, start: int, cut: bool):
    """A global slot (B,) in this rank's block of ``S_loc`` slots from
    ``start``: (the block's index for each row, clamped into it; the
    rows whose slot the block holds, ``None`` where the sequence is not
    cut)."""
    if not cut:
        return slot, None
    local = slot - start
    return local.clamp(0, S_loc - 1), (local >= 0) & (local < S_loc)


def gqa_decode(params: dict, x: torch.Tensor,
               cache: KVCache | QuantKVCache, cfg: ModelConfig,
               window: int = 0, spec: tuple | None = None
               ) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """One decode step.  x: (B, 1, d) → (B, 1, d), updated cache.

    ``spec``: the cache's specs under ``rules.cache_specs`` (one layer's,
    the stacked axis dropped) on the current mesh.  Where they cut the
    sequence over ``model``, ``cache`` is this rank's block of slots
    (codes and scales cut together): the step's slot is the global
    ``decode_slot``, which only the block holding it writes; ``valid``
    is built from global slot indices, and the softmax is split over the
    blocks (:func:`_softmax_v`)."""
    B = x.shape[0]
    pos = cache.pos                                    # (B,)
    q, k, v = _qkv(params, x, pos[:, None], cfg)
    quant = isinstance(cache, QuantKVCache)
    S_loc = (cache.k_q if quant else cache.k).shape[1]
    # the sequence entry of the first leaf's spec (k or k_q)
    seq, n, i = mesh_ops.cache_cut(spec[0][1] if spec else None)
    S, start = S_loc * n, S_loc * i
    w = min(window, S) if window else 0
    slot, mine = _slot_block(decode_slot(pos, S, window).long(), S_loc,
                             start, bool(seq))

    at = (torch.arange(B, device=x.device), slot)
    if quant:
        kq, ks = _quantize(k[:, 0])
        vq, vs = _quantize(v[:, 0])
        cache = cache._replace(
            k_q=_put(cache.k_q, at, kq, mine),
            v_q=_put(cache.v_q, at, vq, mine),
            k_scale=_put(cache.k_scale, at, ks, mine),
            v_scale=_put(cache.v_scale, at, vs, mine))
        kc = _dequantize(cache.k_q, cache.k_scale).to(k.dtype)
        vc = _dequantize(cache.v_q, cache.v_scale).to(v.dtype)
    else:
        kc = _put(cache.k, at, k[:, 0], mine)
        vc = _put(cache.v, at, v[:, 0], mine)
        cache = KVCache(kc, vc, pos)

    slots = start + torch.arange(S_loc, device=x.device)[None, :]
    if w:
        valid = slots < torch.clamp_max(pos + 1, S)[:, None]
    else:
        valid = slots <= pos[:, None]
    out = _decode_attn(q[:, 0], kc, vc, valid, seq)
    y = out.reshape(B, 1, -1) @ params["wo"]
    return y, cache._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S, kv_lora)
    k_rope: torch.Tensor   # (B, S, d_rope)
    pos: torch.Tensor


def mla_init(key: torch.Tensor, cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    ks = rnd.split(key, 5)
    return {
        "wq_a": dense_init(ks[0], d, m.q_lora),
        "q_norm": rmsnorm_init(m.q_lora, key.device),
        "wq_b": dense_init(ks[1], m.q_lora, H * (m.d_nope + m.d_rope)),
        "wkv_a": dense_init(ks[2], d, m.kv_lora + m.d_rope),
        "kv_norm": rmsnorm_init(m.kv_lora, key.device),
        "wkv_b": dense_init(ks[3], m.kv_lora, H * (m.d_nope + m.d_v)),
        "wo": dense_init(ks[4], H * m.d_v, d),
    }


def _mla_q(params: dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig):
    m = cfg.mla
    B, T, _ = x.shape
    cq = rmsnorm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = (cq @ params["wq_b"]).reshape(B, T, cfg.n_heads, m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig):
    m = cfg.mla
    kv = x @ params["wkv_a"]                       # (B, T, kv_lora + d_rope)
    c_kv = rmsnorm(kv[..., :m.kv_lora], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., m.kv_lora:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]   # shared single rope head
    return c_kv, k_rope


def mla_apply(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, window: int = 0) -> torch.Tensor:
    """Training / prefill forward (non-absorbed: materialize per-head K/V)."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv, k_rope = _mla_kv_latent(params, x, positions, cfg)
    kvb = (c_kv @ params["wkv_b"]).reshape(B, T, H, m.d_nope + m.d_v)
    k_nope, v = kvb[..., :m.d_nope], kvb[..., m.d_nope:]
    # concat rope/nope parts → one standard attention with Dq=d_nope+d_rope
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(B, T, H, m.d_rope)], dim=-1)
    out = _blockwise_attn(q, k, v, causal=True, window=window or cfg.window)
    return out.reshape(B, T, H * m.d_v) @ params["wo"]


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int = 0, device=None) -> MLACache:
    m = cfg.mla
    dev = devices.resolve(device)
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora), dtype=layers.ACT_DTYPE,
                         device=dev),
        k_rope=torch.zeros((batch, max_len, m.d_rope),
                           dtype=layers.ACT_DTYPE, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def mla_decode(params: dict, x: torch.Tensor, cache: MLACache,
               cfg: ModelConfig, window: int = 0, spec: tuple | None = None
               ) -> tuple[torch.Tensor, MLACache]:
    """Absorbed decode: attend in the compressed latent space.  Where
    ``spec`` (as :func:`gqa_decode`'s) cuts the sequence, ``c_kv`` and
    ``k_rope`` are this rank's slots and the softmax is split over the
    blocks, ``o_lat`` combined before ``w_uv``."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos = cache.pos
    q_nope, q_rope = _mla_q(params, x, pos[:, None], cfg)      # (B,1,H,·)
    c_kv_new, k_rope_new = _mla_kv_latent(params, x, pos[:, None], cfg)

    S_loc = cache.c_kv.shape[1]
    seq, n, i = mesh_ops.cache_cut(spec.c_kv[1] if spec else None)
    S, start = S_loc * n, S_loc * i
    slot, mine = _slot_block(torch.clamp_max(pos, S - 1).long(), S_loc,
                             start, bool(seq))
    at = (torch.arange(B, device=x.device), slot)
    c_kv = _put(cache.c_kv, at, c_kv_new[:, 0], mine)
    k_rope = _put(cache.k_rope, at, k_rope_new[:, 0], mine)

    wkv_b = params["wkv_b"].reshape(m.kv_lora, H, m.d_nope + m.d_v)
    w_uk, w_uv = wkv_b[..., :m.d_nope], wkv_b[..., m.d_nope:]
    # absorb W_UK into the query → score directly against the latent cache
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(),
                         w_uk.float())                          # (B,H,kv_lora)
    s = torch.einsum("bhl,bsl->bhs", q_abs, c_kv.float())
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                         k_rope.float())
    s = s * (m.d_nope + m.d_rope) ** -0.5
    valid = start + torch.arange(S_loc, device=x.device)[None, :] \
        <= pos[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    o_lat = _softmax_v(s, c_kv.float(), "bhs,bsl->bhl", seq)
    o = torch.einsum("bhl,lhd->bhd", o_lat, w_uv.float())
    y = o.reshape(B, 1, H * m.d_v).to(x.dtype) @ params["wo"]
    return y, MLACache(c_kv, k_rope, pos + 1)
