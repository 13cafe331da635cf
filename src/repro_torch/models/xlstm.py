"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent gating), per arXiv:2405.04517.

Counterpart of ``repro/models/xlstm.py``.  Both are exponential-gated
LSTMs with a running log-max stabilizer ``m_t``.  The mLSTM carries a
per-head (dh × dh) matrix memory ``C_t = f'·C_{t-1} + i'·v k^T``; the
sLSTM's gates see ``h_{t-1}`` through per-head recurrent matrices.

A loop over time chunks, each chunk's body checkpointed (the backward
recomputes inside the chunk; only chunk-boundary states are kept), and
inside it the exact step loop.  The mLSTM's other form, ``chunkwise``
(``REPRO_MLSTM_CHUNKWISE=1``, chunk length ``REPRO_MLSTM_CHUNK``), takes
the intra-chunk terms as a masked (L×L) quadratic and touches ``C`` only
at chunk boundaries.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.mamba import _conv_causal
from repro_torch.sharding import mesh_ops


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMCache(NamedTuple):
    C: torch.Tensor       # (B, H, dh, dh)
    n: torch.Tensor       # (B, H, dh)
    m: torch.Tensor       # (B, H)
    conv: torch.Tensor    # (B, K-1, d_inner)
    pos: torch.Tensor


_CONV_K = 4
_EXPAND = 2


def _mdims(cfg: ModelConfig):
    d_inner = _EXPAND * cfg.d_model
    dh = d_inner // cfg.n_heads
    return d_inner, dh


def linspace_f32(start: float, stop: float, num: int,
                 device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32: ``start + i·step``
    below the last point, which is ``stop`` itself."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    step = torch.tensor((stop - start) / (num - 1), dtype=torch.float32)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    out = torch.tensor(start, dtype=torch.float32) + i * step.to(device)
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32,
                                        device=device)])


def mlstm_init(key: torch.Tensor, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, dh = _mdims(cfg)
    ks = rnd.split(key, 7)
    dev = key.device
    return {
        "in_proj": dense_init(ks[0], d, 2 * d_inner),   # [xu ‖ gate branch]
        "conv_w": (rnd.normal(ks[1], (_CONV_K, d_inner)) * 0.5
                   ).to(layers.PARAM_DTYPE),
        "conv_b": torch.zeros((d_inner,), dtype=layers.PARAM_DTYPE,
                              device=dev),
        "wq": dense_init(ks[2], d_inner, d_inner),
        "wk": dense_init(ks[3], d_inner, d_inner),
        "wv": dense_init(ks[4], d_inner, d_inner),
        "w_gates": dense_init(ks[5], d_inner, 2 * cfg.n_heads),
        "gate_b": torch.cat([torch.zeros((cfg.n_heads,), device=dev),
                             linspace_f32(3.0, 6.0, cfg.n_heads, dev)]
                            ).float(),                   # i, f biases
        "h_norm": rmsnorm_init(d_inner, dev),
        "out_proj": dense_init(ks[6], d_inner, d),
    }


def _mlstm_qkvg(params: dict, x: torch.Tensor, cfg: ModelConfig,
                conv_tail: torch.Tensor | None):
    B, T, _ = x.shape
    d_inner, dh = _mdims(cfg)
    H = cfg.n_heads
    xu, xg = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    xc = _conv_causal(xu, params["conv_w"], params["conv_b"], conv_tail)
    q = (xc @ params["wq"]).reshape(B, T, H, dh)
    k = (xc @ params["wk"]).reshape(B, T, H, dh)
    k = k * torch.tensor(dh ** -0.5, dtype=k.dtype)   # the scale in k's dtype
    v = (xu @ params["wv"]).reshape(B, T, H, dh)
    gates = (xc @ params["w_gates"]).float() + params["gate_b"]
    i_t, f_t = gates[..., :H], gates[..., H:]        # (B, T, H) pre-acts
    f_t = F.logsigmoid(f_t)                          # log forget gate
    return q, k, v, i_t, f_t, xg, xu


def _block(cut: tuple, n: int) -> slice:
    """This rank's block of ``n`` along a ``dh`` axis cut as
    :func:`repro_torch.sharding.mesh_ops.cache_cut` says (``cut``), of
    ``n`` elements held; the whole axis where it is not cut."""
    axes, _, i = cut
    return slice(i * n, (i + 1) * n) if axes else slice(None)


def _mlstm_step(state, qkvif, cut: tuple = ((), 1, 0)):
    """Stabilized mLSTM recurrence for one step (all heads).  ``cut``
    (:func:`repro_torch.sharding.mesh_ops.cache_cut`): where it cuts
    ``dh``, ``C`` holds this rank's block of its ``v`` axis and ``n`` of
    its ``k`` axis; ``n·q`` is summed over the axes and ``h``'s block
    gathered."""
    C, n, m = state
    q, k, v, i_t, f_t = qkvif                        # (B,H,dh)·3, (B,H)·2
    blk = _block(cut, n.shape[-1])
    m_new = torch.maximum(f_t + m, i_t)
    ip = torch.exp(i_t - m_new)[..., None]           # (B,H,1)
    fp = torch.exp(f_t + m - m_new)[..., None]
    C = fp[..., None] * C + ip[..., None] * torch.einsum("bhd,bhe->bhde",
                                                         v[..., blk], k)
    n = fp * n + ip * k[..., blk]
    num = torch.einsum("bhde,bhe->bhd", C, q.float())
    den = torch.abs(mesh_ops.reduce_plain(
        torch.einsum("bhd,bhd->bh", n, q[..., blk].float()), cut[0],
        "context"))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return (C, n, m_new), mesh_ops.gather_plain(h, 2, cut[0], "context")


def _mlstm_chunkwise(q, k, v, i_t, f_t, chunk: int):
    """Chunkwise-parallel mLSTM, the same stabilized math as the step
    loop.  q,k,v: (B,T,H,dh) f32 (k pre-scaled); i_t: (B,T,H) log-input
    gate; f_t: (B,T,H) log-forget gate.  Returns h (B,T,H,dh) f32."""
    B, T, H, dh = q.shape
    L = min(chunk, T)
    n_chunks = -(-T // L)
    Tp = n_chunks * L

    def pad_c(a, fill=0.0):
        a = F.pad(a, (0, 0) * (a.ndim - 2) + (0, Tp - T), value=fill)
        return a.reshape((B, n_chunks, L) + a.shape[2:]).transpose(0, 1)

    qc, kc, vc = pad_c(q), pad_c(k), pad_c(v)
    # pad i with -inf so padded positions never contribute
    ic = pad_c(i_t, -1e30)
    fc = pad_c(f_t)                                   # logf; pad 0 is fine
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    def chunk_fn(C, n, m, qk, kk, vk, ik, fk):
        b = torch.cumsum(fk, dim=1)                   # (B,L,H) Σ logf ≤ t
        btot = b[:, -1]                               # (B,H)
        # intra exponent: b_t − b_s + a_s  (s ≤ t); inter: b_t + m
        g = b[:, :, None, :] - b[:, None, :, :] + ik[:, None, :, :]
        g = torch.where(tri[None, :, :, None], g, -1e30)      # (B,t,s,H)
        m_intra = g.amax(dim=2)                       # (B,L,H)
        m_inter = b + m[:, None, :]                   # (B,L,H)
        m_comb = torch.maximum(m_intra, m_inter)

        D = torch.exp(g - m_comb[:, :, None, :])      # (B,t,s,H)
        s_qk = torch.einsum("bthd,bshd->btsh", qk, kk)
        h_intra = torch.einsum("btsh,bshd->bthd", s_qk * D, vk)
        inter_scale = torch.exp(m_inter - m_comb)     # (B,L,H)
        h_inter = torch.einsum("bthe,bhde->bthd", qk, C) \
            * inter_scale[..., None]
        num = h_intra + h_inter

        n_intra = torch.einsum("btsh,bshd->bthd", D, kk)
        n_t = n_intra + n[:, None] * inter_scale[..., None]
        den = torch.abs(torch.einsum("bthd,bthd->bth", n_t, qk))
        h = num / torch.maximum(den, torch.exp(-m_comb))[..., None]

        m_next = torch.maximum(btot + m,
                               (btot[:, None] - b + ik).amax(dim=1))
        w_s = torch.exp(btot[:, None] - b + ik - m_next[:, None])
        C_new = torch.exp(btot + m - m_next)[..., None, None] * C \
            + torch.einsum("bsh,bshd,bshe->bhde", w_s, vk, kk)
        n_new = torch.exp(btot + m - m_next)[..., None] * n \
            + torch.einsum("bsh,bshd->bhd", w_s, kk)
        return C_new, n_new, m_next, h

    C = q.new_zeros((B, H, dh, dh))
    n = q.new_zeros((B, H, dh))
    m = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(n_chunks):
        C, n, m, h = checkpoint(chunk_fn, C, n, m, qc[c], kc[c], vc[c],
                                ic[c], fc[c], use_reentrant=False)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :T]


def _mlstm_scan_chunk(state, qk, kk, vk, ik, fk):
    hs = []
    for t in range(qk.shape[1]):
        state, h = _mlstm_step(state, (qk[:, t], kk[:, t], vk[:, t],
                                       ik[:, t], fk[:, t]))
        hs.append(h)
    return (*state, torch.stack(hs, dim=1))          # h: (B, Lc, H, dh)


def mlstm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 64, impl: str | None = None) -> torch.Tensor:
    if impl is None:
        impl = "chunkwise" \
            if os.environ.get("REPRO_MLSTM_CHUNKWISE") == "1" else "scan"
        chunk = int(os.environ.get("REPRO_MLSTM_CHUNK", chunk))
    B, T, _ = x.shape
    d_inner, dh = _mdims(cfg)
    H = cfg.n_heads
    q, k, v, i_t, f_t, xg, _ = _mlstm_qkvg(params, x, cfg, None)
    q, k, v = q.float(), k.float(), v.float()

    if impl == "chunkwise":
        h = _mlstm_chunkwise(q, k, v, i_t, f_t, chunk)
    else:
        Lc = min(chunk, T)
        state = (q.new_zeros((B, H, dh, dh)), q.new_zeros((B, H, dh)),
                 torch.full((B, H), -1e30, dtype=torch.float32,
                            device=x.device))
        hs = []
        for c0 in range(0, T, Lc):
            sl = slice(c0, c0 + Lc)
            *state, hc = checkpoint(_mlstm_scan_chunk, state, q[:, sl],
                                    k[:, sl], v[:, sl], i_t[:, sl],
                                    f_t[:, sl], use_reentrant=False)
            hs.append(hc)
        h = torch.cat(hs, dim=1)
    h = h.reshape(B, T, H * dh)
    h = rmsnorm(h.to(x.dtype), params["h_norm"], cfg.norm_eps)
    return (h * F.silu(xg)) @ params["out_proj"]


def mlstm_init_cache(cfg: ModelConfig, batch: int,
                     device=None) -> MLSTMCache:
    d_inner, dh = _mdims(cfg)
    H = cfg.n_heads
    dev = devices.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return MLSTMCache(
        C=torch.zeros((batch, H, dh, dh), **f32),
        n=torch.zeros((batch, H, dh), **f32),
        m=torch.full((batch, H), -1e30, **f32),
        conv=torch.zeros((batch, _CONV_K - 1, d_inner),
                         dtype=layers.ACT_DTYPE, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def mlstm_decode(params: dict, x: torch.Tensor, cache: MLSTMCache,
                 cfg: ModelConfig, spec: MLSTMCache | None = None
                 ) -> tuple[torch.Tensor, MLSTMCache]:
    """One token.  ``spec``: the cache's specs under
    ``rules.cache_specs`` (one layer's, the stacked axis dropped) on the
    current mesh.  Where they cut ``dh``, ``C`` and ``n`` are this rank's
    block (:func:`_mlstm_step`), ``m`` whole; where they cut the conv
    tail's ``d_inner``, the tail is gathered for the step and this
    rank's channels kept."""
    B = x.shape[0]
    d_inner, dh = _mdims(cfg)
    H = cfg.n_heads
    cut = mesh_ops.cache_cut(spec.C[2] if spec else None)
    feat, _, i = mesh_ops.cache_cut(spec.conv[2] if spec else None)
    tail = mesh_ops.gather_plain(cache.conv, 2, feat, "context")
    q, k, v, i_t, f_t, xg, xu_now = _mlstm_qkvg(params, x, cfg, tail)
    state = (cache.C, cache.n, cache.m)
    state, h = _mlstm_step(state, (q[:, 0].float(), k[:, 0].float(),
                                   v[:, 0].float(), i_t[:, 0], f_t[:, 0]),
                           cut)
    h = h.reshape(B, 1, H * dh)
    h = rmsnorm(h.to(x.dtype), params["h_norm"], cfg.norm_eps)
    y = (h * F.silu(xg)) @ params["out_proj"]
    conv = torch.cat([tail.to(xu_now.dtype), xu_now], dim=1)[:, 1:]
    if feat:
        d_loc = cache.conv.shape[2]
        conv = conv[..., i * d_loc:(i + 1) * d_loc].contiguous()
    return y, MLSTMCache(C=state[0], n=state[1], m=state[2], conv=conv,
                         pos=cache.pos + 1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMCache(NamedTuple):
    c: torch.Tensor       # (B, H, dh)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor       # (B, H)
    pos: torch.Tensor


def slstm_init(key: torch.Tensor, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    ks = rnd.split(key, 4)
    dev = key.device
    ff = -(-int(d * 4 / 3) // 8) * 8                 # post-MLP, factor 4/3
    return {
        "wx": dense_init(ks[0], d, 4 * d),           # i, f, z, o pre-acts
        "r": (rnd.normal(ks[1], (4, H, dh, dh))
              * dh ** -0.5).to(layers.PARAM_DTYPE),
        "b": torch.cat([torch.zeros((d,), device=dev),
                        torch.ones((d,), device=dev) * 2.0,  # forget bias
                        torch.zeros((2 * d,), device=dev)]).float(),
        "h_norm": rmsnorm_init(d, dev),
        "up": dense_init(ks[2], d, 2 * ff),          # GLU up (gate ‖ lin)
        "down": dense_init(ks[3], ff, d),
    }


def _slstm_step(params: dict, cfg: ModelConfig, state, wx_t,
                cut: tuple = ((), 1, 0)):
    """wx_t: (B, 4d) precomputed input pre-activations for one step;
    ``h`` whole.  ``cut`` (:func:`repro_torch.sharding.mesh_ops.cache_cut`):
    where it cuts ``dh``, ``c`` and ``n`` are this rank's block, the
    gates are computed on it, the new ``h``'s blocks gathered and the
    stabilizer's max taken over the axes."""
    c, n, h, m = state
    B = c.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    blk = _block(cut, c.shape[-1])
    hh = h.reshape(B, H, dh)
    rec = torch.einsum("ghde,bhd->gbhe", params["r"].float(), hh)
    pre = wx_t.float().reshape(B, 4, H, dh).transpose(0, 1) \
        + params["b"].reshape(4, 1, H, dh) + rec
    i_t, f_t, z_t, o_t = (pre[g][..., blk] for g in range(4))
    f_log = F.logsigmoid(f_t)
    m_new = torch.maximum(f_log + m[..., None], i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(f_log + m[..., None] - m_new)
    c = fp * c + ip * torch.tanh(z_t)
    n = fp * n + ip
    h_new = mesh_ops.gather_plain(
        torch.sigmoid(o_t) * c / torch.clamp_min(n, 1e-6), 2, cut[0],
        "context")
    m_new = mesh_ops.reduce_plain(m_new.amax(-1), cut[0], "context",
                                  dist.ReduceOp.MAX)
    return (c, n, h_new.reshape(B, -1), m_new)


def _slstm_scan_chunk(params, cfg, state, wxk):
    hs = []
    for t in range(wxk.shape[1]):
        state = _slstm_step(params, cfg, state, wxk[:, t])
        hs.append(state[2])
    return (*state, torch.stack(hs, dim=1))          # h: (B, Lc, d)


def _glu_out(params: dict, h: torch.Tensor, x_dtype, cfg: ModelConfig
             ) -> torch.Tensor:
    """The post-norm GLU: gelu (tanh form, ``jax.nn.gelu``'s default)."""
    h = rmsnorm(h.to(x_dtype), params["h_norm"], cfg.norm_eps)
    g, u = torch.chunk(h @ params["up"], 2, dim=-1)
    return (F.gelu(g, approximate="tanh") * u) @ params["down"]


def slstm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 64) -> torch.Tensor:
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    wx = x @ params["wx"]                            # (B, T, 4d)

    Lc = min(chunk, T)
    c0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    state = (c0, c0, torch.zeros((B, d), dtype=torch.float32,
                                 device=x.device),
             torch.full((B, H), -1e30, dtype=torch.float32, device=x.device))
    hs = []
    for t0 in range(0, T, Lc):
        *state, hc = checkpoint(_slstm_scan_chunk, params, cfg, state,
                                wx[:, t0:t0 + Lc], use_reentrant=False)
        hs.append(hc)
    return _glu_out(params, torch.cat(hs, dim=1), x.dtype, cfg)


def slstm_init_cache(cfg: ModelConfig, batch: int,
                     device=None) -> SLSTMCache:
    H = cfg.n_heads
    dh = cfg.d_model // H
    dev = devices.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.zeros((batch, H, dh), **f32)
    return SLSTMCache(c=z, n=z, h=torch.zeros((batch, cfg.d_model), **f32),
                      m=torch.full((batch, H), -1e30, **f32),
                      pos=torch.zeros((batch,), dtype=torch.int32,
                                      device=dev))


def slstm_decode(params: dict, x: torch.Tensor, cache: SLSTMCache,
                 cfg: ModelConfig, spec: SLSTMCache | None = None
                 ) -> tuple[torch.Tensor, SLSTMCache]:
    """One token.  ``spec`` as :func:`mlstm_decode`'s: where it cuts
    ``dh``, ``c`` and ``n`` are this rank's block (:func:`_slstm_step`);
    where it cuts ``h``'s ``d_model``, ``h`` is this rank's block, which
    the recurrent product gathers whole (it needs each head's whole
    ``h``)."""
    wx = (x @ params["wx"])[:, 0]
    hcut, _, i = mesh_ops.cache_cut(spec.h[1] if spec else None)
    h = mesh_ops.gather_plain(cache.h, 1, hcut, "context")
    state = (cache.c, cache.n, h, cache.m)
    c, n, h, m = _slstm_step(params, cfg, state, wx, mesh_ops.cache_cut(
        spec.c[2] if spec else None))
    y = _glu_out(params, h[:, None], x.dtype, cfg)
    if hcut:
        d_loc = cache.h.shape[1]
        h = h[:, i * d_loc:(i + 1) * d_loc].contiguous()
    return y, SLSTMCache(c=c, n=n, h=h, m=m, pos=cache.pos + 1)
