"""Mamba-1 selective-SSM mixer (Jamba's recurrent layer, arXiv:2403.19887).

Counterpart of ``repro/models/mamba.py``: a loop over time chunks
carrying the (B, d_inner, N) state in float32.  Inside a chunk the
reference runs the associative scan of ``(a₀·b₀, a₁·b₀ + b₁)``; the port
runs the same recurrence as a sequential cumulative product and sum over
the chunk's steps (the local state from zero and the running decay
product), then adds the carried state times that product, as the
reference does.  Each chunk body is checkpointed, so the backward pass
recomputes the (B, Lc, d_inner, N) intermediates.

Decode is the exact recurrence: one state update per token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch import xla_f32
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding import mesh_ops


class MambaCache(NamedTuple):
    h: torch.Tensor       # (B, d_inner, N) SSM state
    conv: torch.Tensor    # (B, d_conv-1, d_inner) causal-conv tail
    pos: torch.Tensor     # (B,)


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_inner, dt_rank


def mamba_init(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """``A_log`` is XLA:CPU's float32 log of 1..N (:mod:`xla_f32`)."""
    mc, d_inner, dt_rank = _dims(cfg)
    ks = rnd.split(key, 6)
    dev = key.device
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(d_inner, 1)
    return {
        "in_proj": dense_init(ks[0], cfg.d_model, 2 * d_inner),
        "conv_w": (rnd.normal(ks[1], (mc.d_conv, d_inner))
                   * (1.0 / mc.d_conv) ** 0.5).to(layers.PARAM_DTYPE),
        "conv_b": torch.zeros((d_inner,), dtype=layers.PARAM_DTYPE,
                              device=dev),
        "x_proj": dense_init(ks[2], d_inner, dt_rank + 2 * mc.d_state),
        "dt_proj": dense_init(ks[3], dt_rank, d_inner),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=layers.PARAM_DTYPE,
                              device=dev),
        "A_log": xla_f32.log(a),                   # f32, recurrence-critical
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(ks[4], d_inner, cfg.d_model),
    }


def _conv_causal(xin: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over time.  xin: (B, T, d_inner)."""
    K = w.shape[0]
    if tail is None:
        pad = xin.new_zeros((xin.shape[0], K - 1, xin.shape[2]))
    else:
        pad = tail.to(xin.dtype)
    xp = torch.cat([pad, xin], dim=1)              # (B, T+K-1, d)
    T = xin.shape[1]
    out = xp[:, 0:T] * w[0].to(xin.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i].to(xin.dtype)
    return F.silu(out + b.to(xin.dtype))


def _ssm_inputs(params: dict, xc: torch.Tensor, cfg: ModelConfig,
                proj: torch.Tensor | None = None):
    """Per-token SSM tensors.  xc: (B, L, d_inner) (post-conv); ``proj``:
    ``xc @ x_proj`` where the caller computed it."""
    mc, _, dt_rank = _dims(cfg)
    if proj is None:
        proj = xc @ params["x_proj"]
    dt_r = proj[..., :dt_rank]
    Bs = proj[..., dt_rank:dt_rank + mc.d_state].float()
    Cs = proj[..., dt_rank + mc.d_state:].float()
    dt = F.softplus((dt_r @ params["dt_proj"]).float()
                    + params["dt_bias"].float())
    A = -torch.exp(params["A_log"])                # (d_inner, N)
    decay = torch.exp(dt[..., None] * A)           # (B, L, d_inner, N)
    dBx = (dt * xc.float())[..., None] * Bs[:, :, None, :]
    return decay, dBx, Cs


def _chunk(params: dict, cfg: ModelConfig, h0: torch.Tensor,
           xck: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (carried state, the chunk's xc) → (last state, y)."""
    decay, dBx, Cs = _ssm_inputs(params, xck, cfg)
    cum_a, h_loc = [decay[:, 0]], [dBx[:, 0]]
    for t in range(1, decay.shape[1]):
        cum_a.append(cum_a[-1] * decay[:, t])
        h_loc.append(h_loc[-1] * decay[:, t] + dBx[:, t])
    h = torch.stack(h_loc, 1) + torch.stack(cum_a, 1) * h0[:, None]
    y = torch.einsum("blds,bls->bld", h, Cs)
    y = y + params["D"] * xck.float()
    return h[:, -1], y


def mamba_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 256) -> torch.Tensor:
    """Training / prefill forward.  x: (B, T, d_model)."""
    B, T, _ = x.shape
    _, d_inner, _ = _dims(cfg)
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc = _conv_causal(xin, params["conv_w"], params["conv_b"])

    Lc = min(chunk, T)
    h = torch.zeros((B, d_inner, cfg.mamba.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, T, Lc):
        # padded steps of the last chunk only follow the real ones, so
        # the chunk is simply cut short
        h, y = checkpoint(_chunk, params, cfg, h, xc[:, c0:c0 + Lc],
                          use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"]


def mamba_init_cache(cfg: ModelConfig, batch: int,
                     device=None) -> MambaCache:
    mc, d_inner, _ = _dims(cfg)
    dev = devices.resolve(device)
    return MambaCache(
        h=torch.zeros((batch, d_inner, mc.d_state), dtype=torch.float32,
                      device=dev),
        conv=torch.zeros((batch, mc.d_conv - 1, d_inner),
                         dtype=layers.ACT_DTYPE, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def _channels(params: dict, ch: slice) -> dict:
    """The leaves a block ``ch`` of the ``d_inner`` channels reads, cut to
    it: the conv taps and bias, ``dt_proj``'s columns, ``dt_bias``,
    ``A_log``, ``D`` and ``x_proj``'s rows."""
    return {**params, "conv_w": params["conv_w"][:, ch],
            "conv_b": params["conv_b"][ch], "x_proj": params["x_proj"][ch],
            "dt_proj": params["dt_proj"][:, ch],
            "dt_bias": params["dt_bias"][ch], "A_log": params["A_log"][ch],
            "D": params["D"][ch]}


def mamba_decode(params: dict, x: torch.Tensor, cache: MambaCache,
                 cfg: ModelConfig, spec: MambaCache | None = None
                 ) -> tuple[torch.Tensor, MambaCache]:
    """One token.  x: (B, 1, d_model).

    ``spec``: the cache's specs under ``rules.cache_specs`` (one layer's,
    the stacked axis dropped) on the current mesh.  Where they cut the
    ``d_inner`` channels over ``model``, ``h`` and ``conv`` are this
    rank's channels: the convolution and the per-channel recurrence run
    on them, ``x_proj``'s product (which reads every channel) is this
    block's partial product in float32 summed over the axes, and ``y``'s
    channels are gathered before ``out_proj``."""
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)            # (B, 1, d_inner)
    feat, _, i = mesh_ops.cache_cut(spec.h[1] if spec else None)
    p, proj = params, None
    if feat:
        d_loc = cache.h.shape[1]
        p = _channels(params, slice(i * d_loc, (i + 1) * d_loc))
        xin = xin[..., i * d_loc:(i + 1) * d_loc]

    window = torch.cat([cache.conv.to(xin.dtype), xin], dim=1)  # (B, K, d)
    w = p["conv_w"]
    xc = F.silu((window * w.to(window.dtype)[None]).sum(1)
                + p["conv_b"].to(window.dtype))[:, None]
    if feat:
        proj = mesh_ops.reduce_plain(xc.float() @ p["x_proj"].float(), feat,
                                     "context").to(xc.dtype)
    decay, dBx, Cs = _ssm_inputs(p, xc, cfg, proj)
    h = decay[:, 0] * cache.h + dBx[:, 0]
    y = torch.einsum("bds,bs->bd", h, Cs[:, 0])
    y = y + p["D"] * xc[:, 0].float()
    y = mesh_ops.gather_plain(y, 1, feat, "context")
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    return out, MambaCache(h=h, conv=window[:, 1:], pos=cache.pos + 1)
