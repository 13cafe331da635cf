"""Shared primitive layers: RMSNorm, RoPE, SwiGLU, embeddings.

Counterpart of ``repro/models/layers.py``: init/apply function pairs over
nested-dict parameters.  An ``init`` draws the reference's bits from a
key (:mod:`repro_torch.random`) and makes its tensors on the key's
device; an ``apply`` is float math, held to the reference within a
stated tolerance (tests/test_torch_models.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as rnd

PARAM_DTYPE = torch.bfloat16
ACT_DTYPE = torch.bfloat16


def _normal(key: torch.Tensor, shape, scale: float) -> torch.Tensor:
    """``normal(key, shape, f32) * scale``, then bfloat16: the product is
    taken in float32 before the cast."""
    return (rnd.normal(key, shape) * scale).to(PARAM_DTYPE)


def dense_init(key: torch.Tensor, d_in: int, d_out: int) -> torch.Tensor:
    return _normal(key, (d_in, d_out), (1.0 / d_in) ** 0.5)


def rmsnorm_init(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=PARAM_DTYPE, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (B, T) int.  Angles, cos and sin in
    float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    ang = positions[..., None].float() * freqs               # (B, T, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(key: torch.Tensor, d_model: int, d_ff: int) -> dict:
    k1, k2, k3 = rnd.split(key, 3)
    return {
        "gate": dense_init(k1, d_model, d_ff),
        "up": dense_init(k2, d_model, d_ff),
        "down": dense_init(k3, d_ff, d_model),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ params["gate"])
    return ((g * (x @ params["up"])) @ params["down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_init(key: torch.Tensor, vocab: int, d_model: int) -> torch.Tensor:
    return _normal(key, (vocab, d_model), 0.02)


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]   # activations inherit the param dtype


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    w = table_or_head.float()
    xf = x.float()
    return xf @ (w.T if transpose else w)
