"""Composable decoder stack: blocks assembled from LayerSpecs, with a
unified decode-cache protocol across attention/Mamba/xLSTM mixers.

Counterpart of ``repro/models/transformer.py``.  Parameters are the
reference's nested dicts: ``{"embed", "final_norm", "lm_head"?,
"segments"}``, where ``segments`` is a list (one per segment) of tuples
(one per pattern position) of block parameters whose leaves carry the
segment's ``repeat`` layers stacked on a leading axis, as the reference's
``jax.vmap(block_init)`` builds them.  So checkpoints carry the
reference's leaf keys (``segments/0/0/mixer/wq``).

The reference scans a segment's repeat axis; the port loops over it,
each layer's parameters a view of the stacked leaves (``unbind``, whose
backward stacks the layers' gradients once).  ``remat=True`` wraps each
layer in ``torch.utils.checkpoint`` (non-reentrant).  The mesh-only
branches of the reference (``_constrain_logits``,
``_constrain_batch_only``, ``_sharded_ce``) are the identity, or fall
through, without a mesh, and are not ported.
"""
from __future__ import annotations

import os
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.models import attention, layers, mamba, moe, xlstm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_init

Params = Any
Cache = Any


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_init(key: torch.Tensor, cfg: ModelConfig, spec: LayerSpec
               ) -> Params:
    k_mix, k_ffn = rnd.split(key)
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, key.device)}
    if spec.mixer == "attn":
        p["mixer"] = (attention.mla_init(k_mix, cfg)
                      if cfg.attn_kind == "mla"
                      else attention.gqa_init(k_mix, cfg))
    elif spec.mixer == "mamba":
        p["mixer"] = mamba.mamba_init(k_mix, cfg)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm.mlstm_init(k_mix, cfg)
    elif spec.mixer == "slstm":
        p["mixer"] = xlstm.slstm_init(k_mix, cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, key.device)
        p["ffn"] = layers.mlp_init(k_ffn, cfg.d_model, cfg.d_ff)
    elif spec.ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, key.device)
        p["ffn"] = moe.moe_init(k_ffn, cfg)
    return p


def block_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, spec: LayerSpec, window: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        apply = (attention.mla_apply if cfg.attn_kind == "mla"
                 else attention.gqa_apply)
        h = apply(p["mixer"], h, positions, cfg, window=window)
    elif spec.mixer == "mamba":
        h = mamba.mamba_apply(p["mixer"], h, cfg)
    elif spec.mixer == "mlstm":
        h = xlstm.mlstm_apply(p["mixer"], h, cfg)
    elif spec.mixer == "slstm":
        h = xlstm.slstm_apply(p["mixer"], h, cfg)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "dense":
        x = x + layers.mlp_apply(p["ffn"], rmsnorm(x, p["norm2"],
                                                   cfg.norm_eps))
    elif spec.ffn == "moe":
        y, aux = moe.moe_apply(p["ffn"], rmsnorm(x, p["norm2"],
                                                 cfg.norm_eps), cfg)
        x = x + y
    return x, aux


def block_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, window: int = 0,
                     quantized: bool | None = None, device=None) -> Cache:
    """One layer's decode cache; ``quantized=None`` reads
    ``REPRO_QUANT_KV`` (``1``: the int8 KV cache)."""
    if quantized is None:
        quantized = os.environ.get("REPRO_QUANT_KV") == "1"
    if spec.mixer == "attn":
        if cfg.attn_kind == "mla":
            return attention.mla_init_cache(cfg, batch, max_len, window,
                                            device=device)
        return attention.gqa_init_cache(cfg, batch, max_len, window,
                                        quantized=quantized, device=device)
    if spec.mixer == "mamba":
        return mamba.mamba_init_cache(cfg, batch, device=device)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_init_cache(cfg, batch, device=device)
    if spec.mixer == "slstm":
        return xlstm.slstm_init_cache(cfg, batch, device=device)
    raise ValueError(spec.mixer)


def block_decode(p: Params, x: torch.Tensor, cache: Cache, cfg: ModelConfig,
                 spec: LayerSpec, window: int = 0
                 ) -> tuple[torch.Tensor, Cache]:
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        if cfg.attn_kind == "mla":
            h, cache = attention.mla_decode(p["mixer"], h, cache, cfg)
        else:
            h, cache = attention.gqa_decode(p["mixer"], h, cache, cfg,
                                            window=window)
    elif spec.mixer == "mamba":
        h, cache = mamba.mamba_decode(p["mixer"], h, cache, cfg)
    elif spec.mixer == "mlstm":
        h, cache = xlstm.mlstm_decode(p["mixer"], h, cache, cfg)
    elif spec.mixer == "slstm":
        h, cache = xlstm.slstm_decode(p["mixer"], h, cache, cfg)
    x = x + h
    if spec.ffn == "dense":
        x = x + layers.mlp_apply(p["ffn"], rmsnorm(x, p["norm2"],
                                                   cfg.norm_eps))
    elif spec.ffn == "moe":
        y, _ = moe.moe_apply(p["ffn"], rmsnorm(x, p["norm2"], cfg.norm_eps),
                             cfg)
        x = x + y
    return x, cache


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------

def _unstack(p: Any, n: int) -> list:
    """A tree of dicts (or a named tuple) of stacked tensors → its ``n``
    layers, each leaf a view of its stacked tensor."""
    if isinstance(p, torch.Tensor):
        return list(p.unbind(0))
    if isinstance(p, tuple) and hasattr(p, "_fields"):
        cols = [_unstack(v, n) for v in p]
        return [type(p)(*(c[i] for c in cols)) for i in range(n)]
    parts = {k: _unstack(v, n) for k, v in p.items()}
    return [{k: parts[k][i] for k in p} for i in range(n)]


def _restack(items: list) -> Any:
    """The inverse of :func:`_unstack` for named tuples of tensors."""
    return type(items[0])(*(torch.stack(col) for col in zip(*items)))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init(key: torch.Tensor, cfg: ModelConfig) -> Params:
    """The reference's parameters, bit for bit, on the key's device:
    keys split and folded as the reference's ``init``; each segment's
    layers drawn one at a time into their stacked tensors.  On ``meta``
    (shapes only: ``param_count``, the dry run's abstract inputs) one
    layer a pattern position is drawn; the rest hold no values."""
    k_emb, k_head, k_seg = rnd.split(key, 3)
    params: dict = {
        "embed": layers.embed_init(k_emb, cfg.padded_vocab, cfg.d_model),
        "final_norm": rmsnorm_init(cfg.d_model, key.device),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(k_head, cfg.d_model,
                                              cfg.padded_vocab)
    for si, (repeat, pattern) in enumerate(cfg.segments):
        k_si = rnd.fold_in(k_seg, si)
        pat_params = []
        for pi, spec in enumerate(pattern):
            ks = rnd.split(rnd.fold_in(k_si, pi), repeat)
            first = block_init(ks[0], cfg, spec)
            stacked = tree.map(lambda a: a.new_empty((repeat,) + a.shape),
                               first)
            for r in range(1 if key.device.type == "meta" else repeat):
                layer = first if r == 0 else block_init(ks[r], cfg, spec)
                tree.map(lambda s, a, r=r: s[r].copy_(a), stacked, layer)
                del layer
            pat_params.append(stacked)
        params["segments"].append(tuple(pat_params))
    return params


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x, transpose=True)
    else:
        logits = layers.unembed(params["lm_head"], x, transpose=False)
    if cfg.padded_vocab != cfg.vocab:
        # mask pad columns so loss/argmax never see them
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, window: int = 0,
            remat: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward → (logits (B,T,V) f32, aux loss scalar).
    The reference's ``return_hidden``, which only its shard-mapped CE
    reads, waits for the mesh branches."""
    if embeds is None:
        embeds = layers.embed_apply(params["embed"], tokens)
    x = embeds
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()

    for seg_params, (repeat, pattern) in zip(params["segments"],
                                             cfg.segments):
        per_layer = [_unstack(lp, repeat) for lp in seg_params]
        for r in range(repeat):
            for spec, lp in zip(pattern, per_layer):
                if remat:
                    x, a = checkpoint(block_apply, lp[r], x, positions, cfg,
                                      spec, window, use_reentrant=False)
                else:
                    x, a = block_apply(lp[r], x, positions, cfg, spec,
                                       window=window)
                aux = aux + a
    return _logits(params, x, cfg), aux


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = lse - label_logit
    if valid is not None:
        valid = torch.broadcast_to(valid, ce.shape)
        return (ce * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    return ce.mean()


def mtp_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             labels: torch.Tensor, depth: int = 1,
             weight: float = 0.3) -> torch.Tensor:
    """Multi-token-prediction auxiliary objective (DeepSeek-V3 §2.2): the
    same trunk/head predicts the (1+depth)-ahead token from each
    position; positions whose target falls off the sequence are masked
    out."""
    logits, _ = forward(params, cfg, tokens=tokens)
    shifted = torch.roll(labels, -depth, dims=1)
    T = labels.shape[1]
    valid = (torch.arange(T, device=labels.device) < T - depth
             ).to(logits.dtype)[None, :]
    return weight * _ce_from_logits(logits, shifted, valid)


def lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, window: int = 0
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy plus the MoE aux loss.

    ``REPRO_SHARDED_CE=1`` asks the reference for its shard-mapped CE,
    which without a mesh falls through to this same default; the port
    has no mesh and does not read the variable."""
    logits, aux = forward(params, cfg, tokens=tokens, window=window)
    ce = _ce_from_logits(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: int = 0, quantized: bool | None = None,
               device=None) -> list:
    """Every layer's decode cache, stacked per segment and pattern
    position as the parameters are; every leaf zeros, as the reference's
    ``init_cache`` makes them (the xLSTM stabilizers too)."""
    caches = []
    for repeat, pattern in cfg.segments:
        pat = []
        for spec in pattern:
            c = block_init_cache(cfg, spec, batch, max_len, window,
                                 quantized, device=device)
            pat.append(type(c)(*(a.new_zeros((repeat,) + a.shape)
                                 for a in c)))
        caches.append(tuple(pat))
    return caches


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: list, window: int = 0
                ) -> tuple[torch.Tensor, list]:
    """token: (B, 1) int → (logits (B, 1, V), updated caches)."""
    x = layers.embed_apply(params["embed"], token)
    new_caches = []
    for seg_params, seg_cache, (repeat, pattern) in zip(
            params["segments"], caches, cfg.segments):
        lps = [_unstack(lp, repeat) for lp in seg_params]
        lcs = [_unstack(lc, repeat) for lc in seg_cache]
        outs: list[list] = [[] for _ in pattern]
        for r in range(repeat):
            for pi, spec in enumerate(pattern):
                x, cn = block_decode(lps[pi][r], x, lcs[pi][r], cfg, spec,
                                     window=window)
                outs[pi].append(cn)
        new_caches.append(tuple(_restack(o) for o in outs))
    return _logits(params, x, cfg), new_caches


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax(logits, -1)`` as int32: the first index of the
    largest value."""
    return torch.argmax(logits, dim=-1).to(torch.int32)

