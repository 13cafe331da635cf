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
layer in ``torch.utils.checkpoint`` (non-reentrant).

The reference's mesh branches (``_constrain_logits``,
``_constrain_batch_only``, ``_sharded_ce``) act on the current mesh
(:func:`repro_torch.sharding.mesh_ops.current_mesh`, a mesh of
:mod:`repro_torch.launch.model_mesh`), where the parameters are each
rank's blocks: each layer's leaves are gathered just before it runs
(inside its checkpoint), the logits are this rank's vocab columns and
the cross entropy runs on them.  Without a mesh each is the identity,
or falls through, and the code is the one-process code: a layer runs
through the same gather, which then hands its leaves back as they are.
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
from repro_torch.sharding import mesh_ops, rules

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
                 spec: LayerSpec, window: int = 0, cache_spec: Any = None
                 ) -> tuple[torch.Tensor, Cache]:
    """One layer's decode step; ``cache_spec``: the layer's cache specs
    (``rules.cache_specs``, the stacked axis dropped) where ``cache`` is
    this rank's block of them on the current mesh."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        if cfg.attn_kind == "mla":
            h, cache = attention.mla_decode(p["mixer"], h, cache, cfg,
                                            spec=cache_spec)
        else:
            h, cache = attention.gqa_decode(p["mixer"], h, cache, cfg,
                                            window=window, spec=cache_spec)
    elif spec.mixer == "mamba":
        h, cache = mamba.mamba_decode(p["mixer"], h, cache, cfg,
                                      spec=cache_spec)
    elif spec.mixer == "mlstm":
        h, cache = xlstm.mlstm_decode(p["mixer"], h, cache, cfg,
                                      spec=cache_spec)
    elif spec.mixer == "slstm":
        h, cache = xlstm.slstm_decode(p["mixer"], h, cache, cfg,
                                      spec=cache_spec)
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


# ---------------------------------------------------------------------------
# On a mesh: parameters gathered on use, vocab-sharded logits
# ---------------------------------------------------------------------------

def _kept_on_model(cfg: ModelConfig):
    """The leaves the model code takes as this rank's block along
    ``model`` rather than gathered: the LM head's vocab columns, the tied
    embedding's vocab rows, and the expert banks where
    :func:`repro_torch.models.moe._constrain_ep` applies."""
    ep = moe._constrain_ep(cfg) is not None

    def kept(path, leaf) -> bool:
        name = "/".join(str(p) for p in path)
        return (name == "lm_head"
                or (name == "embed" and cfg.tie_embeddings)
                or (ep and leaf.ndim == 3
                    and name.endswith(("ffn/gate", "ffn/up", "ffn/down"))))
    return kept


def _top(params: Params, name: str, cfg: ModelConfig) -> torch.Tensor:
    """A top-level parameter as the model computes with it: on a mesh
    gathered from this rank's block (or kept, see :func:`_kept_on_model`),
    else the parameter itself."""
    mesh = mesh_ops.current_mesh()
    if mesh is None:
        return params[name]
    specs = param_specs(cfg, mesh)
    return mesh_ops.gathered({name: params[name]}, {name: specs[name]},
                             _kept_on_model(cfg))[name]


def _gathered(fn, shards: Params, specs, kept, *args):
    """``fn`` on one layer's leaves gathered from this rank's blocks
    here, so a checkpoint's recompute gathers them again; without a
    mesh ``fn`` on ``shards``."""
    return fn(mesh_ops.gathered(shards, specs, kept), *args)


_SPECS: dict = {}


def param_specs(cfg: ModelConfig, mesh) -> Any:
    """``rules.param_specs`` of ``cfg``'s parameters (drawn on ``meta``)
    on ``mesh``, kept a (config, grid, rules knobs) combination: the
    model code reads them every layer."""
    key = (cfg, tuple(mesh.axis_names), tuple(mesh.shape.values()),
           os.environ.get("REPRO_MOE_TP_NO_FSDP"),
           os.environ.get("REPRO_XLSTM_R_REPLICATED"))
    if key not in _SPECS:
        shapes = init(rnd.PRNGKey(0, "meta"), cfg)
        _SPECS[key] = rules.param_specs(
            shapes, mesh, cfg.moe.sharding if cfg.moe else "ep")
    return _SPECS[key]


def _layer_specs(cfg: ModelConfig, si: int) -> list | None:
    """Segment ``si``'s specs a pattern position, the stacked axis's entry
    dropped (a layer's leaves are unbound from the stack); ``None``
    without a mesh."""
    mesh = mesh_ops.current_mesh()
    if mesh is None:
        return None
    seg = param_specs(cfg, mesh)["segments"][si]
    return [tree.map(lambda s: s[1:], lp, is_leaf=mesh_ops.is_spec)
            for lp in seg]


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    table = _top(params, "embed", cfg)
    block = _constrain_logits(cfg) if cfg.tie_embeddings else None
    if block is None:
        return layers.embed_apply(table, tokens)
    # this rank's vocab rows: the tokens it holds, summed over ``model``
    width, row0 = block
    loc = tokens.long() - row0
    mine = (loc >= 0) & (loc < width)
    part = table[loc.clamp(0, width - 1)] * mine[..., None].to(table.dtype)
    return mesh_ops.reduce_sum(part, ("model",), "vocab")


def _constrain_logits(cfg: ModelConfig) -> tuple[int, int] | None:
    """The reference's ``_constrain_logits`` pins the logits to (batch
    over the FSDP axes) × (vocab over ``model``).  Here the batch is
    already this rank's block (the steps cut it by ``rules.batch_spec``,
    the reference's own guard); this returns this rank's vocab block,
    (width, first column), where the guard holds: a mesh with ``model``
    of size > 1 dividing the padded vocab.  ``None`` otherwise: whole
    logits."""
    m, i = mesh_ops.model_split()
    if m == 1 or cfg.padded_vocab % m:
        return None
    width = cfg.padded_vocab // m
    return width, i * width


def _constrain_batch_only(x: torch.Tensor) -> torch.Tensor:
    """The reference pins (B, T, d) activations to batch over the FSDP
    axes, d replicated over ``model`` — and never calls it (only its
    ``def`` is in the reference).  On the port's mesh every activation
    already has that layout (each rank holds its batch block, replicated
    over ``model``; the input ``_sharded_ce`` takes), so it is the
    identity, and nothing calls it here either."""
    return x


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """(B, T, V) float32 logits; on a mesh this rank's vocab columns
    (:func:`_constrain_logits`), pad columns masked by their global
    index."""
    x = rmsnorm(x, _top(params, "final_norm", cfg), cfg.norm_eps)
    block = _constrain_logits(cfg)
    width, col0 = block if block else (cfg.padded_vocab, 0)
    if block:
        x = mesh_ops.copy_in(x, ("model",), "vocab")
    if cfg.tie_embeddings:
        logits = layers.unembed(_top(params, "embed", cfg), x,
                                transpose=True)
    else:
        logits = layers.unembed(_top(params, "lm_head", cfg), x,
                                transpose=False)
    if cfg.padded_vocab != cfg.vocab:
        # mask pad columns so loss/argmax never see them
        pad = torch.arange(col0, col0 + width, device=x.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, window: int = 0,
            remat: bool = True, return_hidden: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward → (logits (B,T,V) f32, aux loss scalar);
    ``return_hidden=True`` skips the unembed and returns the final hidden
    states instead (the input of :func:`_sharded_ce`).  On a mesh the
    parameters are this rank's blocks, each layer's gathered just before
    it runs, and the logits are this rank's vocab columns."""
    if embeds is None:
        embeds = _embed(params, tokens, cfg)
    x = embeds
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    kept = _kept_on_model(cfg)

    for si, (seg_params, (repeat, pattern)) in enumerate(
            zip(params["segments"], cfg.segments)):
        per_layer = [_unstack(lp, repeat) for lp in seg_params]
        specs = _layer_specs(cfg, si)
        for r in range(repeat):
            for pi, (spec, lp) in enumerate(zip(pattern, per_layer)):
                args = (block_apply, lp[r], specs[pi] if specs else None,
                        kept, x, positions, cfg, spec, window)
                x, a = checkpoint(_gathered, *args, use_reentrant=False) \
                    if remat else _gathered(*args)
                aux = aux + a
    if return_hidden:
        return x, aux
    return _logits(params, x, cfg), aux


def _sharded_ce(params: Params, x: torch.Tensor, labels: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor | None:
    """The reference's shard-mapped unembed + cross entropy: each rank's
    (B_loc, T, V_loc) float32 logits block from its ``lm_head`` columns,
    pad columns masked by global index, the log-sum-exp's max and sum
    and the label logit reduced over ``model``, the sum over the FSDP
    axes, divided by B·T.  ``None`` where the reference's guard fails
    (no mesh or no ``model`` axis, tied embeddings, no ``lm_head``, a
    batch not cut over the FSDP axes, a vocab ``model`` does not
    divide): the caller falls back to :func:`_logits`."""
    mesh = mesh_ops.current_mesh()
    names = getattr(mesh, "axis_names", ())
    if mesh is None or "model" not in names or cfg.tie_embeddings \
            or "lm_head" not in params:
        return None
    if not rules.fsdp_axes(mesh) or mesh_ops.batch_entry() is None \
            or cfg.padded_vocab % mesh.shape["model"]:
        return None
    xl = rmsnorm(x, _top(params, "final_norm", cfg), cfg.norm_eps).float()
    block = _constrain_logits(cfg)
    width, col0 = block if block else (cfg.padded_vocab, 0)
    if block:
        xl = mesh_ops.copy_in(xl, ("model",), "vocab")
    logits = xl @ _top(params, "lm_head", cfg).float()   # (B_loc, T, V_loc)
    col = torch.arange(col0, col0 + width, device=x.device)
    logits = torch.where(col >= cfg.vocab, -1e30, logits)
    ce = mesh_ops.vocab_ce(logits, labels, col0) if block \
        else _ce_rows(logits, labels)
    return _batch_mean(ce)


def _ce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy of whole logits rows."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - label_logit


def _batch_mean(ce: torch.Tensor, valid: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The mean of per-position ``ce`` (weighted by ``valid``) over the
    whole batch: on a mesh whose batch is cut, the sums reduced over the
    batch axes."""
    axes = mesh_ops.batch_axes()
    if valid is not None:
        valid = torch.broadcast_to(valid, ce.shape)
        if not axes:
            return (ce * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
        num = mesh_ops.reduce_sum((ce * valid).sum(), axes, "batch")
        den = mesh_ops.reduce_plain(valid.sum(), axes, "batch")
        return num / torch.clamp_min(den, 1.0)
    if not axes:
        return ce.mean()
    n = mesh_ops.current_mesh().block(axes)[0]
    return mesh_ops.reduce_sum(ce.sum(), axes, "batch") / (ce.numel() * n)


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor | None = None,
                    cfg: ModelConfig | None = None) -> torch.Tensor:
    """Mean cross entropy; on a mesh (``cfg`` given) of this rank's vocab
    block (:func:`repro_torch.sharding.mesh_ops.vocab_ce`) and over the
    whole batch."""
    block = _constrain_logits(cfg) if cfg is not None else None
    ce = mesh_ops.vocab_ce(logits, labels, block[1]) if block \
        else _ce_rows(logits, labels)
    return _batch_mean(ce, valid)


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
    return weight * _ce_from_logits(logits, shifted, valid, cfg)


def lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, window: int = 0
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy plus the MoE aux loss.

    ``REPRO_SHARDED_CE=1`` takes the reference's opt-in path: the hidden
    states (``forward(..., return_hidden=True)``) into :func:`_sharded_ce`,
    or, where it does not apply (no mesh, among others), into
    :func:`_logits` and the default cross entropy."""
    if os.environ.get("REPRO_SHARDED_CE") == "1":
        hidden, aux = forward(params, cfg, tokens=tokens, window=window,
                              return_hidden=True)
        ce = _sharded_ce(params, hidden, labels, cfg)
        if ce is not None:
            return ce + aux, {"ce": ce, "aux": aux}
        logits = _logits(params, hidden, cfg)
    else:
        logits, aux = forward(params, cfg, tokens=tokens, window=window)
    ce = _ce_from_logits(logits, labels, cfg=cfg)
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
                caches: list, window: int = 0, cache_specs: Any = None
                ) -> tuple[torch.Tensor, list]:
    """token: (B, 1) int → (logits (B, 1, V), updated caches).  On a mesh
    each layer's leaves are gathered before it runs and the logits are
    this rank's vocab columns, and the caches are this rank's block of
    ``cache_specs`` (``rules.cache_specs`` of the whole caches): the
    batch over the FSDP axes, and the sequence, or the recurrent
    features, over ``model`` where they cut them (context-parallel
    decode)."""
    x = _embed(params, token, cfg)
    kept = _kept_on_model(cfg)
    new_caches = []
    for si, (seg_params, seg_cache, (repeat, pattern)) in enumerate(zip(
            params["segments"], caches, cfg.segments)):
        lps = [_unstack(lp, repeat) for lp in seg_params]
        lcs = [_unstack(lc, repeat) for lc in seg_cache]
        specs = _layer_specs(cfg, si)
        cspecs = [None] * len(pattern) if cache_specs is None else [
            tree.map(lambda sp: sp[1:], c, is_leaf=mesh_ops.is_spec)
            for c in cache_specs[si]]
        outs: list[list] = [[] for _ in pattern]
        for r in range(repeat):
            for pi, spec in enumerate(pattern):
                x, cn = _gathered(block_decode, lps[pi][r],
                                  specs[pi] if specs else None, kept, x,
                                  lcs[pi][r], cfg, spec, window, cspecs[pi])
                outs[pi].append(cn)
        new_caches.append(tuple(_restack(o) for o in outs))
    return _logits(params, x, cfg), new_caches


def greedy(logits: torch.Tensor, cfg: ModelConfig | None = None
           ) -> torch.Tensor:
    """``jnp.argmax(logits, -1)`` as int32: the first index of the
    largest value; on a mesh (``cfg`` given) over the whole row of
    vocab-sharded logits."""
    block = _constrain_logits(cfg) if cfg is not None else None
    if block:
        return mesh_ops.vocab_argmax(logits, block[1]).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
