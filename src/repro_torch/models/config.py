"""Architecture configuration schema for the model substrate.

Counterpart of ``repro/models/config.py``, statement for statement but
for :meth:`ModelConfig.param_count`, which counts the port's ``init``.

Every assigned architecture (`src/repro_torch/configs/<id>.py`) instantiates a
:class:`ModelConfig`.  Layer stacks are described as *segments* —
``(repeat, pattern)`` pairs where ``pattern`` is a tuple of
:class:`LayerSpec`s — so heterogeneous stacks (Jamba's 1:7 attn:Mamba
interleave, DeepSeek's 3 dense + 58 MoE layers, xLSTM's 7:1 mLSTM:sLSTM)
scan over the repeat axis with the pattern unrolled inside, keeping the
lowered HLO small for 512-device dry-runs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mamba", "mlstm", "slstm"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "dense"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    n_shared: int = 0          # always-on shared experts (DeepSeek-V3)
    router_aux_coef: float = 0.01
    sharding: Literal["ep", "tp"] = "ep"   # expert- vs tensor-parallel


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention (arXiv:2412.19437)."""
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 → ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: tuple[tuple[int, tuple[LayerSpec, ...]], ...]
    head_dim: int = 0          # 0 → d_model // n_heads
    qk_norm: bool = False
    attn_kind: Literal["gqa", "mla"] = "gqa"
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    window: int = 0            # 0 → full causal; >0 → sliding window
    long_window: int = 8192    # window used by the long_500k serve variant
    modality: Literal["text", "audio", "vlm"] = "text"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""           # citation for the config

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128 multiple so the embedding/LM head
        always shard over the model axis (§Perf: a non-divisible vocab —
        granite-moe's 49155 — otherwise falls back to a *replicated* head
        and the full (B, T, V) f32 logits get all-gathered+all-reduced:
        measured at 2×206 GB/device/step on train_4k).  Padded logit
        columns are masked to −inf in the loss/argmax."""
        return -(-self.vocab // 128) * 128

    def layer_list(self) -> list[LayerSpec]:
        out: list[LayerSpec] = []
        for repeat, pattern in self.segments:
            out.extend(list(pattern) * repeat)
        assert len(out) == self.n_layers, \
            f"{self.name}: segments give {len(out)} layers, " \
            f"config says {self.n_layers}"
        return out

    def param_count(self) -> int:
        """Exact parameter count (used for 6·N·D model FLOPs): the
        port's ``init`` on the ``meta`` device, which allocates nothing."""
        from repro_torch import random as rnd
        from repro_torch import tree
        from repro_torch.models import transformer
        params = transformer.init(rnd.PRNGKey(0, "meta"), self)
        return sum(x.numel() for x in tree.leaves(params))

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        # subtract the inactive routed experts' weights
        n_moe_layers = sum(1 for s in self.layer_list() if s.ffn == "moe")
        per_expert = 3 * self.d_model * self.moe.d_expert
        inactive = n_moe_layers * (self.moe.n_experts - self.moe.top_k) \
            * per_expert
        return total - inactive


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 128,
            n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """Shrink any architecture to a CPU-smoke-testable variant of the same
    family (same mixer mix, same ffn kinds, ≤4 experts)."""
    layers = cfg.layer_list()
    # keep one period of the pattern, or n_layers plain layers
    pattern = tuple(layers[:n_layers])
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    d_head = d_model // n_heads
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k), d_expert=d_model // 2,
            n_shared=min(1, cfg.moe.n_shared))
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_lora=d_model, kv_lora=d_model // 2,
                        d_nope=d_head, d_rope=d_head // 2, d_v=d_head)
    mamba = cfg.mamba
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=len(pattern),
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_ff=d_model * 2 if cfg.d_ff else 0, vocab=vocab,
        segments=((1, pattern),), head_dim=d_head, mla=mla, moe=moe,
        mamba=mamba, window=min(cfg.window, 64) if cfg.window else 0,
        long_window=64)
