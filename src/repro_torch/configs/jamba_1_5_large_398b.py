"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887, 2408.12570].

72 layers, 1:7 attention:Mamba interleave (one attention layer per 8),
MoE (16 experts, top-2) on every other layer.  d_model 8192, 64 query
heads with 8 KV heads (GQA), d_ff 24576, vocab 65536.
"""
from repro_torch.models.config import (LayerSpec, MambaConfig, MoEConfig,
                                 ModelConfig)

_M = "mamba"
_A = "attn"
# period-8 pattern: attn at position 4 (Jamba places it mid-block);
# MoE on even positions within the period (every other layer).
_PATTERN = tuple(
    LayerSpec(mixer=(_A if i == 4 else _M),
              ffn=("moe" if i % 2 == 0 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    segments=((9, _PATTERN),),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, n_shared=0,
                  sharding="ep"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    window=0,            # full attention in train; hybrid → long_500k native
    long_window=8192,    # attention layers use SWA in the 500k serve variant
    modality="text",
    source="[arXiv:2403.19887] Jamba; [arXiv:2408.12570] Jamba-1.5",
)
