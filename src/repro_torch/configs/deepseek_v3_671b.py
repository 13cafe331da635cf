"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437].

61 layers: first 3 dense (d_ff 18432), remaining 58 MoE with 1 shared +
256 routed experts (top-8, d_expert 2048).  MLA attention: q_lora 1536,
kv_lora 512, 128 heads with d_nope 128 + d_rope 64, d_v 128.
d_model 7168, vocab 129280.

The assignment lists d_ff=2048 — that is the MoE expert hidden size; the
three dense layers use DeepSeek's published 18432.  MTP (multi-token
prediction) is exposed as ``mtp_depth`` in the train driver (an extra
shifted-label head), not part of the backbone config.
"""
from repro_torch.models.config import (LayerSpec, MLAConfig, MoEConfig,
                                 ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,      # MLA: per-head KV reconstructed from the latent
    d_ff=18432,          # dense layers (first 3)
    vocab=129280,
    segments=(
        (3, (LayerSpec(mixer="attn", ffn="dense"),)),
        (58, (LayerSpec(mixer="attn", ffn="moe"),)),
    ),
    attn_kind="mla",
    mla=MLAConfig(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  sharding="ep"),
    long_window=0,       # MLA latent cache (576 B-equiv/token) → 500k native
    modality="text",
    source="[arXiv:2412.19437] DeepSeek-V3 (MLA, 1 shared + 256 routed)",
)
