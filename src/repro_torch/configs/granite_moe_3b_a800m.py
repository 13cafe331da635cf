"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0 family].

32 layers, d_model 1536, 24 heads / 8 KV heads, MoE with 40 experts
top-8 (per assignment; the 3.0-1b model card lists 32 — we follow the
assignment) and d_expert 512, vocab 49155.

40 experts do not divide the 16-way model axis → this config uses
tensor-parallel expert sharding (``sharding="tp"``: the d_expert
dimension shards instead of the expert axis; see sharding/rules.py).
"""
from repro_torch.models.config import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    segments=((32, (LayerSpec(mixer="attn", ffn="moe"),)),),
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, n_shared=0,
                  sharding="tp"),
    long_window=8192,
    modality="text",
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base] scaled per assignment",
)
