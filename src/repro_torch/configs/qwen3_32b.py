"""Qwen3-32B [hf:Qwen/Qwen3-8B family card, scaled per assignment].

64 dense layers, d_model 5120, 64 heads / 8 KV heads (GQA) with qk-norm,
d_ff 25600, vocab 151936.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    segments=((64, (LayerSpec(mixer="attn", ffn="dense"),)),),
    head_dim=128,
    qk_norm=True,
    long_window=8192,    # long_500k runs the sliding-window serve variant
    modality="text",
    source="[hf:Qwen/Qwen3-8B] qk_norm GQA",
)
