"""Granite-20B (code) [arXiv:2405.04324].

52 dense llama-arch layers, d_model 6144, 48 heads with MQA (1 KV head),
d_ff 24576, vocab 49152.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    segments=((52, (LayerSpec(mixer="attn", ffn="dense"),)),),
    long_window=8192,
    modality="text",
    source="[arXiv:2405.04324] Granite Code Models (MQA)",
)
