"""Yi-6B [arXiv:2403.04652] — llama-arch GQA.

32 dense layers, d_model 4096, 32 heads / 4 KV heads, d_ff 11008,
vocab 64000.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    segments=((32, (LayerSpec(mixer="attn", ffn="dense"),)),),
    long_window=8192,
    modality="text",
    source="[arXiv:2403.04652] Yi (GQA)",
)
