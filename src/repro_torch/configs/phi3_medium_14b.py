"""Phi-3-Medium-14B [arXiv:2404.14219] — RoPE + SwiGLU + GQA.

40 dense layers, d_model 5120, 40 heads / 10 KV heads, d_ff 17920,
vocab 100352.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    segments=((40, (LayerSpec(mixer="attn", ffn="dense"),)),),
    long_window=8192,
    modality="text",
    source="[arXiv:2404.14219] Phi-3 (RoPE SwiGLU GQA)",
)
