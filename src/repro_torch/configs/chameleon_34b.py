"""Chameleon-34B [arXiv:2405.09818] — early-fusion mixed-modal decoder.

48 layers, d_model 8192, 64 heads / 8 KV heads, d_ff 22016, vocab 65536
(text + VQ image tokens in one fused vocabulary).  The VQ-GAN image
tokenizer is a STUB per assignment — ``repro.models.stubs.vq_image_tokens``
supplies in-vocab image-token spans; this config is the early-fusion
transformer that consumes the interleaved stream.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    segments=((48, (LayerSpec(mixer="attn", ffn="dense"),)),),
    qk_norm=True,        # Chameleon uses qk-norm for mixed-modal stability
    long_window=8192,
    modality="vlm",
    source="[arXiv:2405.09818] Chameleon (early fusion, VQ tokens)",
)
