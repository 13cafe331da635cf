"""MusicGen-Large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48 layers, d_model 2048, 32 heads (MHA: kv=32), d_ff 8192, vocab 2048
(EnCodec codebook).  The EnCodec audio frontend is a STUB per assignment —
``repro.models.stubs.audio_tokens`` supplies codec-token streams of the
right shape; this config is the language-model backbone that consumes
them.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    segments=((48, (LayerSpec(mixer="attn", ffn="dense"),)),),
    long_window=8192,
    modality="audio",
    source="[arXiv:2306.05284] MusicGen (EnCodec-token decoder)",
)
