"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks (attention-free).

24 layers in the paper's 7:1 mLSTM:sLSTM ratio (position 3 of each
period-8 block is sLSTM), d_model 1024, 4 heads, vocab 50304.  d_ff = 0:
the xLSTM blocks carry their own up/down projections.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PATTERN = tuple(
    LayerSpec(mixer=("slstm" if i == 3 else "mlstm"), ffn="none")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="xlstm-350m",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    segments=((3, _PATTERN),),
    long_window=0,        # recurrent state → long_500k is native
    modality="text",
    source="[arXiv:2405.04517] xLSTM (7:1 mLSTM:sLSTM)",
)
