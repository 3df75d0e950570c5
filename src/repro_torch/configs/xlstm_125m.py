"""xLSTM-125M: alternating mLSTM (matrix memory) and sLSTM (scalar memory)
blocks, no separate FFN (d_ff = 0) [arXiv:2405.04517]."""

from repro_torch.models.blocks import XLSTMConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab=50304,
        pattern=("mlstm", "slstm"),
        n_groups=6,  # 12 layers
        xlstm=XLSTMConfig(d_model=768, n_heads=4, expansion=2),
        tie_embeddings=True,
    )
