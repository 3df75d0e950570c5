"""Whisper-base backbone: 6L encoder + 6L decoder with cross-attention,
GELU FFN, sinusoidal positions; conv audio frontend is a stub that feeds
precomputed frame embeddings [arXiv:2212.04356]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        enc_pattern=("enc",),
        enc_groups=6,
        pattern=("dec",),
        n_groups=6,
        enc_positions="sinusoidal",
        ffn_kind="gelu",
        frontend="audio",
        tie_embeddings=True,
    )
