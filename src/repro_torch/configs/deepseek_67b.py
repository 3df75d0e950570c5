"""DeepSeek-67B: 95-layer dense llama-arch GQA decoder [arXiv:2401.02954]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab=102400,
        pattern=("attn",),
        n_groups=95,
        rope_theta=10_000.0,
        ffn_kind="swiglu",
    )
