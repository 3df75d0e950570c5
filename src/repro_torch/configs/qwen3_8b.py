"""Qwen3-8B: dense GQA decoder with per-head qk-norm [hf:Qwen/Qwen3-8B]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab=151936,
        pattern=("attn",),
        n_groups=36,
        qk_norm=True,
        rope_theta=1_000_000.0,
        ffn_kind="swiglu",
    )
