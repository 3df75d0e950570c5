"""InternLM2-1.8B: dense llama-style GQA decoder [arXiv:2403.17297; hf]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=92544,
        pattern=("attn",),
        n_groups=24,
        rope_theta=1_000_000.0,
        ffn_kind="swiglu",
    )
