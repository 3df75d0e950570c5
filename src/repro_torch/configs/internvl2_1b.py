"""InternVL2-1B backbone: InternLM2-style decoder with a visual-prefix stub
(InternViT frontend provides precomputed patch embeddings) [arXiv:2404.16821]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151655,
        pattern=("attn",),
        n_groups=24,
        rope_theta=1_000_000.0,
        ffn_kind="swiglu",
        frontend="vision",
        vis_len=1024,
    )
