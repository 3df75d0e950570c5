"""Gemma2-2B: alternating local(4096)/global attention, logit softcaps,
GeGLU, sandwich norms, tied embeddings [arXiv:2408.00118]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        pattern=("local", "global"),
        n_groups=13,  # 26 layers
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        ffn_kind="geglu",
        tie_embeddings=True,
        emb_scale=True,
    )
