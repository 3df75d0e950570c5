"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention in
a 2:1 pattern, MQA, tied embeddings [arXiv:2402.19427]."""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        pattern=("rec", "rec", "local"),
        n_groups=8,  # 24 layers ...
        suffix=("rec", "rec"),  # ... + 2 = 26
        window=2048,
        rnn_width=2560,
        conv_width=4,
        ffn_kind="geglu",
        tie_embeddings=True,
        emb_scale=True,
        # The one difference from the JAX package's config, which keeps this
        # False off the TPU because its kernel would run interpreted there.
        # Here the kernel's wrapper runs the plain version for CPU tensors
        # anyway, so the card path runs the kernel by default.
        use_rglru_kernel=True,
    )
