"""DeepSeek-V2 (236B MoE): MLA attention with compressed KV (kv_lora 512),
2 shared + 160 routed experts top-6, dense first layer [arXiv:2405.04434]."""

from repro_torch.models.blocks import MLAConfig, MoEConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # dense first layer FFN
        vocab=102400,
        prefix=("mla",),
        pattern=("mla_moe",),
        n_groups=59,  # + 1 dense prefix = 60 layers
        mla=MLAConfig(
            d_model=5120,
            n_heads=128,
            q_lora=1536,
            kv_lora=512,
            d_nope=128,
            d_rope=64,
            d_v=128,
        ),
        moe=MoEConfig(
            n_experts=160,
            top_k=6,
            expert_ff=1536,
            n_shared=2,
            shared_ff=3072,
        ),
        ffn_kind="swiglu",
    )
