"""Snowflake Arctic (480B MoE): dense-MoE hybrid — every layer has a dense
FFN residual in parallel with a 128-expert top-2 MoE
[hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.models.blocks import MoEConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab=32000,
        pattern=("moe",),
        n_groups=35,
        moe=MoEConfig(
            n_experts=128,
            top_k=2,
            expert_ff=4864,
            dense_residual=True,
            dense_ff=4864,
        ),
        ffn_kind="swiglu",
    )
