"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE
hybrid: 128 experts top-2 residual to a dense FFN branch."""

from .base import MoEConfig, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,                   # dense residual branch width
        vocab=32000,
        rope_theta=10000.0,
        norm="rmsnorm",
        activation="silu",
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            d_ff_expert=4864,
            num_shared_experts=0,
            d_ff_shared=0,
        ),
        source="hf:Snowflake/snowflake-arctic-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        norm="rmsnorm",
        activation="silu",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        source="hf:Snowflake/snowflake-arctic-base",
    )
