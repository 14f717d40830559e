"""Zamba2 2.7B [arXiv:2411.15242] — hybrid: Mamba2 backbone with a *shared*
attention block applied periodically (weight-shared across applications)."""

from .base import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        rope_theta=10000.0,
        norm="rmsnorm",
        activation="gelu",
        ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64),
        hybrid_attn_every=6,         # shared attn+MLP block every 6 mamba layers
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        norm="rmsnorm",
        activation="gelu",
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=32),
        hybrid_attn_every=2,
        source="arXiv:2411.15242",
    )
