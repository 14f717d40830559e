"""Gemma 2 27B [arXiv:2408.00118] — dense, local+global alternating
attention, logit soft-capping, GQA."""

from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36864,
        vocab=256000,
        head_dim=128,
        rope_theta=10000.0,
        sliding_window=4096,        # local layers
        local_global_pattern=2,     # every 2nd layer global, rest local
        attn_softcap=50.0,
        final_softcap=30.0,
        attn_logit_scale=0.0625,    # gemma2: 1/sqrt(query_pre_attn_scalar=256)
        norm="rmsnorm",
        activation="gelu",
        tie_embeddings=True,
        post_attn_norm=True,
        source="arXiv:2408.00118",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        head_dim=32,
        sliding_window=16,
        local_global_pattern=2,
        attn_softcap=50.0,
        final_softcap=30.0,
        norm="rmsnorm",
        activation="gelu",
        tie_embeddings=True,
        post_attn_norm=True,
        source="arXiv:2408.00118",
    )
