"""Phi-4-mini 3.8B [arXiv:2412.08905] — dense, RoPE, SwiGLU, GQA."""

from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=200064,
        rope_theta=10000.0,
        norm="rmsnorm",
        activation="silu",
        source="arXiv:2412.08905",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke",
        family="dense",
        n_layers=2,
        d_model=192,
        n_heads=6,
        n_kv_heads=2,
        d_ff=384,
        vocab=512,
        norm="rmsnorm",
        activation="silu",
        source="arXiv:2412.08905",
    )
