"""StarCoder2 15B [arXiv:2402.19173] — dense, GQA (4 KV heads), RoPE,
LayerNorm + GELU (starcoder2 uses layernorm and gelu_pytorch_tanh)."""

from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab=49152,
        rope_theta=100000.0,
        norm="layernorm",
        activation="gelu",
        norm_eps=1e-5,
        source="arXiv:2402.19173",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        norm="layernorm",
        activation="gelu",
        norm_eps=1e-5,
        source="arXiv:2402.19173",
    )
