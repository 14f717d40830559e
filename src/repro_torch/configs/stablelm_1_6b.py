"""StableLM 2 1.6B [hf:stabilityai/stablelm-2-1_6b] — dense, full MHA
(kv=heads), partial-RoPE, LayerNorm."""

from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100352,
        rope_theta=10000.0,
        norm="layernorm",
        activation="silu",
        norm_eps=1e-5,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        norm="layernorm",
        activation="silu",
        norm_eps=1e-5,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
