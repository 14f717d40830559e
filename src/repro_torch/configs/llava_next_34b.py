"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-mistral-7b-hf] — VLM: anyres tiled
vision frontend (STUB per spec — precomputed patch embeddings) + projector
MLP + 34B language backbone (Yi-34B geometry)."""

from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        rope_theta=5000000.0,
        norm="rmsnorm",
        activation="silu",
        # anyres tiling: base 576 patches + 4 tiles x 576 = 2880 image tokens
        vision_tokens=2880,
        vision_dim=1024,             # CLIP/SigLIP-large feature width
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        norm="rmsnorm",
        activation="silu",
        vision_tokens=8,
        vision_dim=64,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
