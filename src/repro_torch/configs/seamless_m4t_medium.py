"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder, multimodal.
The speech frontend (mel + conformer feature extractor) is a STUB per spec:
``input_specs`` supplies precomputed frame embeddings; we implement the
transformer encoder + decoder (self-attn, cross-attn)."""

from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,                  # decoder layers
        n_enc_layers=12,              # encoder layers
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        rope_theta=10000.0,
        norm="layernorm",
        activation="gelu",
        norm_eps=1e-5,
        audio_frames_ratio=4,         # src frames = seq_len // 4
        audio_dim=1024,
        source="arXiv:2308.11596",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="audio",
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        norm="layernorm",
        activation="gelu",
        norm_eps=1e-5,
        audio_frames_ratio=4,
        audio_dim=64,
        source="arXiv:2308.11596",
    )
