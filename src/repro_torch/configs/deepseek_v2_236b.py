"""DeepSeek-V2 236B [arXiv:2405.04434] — MoE with multi-head latent attention
(MLA, kv_lora_rank=512), 2 shared + 160 routed experts, top-6."""

from .base import MLAConfig, MoEConfig, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,              # MLA: KV heads = Q heads post-expansion
        d_ff=0,                      # no dense branch; MoE only (+shared)
        vocab=102400,
        rope_theta=10000.0,
        norm="rmsnorm",
        activation="silu",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_ff_expert=1536,
            num_shared_experts=2,
            d_ff_shared=1536,
        ),
        source="arXiv:2405.04434",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=512,
        norm="rmsnorm",
        activation="silu",
        mla=MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=48,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        ),
        moe=MoEConfig(
            num_experts=4, top_k=2, d_ff_expert=64,
            num_shared_experts=1, d_ff_shared=64,
        ),
        source="arXiv:2405.04434",
    )
