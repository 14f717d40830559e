"""Model configuration system + architecture registry.

Every assigned architecture gets one module in this package defining
``full_config()`` (the exact published configuration, used only via the
dry-run — ShapeDtypeStruct, no allocation) and ``smoke_config()`` (a reduced
same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts — runnable on CPU).

Select with ``--arch <id>`` in the launchers; ``repro_torch.configs.get(name)``.
This is a copy of the JAX package's ``configs/base.py``: the dataclasses and
the registry are verbatim; the port runs every family.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # 0 => no dense/shared branch
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 => full-rank Q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD block."""
    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: alternating sLSTM / mLSTM blocks."""
    slstm_at: tuple[int, ...] = ()   # layer indices using sLSTM (rest mLSTM)
    proj_factor: float = 2.0
    mlstm_chunk: int = 64            # chunked-parallel mLSTM chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads
    # positional / attention details
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 => full attention
    local_global_pattern: int = 0   # gemma2: every k-th layer global, rest local
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_logit_scale: float = 0.0   # 0 => 1/sqrt(head_dim)
    # norm / activation / embeddings
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    activation: str = "silu"        # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    post_attn_norm: bool = False    # gemma2-style extra norms
    qk_norm: bool = False
    # sub-family configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): SSM backbone with a shared attention block applied
    # every `hybrid_attn_every` layers
    hybrid_attn_every: int = 0
    # enc-dec (seamless)
    n_enc_layers: int = 0
    # modality frontends (stubs per spec: embeddings arrive precomputed)
    vision_tokens: int = 0          # llava: image patch tokens per sample
    vision_dim: int = 0             # ViT feature dim feeding the projector
    audio_frames_ratio: int = 0     # seamless: src frames = seq_len // ratio
    audio_dim: int = 0              # frontend feature dim
    # numerics / memory
    dtype: str = "bfloat16"
    remat: bool = False             # checkpoint each layer body (training)
    remat_policy: str = "full"      # full | dots (save matmul outputs)
    # unroll layer scans when lowering (roofline runs: XLA cost_analysis
    # counts while-loop bodies once, so unrolled HLO gives true totals)
    scan_unroll: bool = False
    source: str = ""                # citation

    @property
    def layer_unroll(self) -> int:
        return self.n_layers if self.scan_unroll else 1

    @property
    def enc_unroll(self) -> int:
        return self.n_enc_layers if self.scan_unroll else 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so it shards cleanly."""
        return (self.vocab + 255) // 256 * 256

    @property
    def param_count(self) -> float:
        """Analytic parameter count of THIS implementation (roofline N)."""
        d, h = self.d_model, self.resolved_head_dim
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid":
            # Mamba2 backbone + ONE weight-shared attention+FFN block
            s = self.ssm
            d_inner = s.expand * d
            n_h = d_inner // s.head_dim
            per_mamba = (
                d * (2 * d_inner + 2 * s.state_dim + n_h)      # w_in
                + s.conv_width * (d_inner + 2 * s.state_dim)   # conv
                + d_inner * d                                  # w_out
            )
            attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h + self.n_heads * h * d
            shared = attn + 3 * d * self.d_ff
            return emb + self.n_layers * per_mamba + shared
        if self.family == "ssm" and self.xlstm is not None:
            du = int(d * self.xlstm.proj_factor)
            n_h = self.n_heads
            per_mlstm = d * 2 * du + du * 3 * du + du * 2 * n_h + du * d
            per_slstm = 2 * (d * 4 * d) + d * d
            n_s = len(self.xlstm.slstm_at)
            return emb + n_s * per_slstm + (self.n_layers - n_s) * per_mlstm
        if self.mla is not None:
            m = self.mla
            attn = d * (m.kv_lora_rank + m.qk_rope_head_dim)
            attn += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn += d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            attn += self.n_heads * m.v_head_dim * d
        else:
            attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h + self.n_heads * h * d
        if self.moe is not None:
            ff = 3 * d * self.moe.d_ff_expert * self.moe.num_experts
            ff += 3 * d * self.moe.d_ff_shared * self.moe.num_shared_experts
            ff += d * self.moe.num_experts  # router
        elif self.d_ff:
            ff = 3 * d * self.d_ff
        else:
            ff = 0
        per_layer = attn + ff
        n_l = self.n_layers + self.n_enc_layers
        return emb + n_l * per_layer

    @property
    def active_param_count(self) -> float:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count
        d = self.d_model
        full_ff = 3 * d * self.moe.d_ff_expert * self.moe.num_experts
        act_ff = 3 * d * self.moe.d_ff_expert * self.moe.top_k
        return self.param_count - self.n_layers * (full_ff - act_ff)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ARCHS = (
    "gemma2_27b",
    "phi4_mini_3_8b",
    "arctic_480b",
    "llava_next_34b",
    "starcoder2_15b",
    "zamba2_2_7b",
    "deepseek_v2_236b",
    "xlstm_125m",
    "stablelm_1_6b",
    "seamless_m4t_medium",
)

# canonical ids used on the CLI (--arch) — hyphens as in the assignment
ARCH_IDS = {
    "gemma2-27b": "gemma2_27b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "arctic-480b": "arctic_480b",
    "llava-next-34b": "llava_next_34b",
    "starcoder2-15b": "starcoder2_15b",
    "zamba2-2.7b": "zamba2_2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "xlstm-125m": "xlstm_125m",
    "stablelm-1.6b": "stablelm_1_6b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def _module(name: str):
    mod = ARCH_IDS.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str, *, smoke: bool = False) -> ModelConfig:
    m = _module(name)
    return m.smoke_config() if smoke else m.full_config()


def all_archs() -> list[str]:
    return list(ARCH_IDS)
