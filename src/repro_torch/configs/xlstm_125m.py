"""xLSTM 125M [arXiv:2405.04517] — sLSTM + mLSTM blocks (d_ff=0: the blocks
carry their own up/down projections)."""

from .base import ModelConfig, XLSTMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        norm="layernorm",
        activation="gelu",
        # xLSTM[7:1] style — sLSTM at a sparse subset, mLSTM elsewhere
        xlstm=XLSTMConfig(slstm_at=(3, 7, 11), proj_factor=2.0),
        source="arXiv:2405.04517",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=512,
        norm="layernorm",
        activation="gelu",
        xlstm=XLSTMConfig(slstm_at=(1,), proj_factor=2.0),
        source="arXiv:2405.04517",
    )
