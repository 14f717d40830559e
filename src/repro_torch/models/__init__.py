from .transformer import (
    DenseTransformer,
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)

__all__ = [
    "DenseTransformer",
    "decode_step",
    "forward",
    "init_cache",
    "init_model",
    "prefill",
]
