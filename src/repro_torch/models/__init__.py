from .transformer import (
    Transformer,
    decode_step,
    encode_memory,
    forward,
    init_cache,
    init_model,
    prefill,
)

__all__ = [
    "Transformer",
    "decode_step",
    "encode_memory",
    "forward",
    "init_cache",
    "init_model",
    "prefill",
]
