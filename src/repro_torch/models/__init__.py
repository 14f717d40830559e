from .transformer import (
    Transformer,
    abstract_model,
    cache_axes,
    decode_step,
    encode_memory,
    forward,
    init_cache,
    init_model,
    layer_period,
    param_axes,
    prefill,
)

__all__ = [
    "Transformer",
    "abstract_model",
    "cache_axes",
    "decode_step",
    "encode_memory",
    "forward",
    "init_cache",
    "init_model",
    "layer_period",
    "param_axes",
    "prefill",
]
