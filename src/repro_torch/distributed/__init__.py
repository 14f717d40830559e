from .sharding import (
    DEFAULT_RULES,
    LONG_CONTEXT_OVERRIDES,
    constrain,
    gather_fsdp,
    local_shape,
    logical_to_pspec,
    parse_axes,
    placements_for,
    pspec,
    tree_shardings,
    use_sharding_ctx,
)

__all__ = [
    "DEFAULT_RULES", "LONG_CONTEXT_OVERRIDES", "constrain", "gather_fsdp",
    "local_shape", "logical_to_pspec", "parse_axes", "placements_for", "pspec",
    "tree_shardings", "use_sharding_ctx",
]
