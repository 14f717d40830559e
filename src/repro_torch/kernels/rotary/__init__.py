from . import kernel
from .kernel import rotary
from .ops import Rotary, apply_rope
from .ref import rope_freqs, rope_tables, rotary_ref

__all__ = ["Rotary", "apply_rope", "kernel", "rope_freqs", "rope_tables", "rotary", "rotary_ref"]
