from . import kernel, ops
from .kernel import decode_attention, decode_attention_partials
from .ops import combine, over_stack
from .ref import decode_attention_partials_ref, decode_attention_ref

__all__ = ["combine", "decode_attention", "decode_attention_partials",
           "decode_attention_partials_ref", "decode_attention_ref", "kernel", "ops", "over_stack"]
