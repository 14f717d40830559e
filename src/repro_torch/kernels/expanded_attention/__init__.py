from . import backward, kernel
from .kernel import expanded_attention
from .ops import ExpandedAttention
from .ref import expanded_attention_bwd_ref, expanded_attention_ref

__all__ = ["ExpandedAttention", "backward", "expanded_attention", "expanded_attention_bwd_ref",
           "expanded_attention_ref", "kernel"]
