from . import backward, kernel
from .kernel import flash_attention
from .ops import FlashAttention, mha_flash
from .ref import flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref

__all__ = ["FlashAttention", "backward", "flash_attention", "flash_attention_bwd_ref",
           "flash_attention_lse_ref", "flash_attention_ref", "kernel", "mha_flash"]
