from . import kernel
from .kernel import flash_attention
from .ops import mha_flash
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "kernel", "mha_flash"]
