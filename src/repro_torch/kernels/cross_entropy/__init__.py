from . import kernel
from .kernel import ce_backward, ce_partials
from .ops import TokenNLL, combine, token_nll
from .ref import ce_backward_ref, ce_partials_ref

__all__ = ["TokenNLL", "ce_backward", "ce_backward_ref", "ce_partials", "ce_partials_ref",
           "combine", "kernel", "token_nll"]
