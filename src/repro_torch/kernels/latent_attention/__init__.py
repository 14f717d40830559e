from . import kernel
from .kernel import latent_attention
from .ref import latent_attention_ref

__all__ = ["kernel", "latent_attention", "latent_attention_ref"]
