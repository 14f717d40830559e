"""Model-layout flash attention.

Takes model-layout tensors ``(B, S, heads, head_dim)`` and picks by the
tensors' device: CUDA tensors go to the Hopper kernel, which reads them
through their strides as they come (no layout copy for the layouts the
model makes; see :func:`.kernel.prepare`) and writes a contiguous
``(B, Sq, heads, head_dim)`` output, so the model's ``reshape(B, S,
heads * head_dim)`` is a view; it raises on what it cannot run.  CPU
tensors go to the plain PyTorch version in its ``(B·heads, S, head_dim)``
layout.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_ref


def mha_flash(
    q: torch.Tensor,           # (B, Sq, NH, hd)
    k: torch.Tensor,           # (B, Skv, NKV, hd)
    v: torch.Tensor,
    *,
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, Sq, NH, hd = q.shape
    NKV = k.shape[2]
    kw = dict(group=NH // NKV, scale=scale, softcap=softcap, causal=causal, window=window)
    if q.device.type != "cpu":
        return kernel.attention(q, k, v, **kw)
    out = flash_attention_ref(
        q.transpose(1, 2).reshape(B * NH, Sq, hd),
        k.transpose(1, 2).reshape(B * NKV, k.shape[1], hd),
        v.transpose(1, 2).reshape(B * NKV, v.shape[1], hd), **kw)
    return out.reshape(B, NH, Sq, hd).transpose(1, 2)
