"""Model-layout flash attention.

Takes model-layout tensors ``(B, S, heads, head_dim)``, flattens them to the
kernel's ``(B·heads, S, head_dim)`` layout and picks by the tensors' device:
CUDA tensors go to the Hopper kernel (which raises on what it cannot run),
CPU tensors go to the plain PyTorch version.  The transposes are copies;
passing strides to the kernel is later work.
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
    group = NH // NKV
    # reshape alone may return a strided view (B == 1): the kernel takes
    # contiguous rows only
    qf = q.transpose(1, 2).reshape(B * NH, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * NKV, k.shape[1], hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * NKV, v.shape[1], hd).contiguous()
    fn = flash_attention_ref if q.device.type == "cpu" else kernel.flash_attention
    out = fn(qf, kf, vf, group=group, scale=scale, softcap=softcap,
             causal=causal, window=window)
    return out.reshape(B, NH, Sq, hd).transpose(1, 2)
