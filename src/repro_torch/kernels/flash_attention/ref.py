"""Plain PyTorch version of the flash attention kernel.

Same signature and layout as :func:`..kernel.flash_attention`: q
``(BH, Sq, hd)``, k/v ``(BH_kv, Skv, hd)``.  It follows the kernels (the TPU
one and the port's) and not the JAX package's oracle on one point: a row
whose every key is masked comes out as 0, where ``flash_attention_ref`` of
the JAX package returns the mean of v.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,           # (BH, Sq, hd)
    k: torch.Tensor,           # (BH_kv, Skv, hd)
    v: torch.Tensor,
    *,
    group: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    Sq, hd = q.shape[1], q.shape[2]
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = k.repeat_interleave(group, dim=0).float()
    vv = v.repeat_interleave(group, dim=0).float()
    s = torch.matmul(q.float(), kk.transpose(1, 2)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p, vv) / l).to(q.dtype)
