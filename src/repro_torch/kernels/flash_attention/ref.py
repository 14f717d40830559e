"""Plain PyTorch version of the flash attention kernels, forward and backward.

Same signature and layout as :func:`..kernel.flash_attention`: q
``(BH, Sq, hd)``, k/v ``(BH_kv, Skv, hd)``.  It follows the kernels (the TPU
one and the port's) and not the JAX package's oracle on one point: a row
whose every key is masked comes out as 0, where ``flash_attention_ref`` of
the JAX package returns the mean of v; its gradients are 0 too.

The log-sum-exp (LSE) of a row is ``log(sum_j exp(s_j))`` over its unmasked
scores ``s`` (after the scale and the soft-cap), in natural-log units and
float32, laid out ``(BH, Sq)``; a fully masked row's is ``+inf``, so that
``exp(s - lse)`` is 0 there.  The CUDA kernels keep their row statistics in
base-2 units and write this same quantity (``csrc/flash_attention.cu``).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, *, group, scale, softcap, causal, window):
    """The float32 scores ``(BH, Sq, Skv)`` after the scale and the
    soft-cap, masked entries set to -1e30; the mask ``(Sq, Skv)``; and
    ``tanh(x / cap)`` of the soft-capped scores (None without a cap)."""
    Sq, hd = q.shape[1], q.shape[2]
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = k.repeat_interleave(group, dim=0).float()
    s = torch.matmul(q.float(), kk.transpose(1, 2)) * scale
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = th * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    return torch.where(mask, s, NEG_INF), mask, th


def flash_attention_lse_ref(
    q: torch.Tensor,           # (BH, Sq, hd)
    k: torch.Tensor,           # (BH_kv, Skv, hd)
    v: torch.Tensor,
    *,
    group: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The output ``(BH, Sq, hd)`` in q's dtype and the float32 LSE
    ``(BH, Sq)`` (see the module docstring)."""
    s, mask, _ = _scores(q, k, group=group, scale=scale, softcap=softcap,
                         causal=causal, window=window)
    vv = v.repeat_interleave(group, dim=0).float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vv) / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l), math.inf)[..., 0]
    return out, lse


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
    return flash_attention_lse_ref(q, k, v, group=group, scale=scale, softcap=softcap,
                                   causal=causal, window=window)[0]


def flash_attention_bwd_ref(
    q: torch.Tensor,           # (BH, Sq, hd)
    k: torch.Tensor,           # (BH_kv, Skv, hd)
    v: torch.Tensor,
    o: torch.Tensor,           # (BH, Sq, hd): the forward's output
    lse: torch.Tensor,         # (BH, Sq) float32: the forward's LSE
    do: torch.Tensor,          # (BH, Sq, hd): the output's gradient
    *,
    group: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtypes, by the equations the
    backward kernel runs, in float32: ``P = exp(S - LSE)`` (0 where
    masked), ``D = rowsum(dO * O)``, ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P * (dP - D)``, times ``1 - tanh^2(x / cap)`` under a soft-cap
    and the scale, ``dQ = dS K``, ``dK = dS^T Q``; dk and dv summed over
    each kv head's ``group`` q heads."""
    hd = q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s, mask, th = _scores(q, k, group=group, scale=scale, softcap=softcap,
                          causal=causal, window=window)
    p = torch.exp(s - lse.float()[..., None]) * mask
    dof = do.float()
    vv = v.repeat_interleave(group, dim=0).float()
    kk = k.repeat_interleave(group, dim=0).float()
    D = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(1, 2), dof)
    dp = torch.matmul(dof, vv.transpose(1, 2))
    ds = p * (dp - D)
    if softcap:
        ds = ds * (1.0 - th * th)
    ds = ds * scale
    dq = torch.matmul(ds, kk)
    dk = torch.matmul(ds.transpose(1, 2), q.float())

    def per_kv_head(t):
        return t.reshape(k.shape[0], group, *t.shape[1:]).sum(dim=1)

    return dq.to(q.dtype), per_kv_head(dk).to(k.dtype), per_kv_head(dv).to(v.dtype)
