"""Plain PyTorch version of expanded attention (B7), forward and backward.

Multi-head latent attention's expanded form (DeepSeek-V2), the form that
training and ``forward`` run: ``models/mla.py``'s expanded core as it was
before B7, the JAX package's ``src/repro/models/mla.py:90-103``.  Logits
``(q_nope . k_nope + q_rope . k_rope) * scale`` in float32, the rope key
``(B, T, rope)`` shared by every head; key t is visible to the query at
``q_pos[s]`` when ``q_pos[s] >= t``; masked logits are ``NEG_INF`` (-1e30,
finite, as in JAX, so a row whose every key is masked comes out as the mean
of v); a float32 softmax, the probabilities rounded to v's dtype, and their
product with v.  The forward also gives each row's float32 log-sum-exp
``(B, N, S)`` of the masked logits, as the kernel writes it for its
backward.  Runs on plain tensors on any device, the meta device included.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def expanded_logits(q_nope, q_rope, k_nope, k_rope, *, scale):
    """``(q_nope . k_nope + q_rope . k_rope) * scale``, ``(B, N, S, T)``
    float32."""
    return (
        torch.einsum("bsnh,btnh->bnst", q_nope.float(), k_nope.float())
        + torch.einsum("bsnh,bth->bnst", q_rope.float(), k_rope.float())
    ) * scale


def expanded_mask(q_pos, T):
    """``(S, T)``: key t is visible to the query at ``q_pos[s]`` when
    ``q_pos[s] >= t``."""
    return q_pos[:, None] >= torch.arange(T, device=q_pos.device)[None, :]


def expanded_attention_ref(q_nope, q_rope, k_nope, k_rope, v, q_pos, *, scale):
    """``(o, lse)``: the context ``(B, S, N, dv)`` in v's dtype and the rows'
    float32 log-sum-exp ``(B, N, S)``.  ``q_nope`` ``(B, S, N, nope)``,
    ``q_rope`` ``(B, S, N, rope)``, ``k_nope`` ``(B, T, N, nope)``,
    ``k_rope`` ``(B, T, rope)``, ``v`` ``(B, T, N, dv)``, ``q_pos``
    ``(S,)``."""
    logits = expanded_logits(q_nope, q_rope, k_nope, k_rope, scale=scale)
    masked = torch.where(expanded_mask(q_pos, k_nope.shape[1]), logits, NEG_INF)
    probs = torch.softmax(masked, dim=-1)
    o = torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype), v)
    return o, torch.logsumexp(masked, dim=-1)


def expanded_attention_bwd_ref(q_nope, q_rope, k_nope, k_rope, v, o, lse, do, q_pos, *, scale):
    """``(dq_nope, dq_rope, dk_nope, dk_rope, dv)`` in the inputs' dtypes,
    by the equations the backward kernel runs, in float32: ``P`` the
    softmax of the masked logits (uniform on a row whose every key is
    masked), ``D = rowsum(dO * O)``, ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P * (dP - D) * scale`` where visible and 0 where not (the fill is
    a constant), ``dQ = dS K``, ``dK = dS^T Q``, ``dk_rope`` summed over the
    heads.  ``lse`` is taken because the kernel reads it; P comes from the
    logits here, since a fully masked row's LSE (-1e30 + log T) rounds to
    -1e30."""
    del lse
    T = k_nope.shape[1]
    logits = expanded_logits(q_nope, q_rope, k_nope, k_rope, scale=scale)
    mask = expanded_mask(q_pos, T)
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    dof = do.float()
    D = torch.einsum("bsnh,bsnh->bns", dof, o.float())[..., None]
    dv = torch.einsum("bnst,bsnh->btnh", p, dof)
    dp = torch.einsum("bsnh,btnh->bnst", dof, v.float())
    ds = torch.where(mask, p * (dp - D), 0.0) * scale
    dq_nope = torch.einsum("bnst,btnh->bsnh", ds, k_nope.float())
    dq_rope = torch.einsum("bnst,bth->bsnh", ds, k_rope.float())
    dk_nope = torch.einsum("bnst,bsnh->btnh", ds, q_nope.float())
    dk_rope = torch.einsum("bnst,bsnh->bth", ds, q_rope.float())
    return (dq_nope.to(q_nope.dtype), dq_rope.to(q_rope.dtype), dk_nope.to(k_nope.dtype),
            dk_rope.to(k_rope.dtype), dv.to(v.dtype))
