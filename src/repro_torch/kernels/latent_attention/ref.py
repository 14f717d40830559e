"""Plain PyTorch version of latent attention (B6).

Multi-head latent attention's absorbed form (DeepSeek-V2) against the
latent cache, from the scores to the context in latent space: the body of
``models/mla.py``'s absorbed core as it was before B6, the JAX package's
``src/repro/models/mla.py:114-127``.  Logits
``(q_lat . ckv + q_rope . krope) * scale`` in float32; key t is visible to
the query at ``positions[b, s]`` when ``t <= positions[b, s]`` and
``t < kv_len[b]``; masked logits are ``NEG_INF`` (-1e30, finite, as in JAX,
so a row whose every key is masked comes out as the mean of the latents);
a float32 softmax, the probabilities rounded to the activation dtype, and
their product with ``ckv``.  Runs on plain tensors on any device.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def latent_logits(q_lat, q_rope, ckv, krope, *, scale):
    """``(q_lat . ckv + q_rope . krope) * scale``, ``(B, N, S, T)`` float32."""
    return (
        torch.einsum("bsnr,btr->bnst", q_lat.float(), ckv.float())
        + torch.einsum("bsnh,bth->bnst", q_rope.float(), krope.float())
    ) * scale


def latent_mask(positions, kv_len, T):
    """``(B, 1, S, T)``: key t is visible to the query at ``positions[b,
    s]`` (``(B, S)``) when ``t <= positions[b, s]`` and ``t < kv_len[b]``."""
    t = torch.arange(T, device=positions.device)
    return ((t[None, None, :] <= positions[..., None])
            & (t[None, None, :] < kv_len[:, None, None]))[:, None]


def latent_attention_ref(q_lat, q_rope, ckv, krope, positions, kv_len, *, scale):
    """``ctx_lat`` ``(B, S, N, R)`` in q_lat's dtype.  ``q_lat`` ``(B, S, N,
    R)``, ``q_rope`` ``(B, S, N, Rr)``, ``ckv`` ``(B, T, R)``, ``krope``
    ``(B, T, Rr)``; ``positions`` ``(B, S)`` or ``(S,)``, ``kv_len``
    ``(B,)`` or 0-d."""
    B, S = q_lat.shape[:2]
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(B)
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    logits = latent_logits(q_lat, q_rope, ckv, krope, scale=scale)
    mask = latent_mask(positions, kv_len, ckv.shape[1])
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1).to(q_lat.dtype)
    return torch.einsum("bnst,btr->bsnr", probs, ckv)
