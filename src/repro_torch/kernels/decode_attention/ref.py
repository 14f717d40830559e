"""Plain PyTorch version of decode attention (B3).

One decode step's grouped-query attention over a KV cache, in the model
layout: q ``(B, S, NH, hd)``, the cache ``(B, T, NKV, hd)``, the step's own
keys and values ``(B, S, NKV, hd)``.  Two forms:

* with ``k_new``/``v_new`` it is the JAX package's ``_sdpa_deferred``: the
  cache keys ``t < kv_valid[b]`` and the step's own keys, at positions
  ``kv_valid[b] + j``, softmaxed together (the caller appends the new keys
  after the layer loop);
* without them it is the cache form of ``_sdpa``: the cache already holds
  the step's keys, and ``kv_valid = pos + S`` of them are valid.

Both mask by causality on ``positions[b, s]`` (the cache form only with
``causal``; the deferred form is always causal, as in JAX), by the window
(``t > positions - window``) and by ``kv_valid``, soft-cap the scores and
set masked scores to ``NEG_INF``.  A row whose every key is masked comes out
as the mean of v over every position, as the JAX package's softmax of
``NEG_INF`` scores gives it; the kernel writes 0 there (no decode path makes
such a row: the step's token always sees itself).

The scores are float32 products of the operands upcast to float32 (the
JAX package multiplies them in their own dtype with float32 accumulation,
the same numbers: products of two bf16 values are exact in float32); the
probabilities are rounded to v's dtype before the product with v, as in
JAX.  Runs on plain tensors on any device.

:func:`decode_attention_partials_ref` is the plain version of the partials
form, for a cache split over positions: one shard, whose row t holds key
position ``t_start + t``, gives each row's float32 output normalized over
the keys of this shard and the log-sum-exp of their scores, the same masks
read in global positions.  ``ops.combine`` weighs the shards' partials
into the output over the whole cache.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def decode_attention_ref(q, k_cache, v_cache, k_new=None, v_new=None, *, positions,
                         kv_valid, scale, softcap=0.0, window=None, causal=True):
    """``(B, S, NH, hd)`` in q's dtype.  ``positions``: ``(B, S)`` or
    ``(S,)``; ``kv_valid``: ``(B,)`` or 0-d, the valid cache entries (with
    a new part, also its write offset); ``window`` None for none."""
    B, S, NH, H = q.shape
    T, NKV = k_cache.shape[1], k_cache.shape[2]
    G = NH // NKV
    dev = q.device
    if kv_valid.dim() == 0:
        kv_valid = kv_valid.expand(B)
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    qg = q.reshape(B, S, NKV, G, H).float()
    t = torch.arange(T, device=dev)

    if k_new is None:
        # the cache form of _sdpa: kv_pos = arange(T)
        logits = torch.einsum("bsngh,btnh->bngst", qg, k_cache.float())
        logits = _softcap(logits * scale, softcap)
        kp, qp = t[None, None, :], positions[..., :, None]
        if causal:
            mask = kp <= qp
        else:
            mask = torch.ones((B, S, T), dtype=torch.bool, device=dev)
        if window is not None:
            mask = mask & (kp > qp - window)
        mask = mask & (kp < kv_valid[:, None, None])
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bngst,btnh->bsngh", probs.to(v_cache.dtype), v_cache)
        return out.reshape(B, S, NH, H)

    # part 1: existing cache
    s1 = torch.einsum("bsngh,btnh->bngst", qg, k_cache.float()) * scale
    s1 = _softcap(s1, softcap)
    m1 = t[None, None, :] < kv_valid[:, None, None]              # (B,1,T)
    m1 = m1 & (t[None, None, :] <= positions[..., None])
    if window is not None:
        m1 = m1 & (t[None, None, :] > positions[..., None] - window)
    s1 = torch.where(m1[:, None, None], s1, NEG_INF)

    # part 2: the new tokens (causal among themselves)
    s2 = torch.einsum("bsngh,btnh->bngst", qg, k_new.float()) * scale
    s2 = _softcap(s2, softcap)
    new_pos = kv_valid[:, None] + torch.arange(S, device=dev)[None, :]
    m2 = new_pos[:, None, :] <= positions[..., None]             # (B,S,S)
    if window is not None:
        m2 = m2 & (new_pos[:, None, :] > positions[..., None] - window)
    s2 = torch.where(m2[:, None, None], s2, NEG_INF)

    probs = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    p1, p2 = probs[..., :T], probs[..., T:]
    out = torch.einsum("bngst,btnh->bsngh", p1.to(v_cache.dtype), v_cache)
    out = out + torch.einsum("bngst,btnh->bsngh", p2.to(v_new.dtype), v_new)
    return out.reshape(B, S, NH, H)


def decode_attention_partials_ref(q, k_cache, v_cache, k_new=None, v_new=None, *, positions,
                                  kv_valid, t_start, scale, softcap=0.0, window=None,
                                  causal=True):
    """``(out, lse)`` of one shard of the cache: ``out`` ``(B, S, NH, hd)``
    float32, each row's attention over the keys it sees in this shard (the
    cache rows ``t`` at positions ``t_start + t`` below ``kv_valid`` and,
    with ``k_new``/``v_new``, the step's own keys at ``kv_valid + j``),
    ``lse`` ``(B, S, NH)`` float32, the log-sum-exp of those scores.  A
    row that sees no key here comes out as the mean of v over the shard's
    positions with ``lse`` about ``NEG_INF``, as JAX's softmax of
    ``NEG_INF`` scores gives it; ``ops.combine`` weighs such a shard by 0,
    or, where no shard sees a key, by its positions.  The probabilities are
    rounded to v's dtype before the product with v, which sums in float32."""
    B, S, NH, H = q.shape
    T, NKV = k_cache.shape[1], k_cache.shape[2]
    G = NH // NKV
    dev = q.device
    if kv_valid.dim() == 0:
        kv_valid = kv_valid.expand(B)
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    qg = q.reshape(B, S, NKV, G, H).float()
    kp = (torch.arange(T, device=dev) + t_start)[None, None, :]     # (1, 1, T)
    qp = positions[..., None]                                       # (B, S, 1)
    s = _softcap(torch.einsum("bsngh,btnh->bngst", qg, k_cache.float()) * scale, softcap)
    mask = kp < kv_valid[:, None, None]
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    scores, values = [torch.where(mask[:, None, None], s, NEG_INF)], [v_cache]
    if k_new is not None:
        s2 = _softcap(torch.einsum("bsngh,btnh->bngst", qg, k_new.float()) * scale, softcap)
        new_pos = (kv_valid[:, None] + torch.arange(S, device=dev)[None, :])[:, None, :]
        m2 = new_pos <= qp                                          # (B, S, S)
        if window is not None:
            m2 = m2 & (new_pos > qp - window)
        scores.append(torch.where(m2[:, None, None], s2, NEG_INF))
        values.append(v_new)
    scores = torch.cat(scores, dim=-1)                              # (B, NKV, G, S, T [+ S])
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bngst,btnh->bsngh", probs, torch.cat(values, dim=1).float())
    return out.reshape(B, S, NH, H), lse.permute(0, 3, 1, 2).reshape(B, S, NH)
