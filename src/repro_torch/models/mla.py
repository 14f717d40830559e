"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Counterpart of the JAX package's ``models/mla.py``.  Queries and
keys/values are projected through low-rank latents; only the compressed KV
latent (``kv_lora_rank``) and one shared RoPE key (``qk_rope_head_dim``)
are cached.  Two forms, as in JAX:

* **expanded** (no cache): K and V are expanded from the latent per token;
* **absorbed** (against the latent cache, and in the engine's prompt pass,
  :func:`mla_prefill`): W_uk is folded into the query, so attention runs
  on the latents and W_uv expands the context after.

Both take the logits in float32 and cast the probabilities back to the
activation dtype.  JAX computes MLA in jnp outside any Pallas kernel, and
its head dims (qk 192, v 128) are outside B1's contract, so it stays plain
PyTorch here.  Unlike JAX, which returns a new cache, :func:`mla_attention`
writes the new latents into the cache **in place** (a captured CUDA graph
replays against fixed addresses).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from .layers import NEG_INF, Shape, _rms, apply_rope


def mla_shapes(cfg) -> dict[str, Shape]:
    """Leaf name → shape and logical axes of one layer's MLA parameters, as
    ``init_mla`` makes them in JAX (``kv_norm_scale`` is float32, the rest
    the model's dtype)."""
    m, d, nh = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        shapes = {"w_dq": Shape((d, m.q_lora_rank), "fsdp lora"),
                  "w_uq": Shape((m.q_lora_rank, nh, qk), "lora heads head_dim")}
    else:
        shapes = {"w_q": Shape((d, nh, qk), "fsdp heads head_dim")}
    shapes.update({
        "w_dkv": Shape((d, m.kv_lora_rank + m.qk_rope_head_dim), "fsdp lora"),
        "w_uk": Shape((m.kv_lora_rank, nh, m.qk_nope_head_dim), "lora heads head_dim"),
        "w_uv": Shape((m.kv_lora_rank, nh, m.v_head_dim), "lora heads head_dim"),
        "w_o": Shape((nh, m.v_head_dim, d), "heads head_dim fsdp"),
        "kv_norm_scale": Shape((m.kv_lora_rank,), "_"),
    })
    return shapes


def _project_latents(p: Mapping, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Common front: query heads and (latent, shared rope key)."""
    m = cfg.mla
    if "w_dq" in p:
        q = torch.einsum("bsr,rnh->bsnh", x @ p["w_dq"], p["w_uq"])
    else:
        q = torch.einsum("bsd,dnh->bsnh", x, p["w_q"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = (x @ p["w_dkv"]).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = (_rms(c_kv) * p["kv_norm_scale"]).to(x.dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def absorbed_attention(p: Mapping, q_nope, q_rope, ckv, krope, cfg, *,
                       positions: torch.Tensor, kv_len: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Attention of the queries against latents ``ckv`` (B,T,lora) and
    ``krope`` (B,T,rope): key t of slot b is visible to the query at
    ``positions[b, s]`` when ``t <= positions[b, s]`` and ``t < kv_len[b]``.
    Returns ``(B, S, D)``."""
    q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, p["w_uk"])
    logits = (
        torch.einsum("bsnr,btr->bnst", q_lat.float(), ckv.float())
        + torch.einsum("bsnh,bth->bnst", q_rope.float(), krope.float())
    ) * _scale(cfg)
    t = torch.arange(ckv.shape[1], device=ckv.device)
    mask = ((t[None, None, :] <= positions[..., None])
            & (t[None, None, :] < kv_len[:, None, None]))[:, None]     # (B,1,S,T)
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1).to(dtype)
    # attend in latent space, then expand through W_uv
    ctx_lat = torch.einsum("bnst,btr->bsnr", probs, ckv)
    out = torch.einsum("bsnr,rnh->bsnh", ctx_lat, p["w_uv"])
    return torch.einsum("bsnh,nhd->bsd", out, p["w_o"])


def mla_prefill(p: Mapping, x: torch.Tensor, cfg, *, positions: torch.Tensor):
    """The prompt pass into an empty cache: the absorbed form against the
    prompt's own latents, which is what the JAX engine computes through
    ``decode_step`` on a ``pos = 0`` sub-cache (every entry past the prompt
    is masked there).  Returns ``(y, (c_kv, k_rope))`` for the caller to
    write into the cache."""
    q_nope, q_rope, c_kv, k_rope = _project_latents(p, x, cfg, positions)
    B, S = x.shape[:2]
    kv_len = torch.full((B,), S, dtype=positions.dtype, device=x.device)
    y = absorbed_attention(p, q_nope, q_rope, c_kv, k_rope, cfg, positions=positions,
                           kv_len=kv_len, dtype=x.dtype)
    return y, (c_kv, k_rope)


def mla_attention(
    p: Mapping,
    x: torch.Tensor,                    # (B, S, D)
    cfg,
    *,
    positions: torch.Tensor,            # (B, S)
    cache: Optional[dict] = None,       # {"ckv": (B,T,lora), "krope": (B,T,rope), "pos": (B,)}
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``(y, (c_kv, k_rope))``: the output and this call's new
    latents.  With ``cache`` the new latents are first written into it at
    each slot's ``pos`` (in place; the start is clamped into the cache as
    ``dynamic_update_slice`` clamps it), then the queries attend against the
    cache in the absorbed form."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _project_latents(p, x, cfg, positions)

    if cache is None:
        # standard (expanded) form
        k_nope = torch.einsum("btr,rnh->btnh", c_kv, p["w_uk"])
        v = torch.einsum("btr,rnh->btnh", c_kv, p["w_uv"])
        logits = (
            torch.einsum("bsnh,btnh->bnst", q_nope.float(), k_nope.float())
            + torch.einsum("bsnh,bth->bnst", q_rope.float(), k_rope.float())
        ) * _scale(cfg)
        q_pos = positions[0]
        mask = q_pos[:, None] >= torch.arange(S, device=x.device)[None, :]
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out = torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype), v)
        return torch.einsum("bsnh,nhd->bsd", out, p["w_o"]), (c_kv, k_rope)

    pos = cache["pos"]
    T = cache["ckv"].shape[1]
    start = pos.clamp(0, T - S)
    rows = (torch.arange(B, device=pos.device)[:, None] * T + start[:, None]
            + torch.arange(S, device=pos.device)[None, :]).reshape(-1)
    for name, new in (("ckv", c_kv), ("krope", k_rope)):
        c = cache[name]
        c.view(B * T, -1).index_copy_(0, rows, new.to(c.dtype).reshape(B * S, -1))
    y = absorbed_attention(p, q_nope, q_rope, cache["ckv"], cache["krope"], cfg,
                           positions=positions, kv_len=pos + S, dtype=x.dtype)
    return y, (c_kv, k_rope)
