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
activation dtype.  The sharding hints stand where JAX has them.  JAX
computes MLA in jnp outside any Pallas kernel.  The absorbed form's
attention, from the scores to the context in latent space, runs on the
port's B6 (``kernels.latent_attention``), which reads the latent cache in
its own dtype and keeps the scores on chip; the expanded form's attention
(qk 192 wide, the rope key shared by the heads, v 128: outside B1's
contract) runs on B7 (``kernels.expanded_attention``), forward and
backward, with no scores in memory.
Unlike JAX, which returns a new cache, :func:`mla_attention` writes the new
latents into the cache **in place** (a captured CUDA graph replays against
fixed addresses).
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, Optional

import torch

from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed import constrain, gather_fsdp, on_local_shards, replicate_like
from repro_torch.kernels.expanded_attention import expanded_attention
from repro_torch.kernels.latent_attention import latent_attention

from .layers import HEADS, ROWS, Shape, _merge, _rms_scaled, apply_rope, write_rows


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
        cq = x @ gather_fsdp(p["w_dq"], "fsdp", "lora", group="attn")
        q = torch.einsum("bsr,rnh->bsnh", cq, p["w_uq"])
    else:
        q = torch.einsum("bsd,dnh->bsnh", x,
                         gather_fsdp(p["w_q"], "fsdp", "heads", "_", group="attn"))
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = x @ gather_fsdp(p["w_dkv"], "fsdp", "lora", group="attn")
    c_kv, k_rope = ckv_full.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = _rms_scaled(c_kv, p["kv_norm_scale"]).to(x.dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def absorbed_attention(p: Mapping, q_nope, q_rope, ckv, krope, cfg, *,
                       positions: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """Attention of the queries against latents ``ckv`` (B,T,lora) and
    ``krope`` (B,T,rope): key t of slot b is visible to the query at
    ``positions[b, s]`` when ``t <= positions[b, s]`` and ``t < kv_len[b]``.
    Returns ``(B, S, D)``; on DTensors the attention runs on each device's
    rows and heads."""
    args = (q_nope, q_rope, ckv, krope, p["w_uk"], p["w_uv"], positions, kv_len)
    core = functools.partial(_absorbed_core, scale=_scale(cfg))
    if isinstance(q_nope, DTensor):
        lora_heads = {"heads": 1}
        out = on_local_shards(core, q_nope, HEADS, list(zip(args, (
            HEADS, HEADS, ROWS, ROWS, lora_heads, lora_heads, ROWS, ROWS))), [HEADS])
    else:
        out = core(*args)
    return _project_out(p, out)


def _project_out(p: Mapping, out: torch.Tensor, *, merged: bool = False) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd", out, w_o)``; with the heads sharded, or
    with ``merged``, one product over the merged (heads, v_head_dim), heads
    outer, as dense attention's output projection: DTensor (torch 2.11)
    cannot flatten the heads after another sharded dimension as the einsum
    does, and the expanded form's contiguous ``out`` gets its gradient back
    contiguous, which B7's backward reads in place (the einsum's comes back
    with the heads innermost)."""
    w_o = gather_fsdp(p["w_o"], "heads", "_", "fsdp", group="attn")
    if merged or (isinstance(out, DTensor) and Shard(2) in out.placements):
        return _merge(out) @ _merge(w_o, first=True)
    return torch.einsum("bsnh,nhd->bsd", out, w_o)


def _absorbed_core(q_nope, q_rope, ckv, krope, w_uk, w_uv, positions, kv_len, *, scale):
    """The absorbed form's attention: (B, S, heads, v_head_dim).  W_uk folds
    into the query; B6 attends in latent space (the scores, the mask, the
    softmax and the context over ``ckv``); W_uv expands the context."""
    q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, w_uk)
    ctx_lat = latent_attention(q_lat, q_rope, ckv, krope, positions, kv_len, scale=scale)
    return torch.einsum("bsnr,rnh->bsnh", ctx_lat, w_uv)


def _expanded_core(q_nope, q_rope, k_nope, k_rope, v, q_pos, *, scale):
    """The expanded form's causal attention: (B, S, heads, v_head_dim), on
    B7 (the scores, the mask ``q_pos[s] >= t``, the softmax and the context
    over v; its backward when an input needs a gradient)."""
    return expanded_attention(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale=scale)


def mla_prefill(p: Mapping, x: torch.Tensor, cfg, *, positions: torch.Tensor):
    """The prompt pass into an empty cache: the absorbed form against the
    prompt's own latents, which is what the JAX engine computes through
    ``decode_step`` on a ``pos = 0`` sub-cache (every entry past the prompt
    is masked there).  Returns ``(y, (c_kv, k_rope))`` for the caller to
    write into the cache."""
    q_nope, q_rope, c_kv, k_rope = _project_latents(p, x, cfg, positions)
    B, S = x.shape[:2]
    kv_len = replicate_like(torch.full((B,), S, dtype=positions.dtype, device=x.device),
                            positions)
    y = absorbed_attention(p, q_nope, q_rope, c_kv, k_rope, cfg, positions=positions,
                           kv_len=kv_len)
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
    q_nope = constrain(q_nope, "batch", "seq", "heads", "_")

    if cache is None:
        # standard (expanded) form; on DTensors on each device's rows and heads
        k_nope = torch.einsum("btr,rnh->btnh", c_kv, p["w_uk"])
        v = torch.einsum("btr,rnh->btnh", c_kv, p["w_uv"])
        args = (q_nope, q_rope, k_nope, k_rope, v, positions[0])
        core = functools.partial(_expanded_core, scale=_scale(cfg))
        if isinstance(q_nope, DTensor):
            out = on_local_shards(core, q_nope, HEADS, list(zip(args, (
                HEADS, HEADS, HEADS, ROWS, HEADS, {}))), [HEADS])
        else:
            out = core(*args)
        y = _project_out(p, out, merged=True)
        return y, (c_kv, k_rope)

    pos = cache["pos"]
    T = cache["ckv"].shape[1]
    start = pos.clamp(0, T - S)
    if isinstance(start, DTensor):
        for name, new in (("ckv", c_kv), ("krope", k_rope)):
            write_rows(cache[name], new, start, 0, 1)
    else:
        rows = (torch.arange(B, device=pos.device)[:, None] * T + start[:, None]
                + torch.arange(S, device=pos.device)[None, :]).reshape(-1)
        for name, new in (("ckv", c_kv), ("krope", k_rope)):
            c = cache[name]
            c.view(B * T, -1).index_copy_(0, rows, new.to(c.dtype).reshape(B * S, -1))
    y = absorbed_attention(p, q_nope, q_rope, cache["ckv"], cache["krope"], cfg,
                           positions=positions, kv_len=pos + S)
    return y, (c_kv, k_rope)
