"""Shared layers of the port: plain functions on tensors.

Counterparts of the JAX package's ``models/layers.py``, with the same names
and the same numerics, traps included: RMSNorm scales by ``(1 + scale)``,
LayerNorm uses the population variance, norms compute in float32, RoPE
rotates split halves over the full head_dim, gemma2 scales embeddings by
sqrt(d).  Parameters arrive as mappings of tensors (the ``Group``s
of :class:`repro_torch.models.transformer.Transformer`).  The sharding
hints stand where the JAX version has them (``constrain``,
``gather_fsdp``): no-ops on plain tensors and outside a sharding context,
they lay DTensors out by their logical axes in sharded execution.  RMSNorm
and RoPE run on the port's kernels B8 and B9, attention on B1 and B3.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import (all_reduce_over, constrain, constrain_split, gather_fsdp,
                                     hold_layout, on_local_shards, shard_group,
                                     shard_offset)
from repro_torch.kernels.decode_attention import (combine, decode_attention,
                                                  decode_attention_partials)
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.kernels.rms_norm import rms_norm
from repro_torch.kernels.rotary import apply_rope, rope_freqs  # noqa: F401

Params = Mapping[str, torch.Tensor]
NEG_INF = -1e30
# the named dimensions of a (B, S, heads, head_dim) tensor, and of one with
# rows only, for attention cores run on each device's shards
HEADS = {"batch": 0, "heads": 2}
ROWS = {"batch": 0}
# ... and of a (B, T, kv heads, head_dim) cache whose positions are sharded
POSITIONS = {"batch": 0, "kv_seq": 1, "heads": 2}


def _keys_whole(k: torch.Tensor) -> bool:
    """``k`` (B, T, ...) is a DTensor whose key positions every device
    holds whole: its attention can run on each device's rows and heads."""
    return isinstance(k, DTensor) and Shard(1) not in k.placements


class Shape(tuple):
    """A parameter's shape with its logical axes: ``axes`` names one axis,
    or ``_`` for none, per dimension (see
    :func:`repro_torch.distributed.parse_axes`), as the JAX package's
    ``init_*`` functions pair each leaf with its axes string.  The shape
    helpers of the model families return these, so each leaf's shape and
    axes stand in one place."""

    axes: str

    def __new__(cls, dims, axes: str):
        self = super().__new__(cls, dims)
        if len(axes.split()) != len(self):
            raise ValueError(f"axes {axes!r} do not match the shape {tuple(self)}")
        self.axes = axes
        return self


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """LayerNorm (with ``bias``) on torch ops, or RMSNorm by ``(1 +
    scale)`` on B8 (:mod:`repro_torch.kernels.rms_norm`), in float32,
    rounded to x's dtype."""
    if "bias" not in p:  # rmsnorm
        return rms_norm(x, p["scale"], eps=cfg.norm_eps, offset=1.0)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

# apply_rope(x (B, S, heads, head_dim), positions (B, S), theta) and its
# rope_freqs are B9's (repro_torch.kernels.rotary), imported above


# ---------------------------------------------------------------------------
# soft capping (gemma2)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------

def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def apply_ffn(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    w_gate = gather_fsdp(p["w_gate"], "fsdp", "mlp", group="ffn")
    w_up = gather_fsdp(p["w_up"], "fsdp", "mlp", group="ffn")
    w_down = gather_fsdp(p["w_down"], "mlp", "fsdp", group="ffn")
    h = _act(x @ w_gate, cfg.activation) * (x @ w_up)
    h = constrain(h, "batch", "seq", "mlp")
    return h @ w_down


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def _lookup(ids: torch.Tensor, rows: torch.Tensor, start: int) -> torch.Tensor:
    """The rows ``start..start + len(rows)`` of a table hold for ``ids``;
    zeros for an id outside them."""
    local = ids - start
    hit = (local >= 0) & (local < rows.shape[0])
    return F.embedding(local.clamp(0, rows.shape[0] - 1), rows) * hit[..., None].to(rows.dtype)


def _embed_on_shards(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The embedding of a vocab-sharded DTensor table: every device looks
    up every id (gathered: they are small) in the rows it holds, a partial
    sum over the vocab axes; a table sharded on d_model gives its columns.
    (DTensor's own masked partial sum has no gradient back through a
    redistribution.)"""
    mesh = table.device_mesh
    ids = tokens.redistribute(mesh, [Replicate()] * mesh.ndim)
    out = [Partial() if p == Shard(0) else Shard(2) if isinstance(p, Shard) else Replicate()
           for p in table.placements]
    start = shard_offset(table, 0)
    lookup = local_map(functools.partial(_lookup, start=start), out_placements=out,
                       in_placements=(ids.placements, table.placements), device_mesh=mesh)
    return lookup(ids, table)


def embed_tokens(p: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    table = p["tok"]
    if isinstance(table, DTensor) and any(isinstance(q, Shard) and q.dim == 0
                                          for q in table.placements):
        x = _embed_on_shards(tokens, table)
    else:
        x = F.embedding(tokens, table)
    # the partial sum of a vocab-sharded table is reduced here, where JAX
    # leaves the layout to the partitioner
    x = constrain(x, "batch", "seq", "embed")
    if cfg.name.startswith("gemma2"):
        # the factor is rounded to the activation dtype first, as in JAX
        # (jnp.asarray(sqrt(d), x.dtype)); computed on the host, so a CUDA
        # graph captures no host-to-device copy
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def unembed(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = (x @ w.to(x.dtype)).float()
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# attention (GQA, sliding window, softcap) with optional KV cache
# ---------------------------------------------------------------------------

def attention(
    p: Params,
    x: torch.Tensor,                  # (B, S, D)
    cfg,
    *,
    positions: torch.Tensor,          # (B, S)
    layer_window: Optional[int] = None,
    cache: Optional[dict] = None,     # {"k","v"}: (B, S_max, nkv, hd); "pos": (B,)
    causal: bool = True,
    update_cache: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``(y, (k, v))``: the output and this call's new keys/values.

    With no cache (full-sequence forward, and prefill into an empty cache)
    the attention is the flash kernel: on the same tokens from position 0
    it computes what the JAX package's ``_sdpa`` (and ``_sdpa_deferred``
    against an empty cache) computes; ``causal=False`` is the encoder's
    bidirectional attention.  With a cache it is decode attention (B3,
    :func:`_decode_attention`): with ``update_cache=False`` the deferred
    two-part attention, and the caller appends the new keys/values for all
    layers at once; with ``update_cache=True`` (hybrid and audio decode)
    each slot's new keys/values are written into ``cache["k"]`` /
    ``cache["v"]`` at its own ``pos`` **in place** (JAX returns a new
    cache), then the tokens attend over the updated cache with
    ``kv_valid = pos + S`` (the cache form of JAX's ``_sdpa``);
    ``cache["pos"]`` is left to the caller."""
    S = x.shape[1]
    h = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    scale = cfg.attn_logit_scale or (1.0 / math.sqrt(h))

    wq = gather_fsdp(p["wq"], "fsdp", "heads", "_", group="attn")
    wk = gather_fsdp(p["wk"], "fsdp", "kv_heads", "_", group="attn")
    wv = gather_fsdp(p["wv"], "fsdp", "kv_heads", "_", group="attn")
    wo = gather_fsdp(p["wo"], "heads", "_", "fsdp", group="attn")
    q = _split_heads(x @ _merge(wq), nh, h, "heads")
    k = _split_heads(x @ _merge(wk), nkv, h, "kv_heads")
    v = _split_heads(x @ _merge(wv), nkv, h, "kv_heads")
    if cfg.qk_norm:
        q = _rms_scaled(q, p["q_norm"]).to(x.dtype)
        k = _rms_scaled(k, p["k_norm"]).to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "heads", "_")
    k = constrain(k, "batch", "seq", "kv_heads", "_")
    # JAX leaves v to the partitioner; B1's shards need it placed as k
    v = constrain(v, "batch", "seq", "kv_heads", "_")
    q = _grouped(q, k)

    if cache is None:
        out = mha_flash(
            q, k, v, scale=scale, softcap=cfg.attn_softcap, causal=causal,
            window=layer_window or 0,
        )
    elif not update_cache:
        out = _decode_attention(
            q, cache["k"], cache["v"], k, v,
            scale=scale,
            softcap_val=cfg.attn_softcap,
            positions=positions,
            window=layer_window,
            kv_valid=cache["pos"],
        )
    else:
        pos = cache["pos"]
        write_kv(cache["k"], cache["v"], k, v, pos)
        out = _decode_attention(
            q, cache["k"], cache["v"], None, None,
            scale=scale,
            softcap_val=cfg.attn_softcap,
            positions=positions,
            window=layer_window,
            kv_valid=pos + S,
            causal=causal,
        )
    y = _merge(out) @ _merge(wo, first=True)
    return y, (k, v)


def _merge(t: torch.Tensor, first: bool = False) -> torch.Tensor:
    """``(..., heads, head_dim)`` → ``(..., heads·head_dim)`` (``first``:
    the two leading dimensions of ``(heads, head_dim, D)``), a view that
    keeps a heads-sharded tensor sharded, its gradient laid out as it is
    (:func:`repro_torch.distributed.hold_layout`) before the view back."""
    shape = (t.shape[0] * t.shape[1], *t.shape[2:]) if first else (*t.shape[:-2], -1)
    return hold_layout(t.reshape(shape))


def _grouped(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q laid out as k: each device keeps whole GQA groups, its q heads over
    its kv heads, so where the kv heads do not shard (4 over 16 devices)
    the q heads are gathered too.  Plain tensors pass through."""
    if isinstance(q, DTensor) and q.placements != k.placements:
        return q.redistribute(k.device_mesh, k.placements)
    return q


def _split_heads(t: torch.Tensor, n: int, h: int, axis: str) -> torch.Tensor:
    """(B, S, n·h) → (B, S, n, h), laid out by ``(batch, seq, axis, _)``
    first, so that the split never cuts a shard (24 heads do not split
    over 16 devices)."""
    shape = (*t.shape[:-1], n, h)
    return constrain_split(t, shape, "batch", "seq", axis, "_").reshape(shape)


def _rms_scaled(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """JAX's ``(_rms(x) * scale).astype(x.dtype)`` on B8: the qk-norm and
    MLA's ``kv_norm``."""
    return rms_norm(x, scale, eps=eps, offset=0.0)


def _decode_attention(q, k_cache, v_cache, k_new, v_new, *, scale, softcap_val, positions,
                      window, kv_valid, causal=True):
    """One decode step's attention over a cache, B3
    (:mod:`repro_torch.kernels.decode_attention`): with ``k_new``/``v_new``
    the JAX package's ``_sdpa_deferred`` (the read-only cache and the new
    tokens softmaxed together), else the cache form of its ``_sdpa`` (the
    cache already written, ``kv_valid = pos + S``).  q ``(B, S, NH, H)``,
    the cache ``(B, T, NKV, H)``, the new keys ``(B, S, NKV, H)``,
    ``kv_valid`` ``(B,)`` or 0-d.  Plain tensors go to B3's wrapper: on the
    card the kernel reads the cache in its own dtype into float32 scores,
    as JAX's ``preferred_element_type`` dots do; on the CPU and the meta
    device its plain version.  DTensors holding every key position run it
    on each device's rows and heads (DTensor would flatten the sharded
    batch and heads together); DTensors sharded over positions (the
    long-context rules) run :func:`_decode_on_position_shards`."""
    kw = dict(scale=scale, softcap=softcap_val, window=window, causal=causal)
    if _keys_whole(k_cache):
        def local(q, k_cache, v_cache, k_new, v_new, positions, kv_valid):
            return _decode_attention(q, k_cache, v_cache, k_new, v_new, scale=scale,
                                     softcap_val=softcap_val, positions=positions,
                                     window=window, kv_valid=kv_valid, causal=causal)

        return on_local_shards(local, q, HEADS, [
            (q, HEADS), (k_cache, HEADS), (v_cache, HEADS), (k_new, HEADS), (v_new, HEADS),
            (positions, ROWS if positions.dim() > 1 else {}),
            (kv_valid, ROWS if kv_valid.dim() else {})], [HEADS])
    if isinstance(k_cache, DTensor):
        return _decode_on_position_shards(q, k_cache, v_cache, k_new, v_new, positions=positions,
                                          kv_valid=kv_valid, **kw)
    return decode_attention(q, k_cache, v_cache, k_new, v_new, positions=positions,
                            kv_valid=kv_valid, **kw)


def _decode_on_position_shards(q, k_cache, v_cache, k_new, v_new, *, positions, kv_valid,
                               **kw):
    """Decode attention over a cache DTensor sharded over positions (the
    long-context rules shard ``kv_seq``, as XLA partitions JAX's ``_sdpa``
    and ``_sdpa_deferred``): each device runs B3's partials form on its
    rows, heads and positions, its shard's first position
    (:func:`repro_torch.distributed.shard_offset`) as ``t_start``; the
    step's own keys count on the position axis's first coordinate alone;
    then :func:`repro_torch.kernels.decode_attention.combine` weighs the
    partials with one max and one sum all-reduce over the devices that
    split the positions.  On the card the kernel, on the CPU and the meta
    device its plain version: the same branch, and no device gathers the
    cache or the scores."""
    t_start, S = shard_offset(k_cache, 1), q.shape[1]
    group = shard_group(k_cache, 1)
    reduce = all_reduce_over((group,) if group else ())

    def local(q, k_cache, v_cache, k_new, v_new, positions, kv_valid):
        if t_start:
            k_new = v_new = None
        out, lse = decode_attention_partials(q, k_cache, v_cache, k_new, v_new,
                                             positions=positions, kv_valid=kv_valid,
                                             t_start=t_start, **kw)
        count = k_cache.shape[1] + (0 if k_new is None else S)
        return combine(out, lse, count, reduce, dtype=q.dtype)

    return on_local_shards(local, k_cache, POSITIONS, [
        (q, HEADS), (k_cache, POSITIONS), (v_cache, POSITIONS), (k_new, HEADS), (v_new, HEADS),
        (positions, ROWS if positions.dim() > 1 else {}),
        (kv_valid, ROWS if kv_valid.dim() else {})], [HEADS])


def _slot_rows(B: int, T: int, S_new: int, pos: torch.Tensor) -> torch.Tensor:
    """Rows ``b * T + start[b] + s`` of a ``(B, T, ...)`` cache viewed as
    ``(B * T, ...)``: slot b's ``S_new`` new entries.  As in
    ``jax.lax.dynamic_update_slice``, each start is clamped so the write
    stays inside the cache (an idle slot's offset keeps counting up)."""
    start = pos.clamp(0, T - S_new)
    return (torch.arange(B, device=pos.device)[:, None] * T + start[:, None]
            + torch.arange(S_new, device=pos.device)[None, :]).reshape(-1)


def _masked_write(c, u, start, t_start: int, b_dim: int, t_dim: int):
    """``c``'s positions ``start[b] + s`` along ``t_dim`` take ``u``'s
    ``s``-th rows (``start``: (B,), or 0-d for every slot), in place, where
    ``c`` holds the positions from ``t_start`` on (a shard of them).  It
    reads and writes ``S_new`` rows a slot, no more: the rows from the local
    offset clamped into the shard, each keeping its old value where its
    position lies outside the new rows (a write that falls partly or wholly
    in another shard), in one indexed write."""
    cm, um = c.movedim((b_dim, t_dim), (0, 1)), u.movedim((b_dim, t_dim), (0, 1))
    B, T, S = cm.shape[0], cm.shape[1], um.shape[1]
    n = min(S, T)
    local = start.reshape(-1, 1) - t_start                      # (B or 1, 1)
    rows = (local.clamp(0, T - n) + torch.arange(n, device=c.device)).expand(B, n)
    j = rows - local                                            # the row of u each takes
    hit = ((j >= 0) & (j < S)).reshape((B, n) + (1,) * (cm.dim() - 2))
    b = torch.arange(B, device=c.device)[:, None]
    cm[b, rows] = torch.where(hit, um[b, j.clamp(0, S - 1)].to(c.dtype), cm[b, rows])
    return c


def write_rows(c, u, start, b_dim: int, t_dim: int) -> None:
    """A cache write on DTensors, in place: each device writes the rows of
    its shard, its batch rows and (under the long-context rules) its key
    positions, at the clamped starts ``start`` (DTensor has no rule for
    ``index_copy_``)."""
    axes = {"batch": b_dim, "seq": t_dim}
    if c.dim() > t_dim + 1:
        axes["heads"] = t_dim + 1
    rows = {k: v for k, v in axes.items() if k != "seq"}
    write = functools.partial(_masked_write, t_start=shard_offset(c, t_dim), b_dim=b_dim,
                              t_dim=t_dim)
    on_local_shards(write, c, axes, [(c, axes), (u, rows), (start, ROWS if start.dim() else {})],
                    [axes])


def write_kv(cache_k, cache_v, new_k, new_v, pos):
    """One layer's cache update, **in place**: cache_k/v (B,T,nkv,hd),
    new_k/v (B,S_new,nkv,hd), each slot written at its own ``pos`` (B,),
    clamped as JAX's ``dynamic_update_slice`` is."""
    if isinstance(cache_k, DTensor):
        for c, u in ((cache_k, new_k), (cache_v, new_v)):
            write_rows(c, u, pos.clamp(0, c.shape[1] - u.shape[1]), 0, 1)
        return
    B, T = cache_k.shape[:2]
    S_new = new_k.shape[1]
    rest = tuple(cache_k.shape[2:])
    rows = _slot_rows(B, T, S_new, pos)
    for c, u in ((cache_k, new_k), (cache_v, new_v)):
        c.view((B * T,) + rest).index_copy_(0, rows, u.to(c.dtype).reshape((B * S_new,) + rest))


def append_kv(cache_k, cache_v, new_k, new_v, pos):
    """One batched cache append for ALL layers, **in place**.

    cache_k/v: (L,B,T,nkv,hd); new_k/v: (L,B,S_new,nkv,hd); pos: (B,).
    The JAX version returns new arrays; here the cache keeps its storage,
    because a captured CUDA graph replays against fixed addresses.  Starts
    are clamped as in :func:`write_kv`.
    """
    if isinstance(cache_k, DTensor):
        for c, u in ((cache_k, new_k), (cache_v, new_v)):
            write_rows(c, u, pos.clamp(0, c.shape[2] - u.shape[2]), 1, 2)
        return cache_k, cache_v
    L, B, T = cache_k.shape[:3]
    S_new = new_k.shape[2]
    rest = tuple(cache_k.shape[3:])
    rows = _slot_rows(B, T, S_new, pos)
    for c, u in ((cache_k, new_k), (cache_v, new_v)):
        c.view((L, B * T) + rest).index_copy_(
            1, rows, u.to(c.dtype).reshape((L, B * S_new) + rest))
    return cache_k, cache_v


def append_kv_synced(cache_k, cache_v, new_k, new_v, pos):
    """The synchronized batch decode's cache append, **in place**: all
    layers and slots written at the one offset ``pos`` (0-d), as JAX's
    single ``dynamic_update_slice`` at ``(0, 0, pos, 0, 0)``, start clamped
    as there.  cache_k/v: (L,B,T,nkv,hd); new_k/v: (L,B,S_new,nkv,hd).
    One ``index_copy_`` each, at an offset read on the device."""
    T, S_new = cache_k.shape[2], new_k.shape[2]
    if isinstance(cache_k, DTensor):
        for c, u in ((cache_k, new_k), (cache_v, new_v)):
            write_rows(c, u, pos.clamp(0, T - S_new), 1, 2)
        return cache_k, cache_v
    rows = pos.clamp(0, T - S_new) + torch.arange(S_new, device=pos.device)
    for c, u in ((cache_k, new_k), (cache_v, new_v)):
        c.index_copy_(2, rows, u.to(c.dtype))
    return cache_k, cache_v


def cross_attention(p: Params, x: torch.Tensor, memory: torch.Tensor, cfg) -> torch.Tensor:
    """Encoder-decoder cross attention: queries from x (B, S, D), keys and
    values from memory (B, T, D), no RoPE on the cross keys, every query
    over every key (not causal).  On the flash kernel with Sq = S and
    Skv = T (one query row in decode); its plain version on the CPU."""
    h = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    scale = cfg.attn_logit_scale or (1.0 / math.sqrt(h))
    wq = gather_fsdp(p["wq"], "fsdp", "heads", "_", group="attn")
    wk = gather_fsdp(p["wk"], "fsdp", "kv_heads", "_", group="attn")
    wv = gather_fsdp(p["wv"], "fsdp", "kv_heads", "_", group="attn")
    wo = gather_fsdp(p["wo"], "heads", "_", "fsdp", group="attn")
    q = _split_heads(x @ _merge(wq), nh, h, "heads")
    k = _split_heads(memory @ _merge(wk), nkv, h, "kv_heads")
    v = _split_heads(memory @ _merge(wv), nkv, h, "kv_heads")
    out = mha_flash(_grouped(q, k), k, v, scale=scale, causal=False)
    return _merge(out) @ _merge(wo, first=True)
