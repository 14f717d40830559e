"""Dense transformer of the port: one ``nn.Module`` and the functions that
run it.

Counterpart of the dense family of the JAX package's
``models/transformer.py``, with the same API shape::

    model         = init_model(generator, cfg, device="cuda")
    logits, aux   = forward(model, {"tokens": tokens}, cfg)     # full sequence
    logits, kv    = prefill(model, tokens, cfg)                 # empty cache
    cache         = init_cache(cfg, batch_size, max_len, device="cuda")
    logits, cache = decode_step(model, cache, tokens, cfg)      # in place

The JAX package stacks the layers and runs them under ``lax.scan``; here
they are an ``nn.ModuleList`` walked by a Python loop.  Each layer's
parameters are ``ParameterDict``s with the JAX parameter names, so
:mod:`repro_torch.bridge` maps a JAX parameter tree onto the module one
leaf at a time.  The ``moe``, ``vlm``, ``hybrid``, ``ssm`` and ``audio``
families are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import layers as L

FAMILY_TODO = (
    "is not ported yet: only the dense family runs in this slice "
    "(ROADMAP.md, Queue 1 item 5)"
)


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} {FAMILY_TODO}")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _norm(cfg, device) -> nn.ParameterDict:
    d = cfg.d_model
    p = {"scale": _param((d,), torch.float32, device)}
    if cfg.norm == "layernorm":
        p["bias"] = _param((d,), torch.float32, device)
    return nn.ParameterDict(p)


class DenseTransformer(nn.Module):
    """Parameters of a dense decoder, laid out as the JAX parameter tree:
    ``embed`` (``tok``, ``unembed`` unless tied), ``final_norm`` and
    ``layers[i]`` with ``attn`` (``wq``, ``wk``, ``wv``, ``wo``), ``ln1``,
    ``ln2``, ``ffn`` (``w_gate``, ``w_up``, ``w_down``) and, for gemma2,
    ``ln_post_attn`` / ``ln_post_ffn``.  Norm parameters are float32 and
    the rest is ``dtype`` (default ``cfg.dtype``), as in JAX.  The tensors
    are allocated uninitialised; :func:`init_model` or
    :func:`repro_torch.bridge.params_from_jax` fills them."""

    def __init__(self, cfg, *, device="cuda", dtype: Optional[torch.dtype] = None):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        dt = dtype or getattr(torch, cfg.dtype)
        d, h, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        embed = {"tok": _param((cfg.padded_vocab, d), dt, device)}
        if not cfg.tie_embeddings:
            embed["unembed"] = _param((d, cfg.padded_vocab), dt, device)
        self.embed = nn.ParameterDict(embed)
        self.final_norm = _norm(cfg, device)
        blocks = []
        for _ in range(cfg.n_layers):
            block = {
                "attn": nn.ParameterDict({
                    "wq": _param((d, nh, h), dt, device),
                    "wk": _param((d, nkv, h), dt, device),
                    "wv": _param((d, nkv, h), dt, device),
                    "wo": _param((nh, h, d), dt, device),
                }),
                "ln1": _norm(cfg, device),
                "ln2": _norm(cfg, device),
                "ffn": nn.ParameterDict({
                    "w_gate": _param((d, f), dt, device),
                    "w_up": _param((d, f), dt, device),
                    "w_down": _param((f, d), dt, device),
                }),
            }
            if cfg.qk_norm:
                block["attn"]["q_norm"] = _param((h,), torch.float32, device)
                block["attn"]["k_norm"] = _param((h,), torch.float32, device)
            if cfg.post_attn_norm:
                block["ln_post_attn"] = _norm(cfg, device)
                block["ln_post_ffn"] = _norm(cfg, device)
            blocks.append(nn.ModuleDict(block))
        self.layers = nn.ModuleList(blocks)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits ``(B, S, padded_vocab)``."""
        return forward(self, {"tokens": tokens}, self.cfg)[0]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(generator: torch.Generator, cfg, *, device="cuda") -> DenseTransformer:
    """Random weights with the JAX initialiser's distributions, drawn from
    ``generator`` on its own device (pass a CUDA generator to initialise on
    the card).  ``jax.random`` and ``torch.Generator`` give different
    numbers from one seed; parity tests carry the JAX weights through
    :mod:`repro_torch.bridge` instead."""
    model = DenseTransformer(cfg, device=device)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32,
                            device=t.device) * std)

    for name, t in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "tok":
            normal_(t, 0.02)
        elif leaf == "bias":
            t.zero_()
        elif leaf == "scale":
            # layernorm scales start at 1, rmsnorm's (1 + scale) at 0
            t.fill_(1.0 if cfg.norm == "layernorm" else 0.0)
        elif leaf in ("q_norm", "k_norm"):
            t.fill_(1.0)
        else:
            normal_(t, 1.0 / math.sqrt(t.shape[0]))      # fan-in: axis 0
    return model


# ---------------------------------------------------------------------------
# layer block
# ---------------------------------------------------------------------------

def _window_schedule(cfg) -> Optional[list[int]]:
    """Per-layer attention window: gemma2 alternates local / global."""
    if not cfg.local_global_pattern or not cfg.sliding_window:
        return None
    k = cfg.local_global_pattern
    return [2**30 if i % k == k - 1 else cfg.sliding_window for i in range(cfg.n_layers)]


def _attn_ffn_block(lp, x, cfg, *, positions, window, cache=None):
    """Pre-norm transformer block; returns ``(x, (new_k, new_v))``.

    With ``cache`` it attends against it read-only (deferred append)."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    attn_out, new_kv = L.attention(
        lp["attn"], h, cfg, positions=positions, layer_window=window,
        cache=cache, update_cache=False,
    )
    if cfg.post_attn_norm:
        attn_out = L.apply_norm(lp["ln_post_attn"], attn_out, cfg)
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg)
    ffn_out = L.apply_ffn(lp["ffn"], h, cfg)
    if cfg.post_attn_norm:
        ffn_out = L.apply_norm(lp["ln_post_ffn"], ffn_out, cfg)
    return x + ffn_out, new_kv


def _run_layers(p, x, cfg, positions, cache=None):
    """Walk the layer stack; returns ``(x, (k, v))`` with each layer's new
    keys/values stacked on a leading layer axis."""
    ks, vs = [], []
    windows = _window_schedule(cfg) or [None] * cfg.n_layers
    for i, (lp, w) in enumerate(zip(p.layers, windows)):
        lcache = None
        if cache is not None:
            lcache = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
        x, (k, v) = _attn_ffn_block(lp, x, cfg, positions=positions, window=w,
                                    cache=lcache)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


# ---------------------------------------------------------------------------
# forward (full sequence) and prefill into an empty cache
# ---------------------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(p: DenseTransformer, batch: dict, cfg):
    """Full-sequence forward: returns ``(logits, aux)``.  Attention runs
    through the flash kernel (its plain version on the CPU)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(p.embed, tokens, cfg)
    x, _ = _run_layers(p, x, cfg, _positions(*tokens.shape, tokens.device))
    x = L.apply_norm(p.final_norm, x, cfg)
    logits = L.unembed(p.embed, x, cfg)
    return logits, {"aux_loss": torch.zeros((), device=tokens.device)}


def prefill(p: DenseTransformer, tokens: torch.Tensor, cfg):
    """Prompt pass for a slot whose cache is empty.

    What the JAX engine computes with ``decode_step`` on a sub-cache whose
    ``pos`` it has just set to 0: with no valid cache entry the first part
    of ``_sdpa_deferred`` is fully masked, and the rest is causal, windowed,
    soft-capped attention over the new tokens, which is the flash kernel.
    Returns ``(logits (B, P, padded_vocab), (k, v))`` with k/v of shape
    ``(n_layers, B, P, n_kv_heads, head_dim)``; the caller writes them into
    the cache at offset 0."""
    _require_dense(cfg)
    x = L.embed_tokens(p.embed, tokens, cfg)
    x, new_kv = _run_layers(p, x, cfg, _positions(*tokens.shape, tokens.device))
    x = L.apply_norm(p.final_norm, x, cfg)
    return L.unembed(p.embed, x, cfg), new_kv


# ---------------------------------------------------------------------------
# decode: cache init + single step
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda") -> dict:
    """Per-slot KV cache: ``k``/``v`` of shape ``(n_layers, B, max_len,
    n_kv_heads, head_dim)`` in ``cfg.dtype`` and ``pos`` ``(B,)``, every
    batch slot at its own write offset (continuous batching)."""
    _require_dense(cfg)
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((batch_size,), dtype=torch.long, device=device),
    }


def decode_step(p: DenseTransformer, cache: dict, tokens: torch.Tensor, cfg):
    """One decode step: tokens ``(B, S_new)`` → ``(logits, cache)``.

    Every slot decodes at its own offset ``cache["pos"]``.  Attention reads
    the cache read-only; after the layer loop the new keys/values of all
    layers are appended at once and ``pos`` advances.  Unlike the JAX
    version, which returns a new cache, this updates ``cache`` **in place**
    (and returns it): a captured CUDA graph needs fixed addresses."""
    _require_dense(cfg)
    pos = cache["pos"]
    S_new = tokens.shape[1]
    x = L.embed_tokens(p.embed, tokens, cfg)
    positions = pos[:, None] + torch.arange(S_new, device=pos.device)[None, :]
    x, (new_k, new_v) = _run_layers(p, x, cfg, positions, cache=cache)
    L.append_kv(cache["k"], cache["v"], new_k, new_v, pos)
    pos += S_new                                           # in place
    x = L.apply_norm(p.final_norm, x, cfg)
    return L.unembed(p.embed, x, cfg), cache
