"""Transformer of the port: one ``nn.Module`` and the functions that run
it, for the dense and MoE families.

Counterpart of the JAX package's ``models/transformer.py``, with the same
API shape::

    model         = init_model(generator, cfg, device="cuda")
    logits, aux   = forward(model, {"tokens": tokens}, cfg)     # full sequence
    logits, kv    = prefill(model, tokens, cfg)                 # empty cache
    cache         = init_cache(cfg, batch_size, max_len, device="cuda")
    logits, cache = decode_step(model, cache, tokens, cfg)      # in place

The JAX package stacks the layers and runs them under ``lax.scan``; here
they are an ``nn.ModuleList`` walked by a Python loop.  Each layer's
parameters carry the JAX parameter names, so :mod:`repro_torch.bridge`
maps a JAX parameter tree onto the module one leaf at a time.  A MoE
layer (``cfg.moe``) has ``moe`` in place of ``ffn`` (Arctic keeps its
parallel dense ``ffn`` too); an MLA layer (``cfg.mla``, DeepSeek-V2)
has the latent projections as ``attn`` and caches latents
(``ckv``/``krope``) instead of keys and values.  The ``vlm``, ``hybrid``,
``ssm`` and ``audio`` families are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import PORTED_FAMILIES

from . import layers as L
from .mla import mla_attention, mla_prefill, mla_shapes
from .moe import apply_moe, moe_shapes

FAMILY_TODO = (
    "is not ported yet: only the dense and moe families run so far "
    "(ROADMAP.md, Queue 1 item 5)"
)
# a random draw of more elements is made in chunks of the leading axis, so
# that its float32 temporary stays near 1 GiB at any model size
INIT_CHUNK = 2**28


def _require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} {FAMILY_TODO}")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Group(nn.Module):
    """Parameters and nested groups read by name (``g["w"]``, ``"w" in
    g``), like one dict of the JAX parameter tree: every group of the
    model (embed, norms, attn, ffn, moe and its shared experts, a layer)."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, leaf in leaves.items():
            if isinstance(leaf, nn.Parameter):
                self.register_parameter(name, leaf)
            else:
                self.add_module(name, leaf)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _nest(shapes: dict, dtype_of, device) -> dict:
    """``{"a": shape, "b.c": shape}`` → parameters, with dotted names
    nested one level into :class:`Group`s."""
    out: dict = {}
    for name, shape in shapes.items():
        head, _, leaf = name.rpartition(".")
        param = _param(shape, dtype_of(name), device)
        if head:
            out.setdefault(head, {})[leaf] = param
        else:
            out[name] = param
    return {k: Group(v) if isinstance(v, dict) else v for k, v in out.items()}


def _norm(cfg, device) -> Group:
    d = cfg.d_model
    p = {"scale": _param((d,), torch.float32, device)}
    if cfg.norm == "layernorm":
        p["bias"] = _param((d,), torch.float32, device)
    return Group(p)


class Transformer(nn.Module):
    """Parameters of a decoder, laid out as the JAX parameter tree:
    ``embed`` (``tok``, ``unembed`` unless tied), ``final_norm`` and
    ``layers[i]`` with ``attn`` (``wq``, ``wk``, ``wv``, ``wo``, or MLA's
    ``w_dq``/``w_uq`` or ``w_q``, ``w_dkv``, ``w_uk``, ``w_uv``, ``w_o``,
    ``kv_norm_scale``), ``ln1``, ``ln2``, ``ffn`` (``w_gate``, ``w_up``,
    ``w_down``) and/or ``moe`` (``router``, ``w_gate``, ``w_up``,
    ``w_down``, optional ``shared``) and, for gemma2, ``ln_post_attn`` /
    ``ln_post_ffn``.  Norm parameters, ``kv_norm_scale`` and the router are
    float32 and the rest is ``dtype`` (default ``cfg.dtype``), as in JAX.
    The tensors are allocated uninitialised; :func:`init_model` or
    :func:`repro_torch.bridge.params_from_jax` fills them."""

    def __init__(self, cfg, *, device="cuda", dtype: Optional[torch.dtype] = None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        dt = dtype or getattr(torch, cfg.dtype)
        d, h, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        embed = {"tok": _param((cfg.padded_vocab, d), dt, device)}
        if not cfg.tie_embeddings:
            embed["unembed"] = _param((d, cfg.padded_vocab), dt, device)
        self.embed = Group(embed)
        self.final_norm = _norm(cfg, device)
        blocks = []
        for _ in range(cfg.n_layers):
            if cfg.mla is not None:
                attn = _nest(mla_shapes(cfg), lambda n: torch.float32
                             if n == "kv_norm_scale" else dt, device)
            else:
                attn = {
                    "wq": _param((d, nh, h), dt, device),
                    "wk": _param((d, nkv, h), dt, device),
                    "wv": _param((d, nkv, h), dt, device),
                    "wo": _param((nh, h, d), dt, device),
                }
                if cfg.qk_norm:
                    attn["q_norm"] = _param((h,), torch.float32, device)
                    attn["k_norm"] = _param((h,), torch.float32, device)
            block = {
                "attn": Group(attn),
                "ln1": _norm(cfg, device),
                "ln2": _norm(cfg, device),
            }
            if cfg.moe is not None:
                block["moe"] = Group(_nest(moe_shapes(cfg), lambda n: torch.float32
                                           if n == "router" else dt, device))
            if cfg.moe is None or f:        # arctic: a parallel dense branch
                block["ffn"] = Group({
                    "w_gate": _param((d, f), dt, device),
                    "w_up": _param((d, f), dt, device),
                    "w_down": _param((f, d), dt, device),
                })
            if cfg.post_attn_norm:
                block["ln_post_attn"] = _norm(cfg, device)
                block["ln_post_ffn"] = _norm(cfg, device)
            blocks.append(Group(block))
        self.layers = nn.ModuleList(blocks)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits ``(B, S, padded_vocab)``."""
        return forward(self, {"tokens": tokens}, self.cfg)[0]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(generator: torch.Generator, cfg, *, device="cuda") -> Transformer:
    """Random weights with the JAX initialiser's distributions, drawn from
    ``generator`` on its own device (pass a CUDA generator to initialise on
    the card).  ``jax.random`` and ``torch.Generator`` give different
    numbers from one seed; parity tests carry the JAX weights through
    :mod:`repro_torch.bridge` instead.  A tensor of more than
    :data:`INIT_CHUNK` elements is drawn in chunks of its leading axis."""
    model = Transformer(cfg, device=device)

    def normal_(t: torch.Tensor, std: float) -> None:
        rows = max(1, INIT_CHUNK * t.shape[0] // max(t.numel(), 1))
        for part in t.split(rows):
            r = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                            device=t.device)
            part.copy_(r.mul_(std))

    for name, t in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "tok":
            normal_(t, 0.02)
        elif leaf == "bias":
            t.zero_()
        elif leaf == "scale":
            # layernorm scales start at 1, rmsnorm's (1 + scale) at 0
            t.fill_(1.0 if cfg.norm == "layernorm" else 0.0)
        elif leaf in ("q_norm", "k_norm", "kv_norm_scale"):
            t.fill_(1.0)
        elif name.endswith("moe.w_down"):
            normal_(t, 1.0 / math.sqrt(t.shape[1]))      # (E, F, D): fan-in F
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


def _attn_ffn_block(lp, x, cfg, *, positions, window, cache=None, prompt=False):
    """Pre-norm transformer block; returns ``(x, new_kv, aux)``.

    ``new_kv`` is this call's new keys/values, or MLA's new latents.  With
    ``cache``, dense attention reads it read-only (deferred append) and MLA
    writes its latents into it first; ``prompt`` runs MLA's prompt pass
    (the absorbed form, as on an empty cache).  ``aux`` is the router's
    loss, None without MoE."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    if cfg.mla is None:
        attn_out, new_kv = L.attention(
            lp["attn"], h, cfg, positions=positions, layer_window=window,
            cache=cache, update_cache=False,
        )
    elif prompt:
        attn_out, new_kv = mla_prefill(lp["attn"], h, cfg, positions=positions)
    else:
        attn_out, new_kv = mla_attention(lp["attn"], h, cfg, positions=positions,
                                         cache=cache)
    if cfg.post_attn_norm:
        attn_out = L.apply_norm(lp["ln_post_attn"], attn_out, cfg)
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg)
    aux = None
    if cfg.moe is not None:
        ffn_out, aux = apply_moe(lp["moe"], h, cfg)
        if "ffn" in lp:           # arctic: the dense residual branch in parallel
            ffn_out = ffn_out + L.apply_ffn(lp["ffn"], h, cfg)
    else:
        ffn_out = L.apply_ffn(lp["ffn"], h, cfg)
    if cfg.post_attn_norm:
        ffn_out = L.apply_norm(lp["ln_post_ffn"], ffn_out, cfg)
    return x + ffn_out, new_kv, aux


def cache_names(cfg) -> tuple[str, str]:
    """The cache's per-layer leaves besides ``pos``: MLA's latent and rope
    key, or keys and values."""
    return ("ckv", "krope") if cfg.mla is not None else ("k", "v")


def _run_layers(p, x, cfg, positions, cache=None, prompt=False, keep_new=True):
    """Walk the layer stack; returns ``(x, new_kv, aux)`` with the layers'
    router losses summed (None without MoE) and, with ``keep_new``, each
    layer's new keys/values (or latents) stacked on a leading layer axis
    (else None)."""
    news: tuple[list, list] = ([], [])
    auxs = []
    windows = _window_schedule(cfg) or [None] * cfg.n_layers
    for i, (lp, w) in enumerate(zip(p.layers, windows)):
        lcache = None
        if cache is not None:
            lcache = {name: cache[name][i] for name in cache_names(cfg)}
            lcache["pos"] = cache["pos"]
        x, new_kv, aux = _attn_ffn_block(lp, x, cfg, positions=positions, window=w,
                                         cache=lcache, prompt=prompt)
        if keep_new:
            for acc, t in zip(news, new_kv):
                acc.append(t)
        if aux is not None:
            auxs.append(aux)
    aux = torch.stack(auxs).sum() if auxs else None
    new = (torch.stack(news[0]), torch.stack(news[1])) if keep_new else None
    return x, new, aux


# ---------------------------------------------------------------------------
# forward (full sequence) and prefill into an empty cache
# ---------------------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(p: Transformer, batch: dict, cfg):
    """Full-sequence forward: returns ``(logits, {"aux_loss": ...})``, the
    router losses summed over layers (0 for the dense family).  Dense
    attention runs through the flash kernel (its plain version on the CPU),
    MLA in its expanded form."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(p.embed, tokens, cfg)
    x, _, aux = _run_layers(p, x, cfg, _positions(*tokens.shape, tokens.device),
                            keep_new=False)
    x = L.apply_norm(p.final_norm, x, cfg)
    logits = L.unembed(p.embed, x, cfg)
    if aux is None:
        aux = torch.zeros((), device=tokens.device)
    return logits, {"aux_loss": aux}


def prefill(p: Transformer, tokens: torch.Tensor, cfg):
    """Prompt pass for a slot whose cache is empty.

    What the JAX engine computes with ``decode_step`` on a sub-cache whose
    ``pos`` it has just set to 0.  Dense: with no valid cache entry the
    first part of ``_sdpa_deferred`` is fully masked, and the rest is
    causal, windowed, soft-capped attention over the new tokens, which is
    the flash kernel.  MLA: the absorbed form against the prompt's own
    latents.  The MoE dispatch sees N = B·P tokens, so the bucket sets the
    capacity, as in JAX.  Returns ``(logits (B, P, padded_vocab), new)``:
    ``new`` holds, in the order of :func:`cache_names`, k/v of shape
    ``(n_layers, B, P, n_kv_heads, head_dim)`` or the latents
    ``(n_layers, B, P, kv_lora_rank)`` and ``(n_layers, B, P,
    qk_rope_head_dim)``; the caller writes them into the cache at offset 0."""
    _require_ported(cfg)
    x = L.embed_tokens(p.embed, tokens, cfg)
    x, new, _ = _run_layers(p, x, cfg, _positions(*tokens.shape, tokens.device),
                            prompt=True)
    x = L.apply_norm(p.final_norm, x, cfg)
    return L.unembed(p.embed, x, cfg), new


# ---------------------------------------------------------------------------
# decode: cache init + single step
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda") -> dict:
    """Per-slot cache in ``cfg.dtype`` and ``pos`` ``(B,)``, every batch
    slot at its own write offset (continuous batching): ``k``/``v`` of
    shape ``(n_layers, B, max_len, n_kv_heads, head_dim)``, or for MLA the
    latent cache ``ckv`` ``(n_layers, B, max_len, kv_lora_rank)`` and
    ``krope`` ``(n_layers, B, max_len, qk_rope_head_dim)``."""
    _require_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    L_, B = cfg.n_layers, batch_size
    if cfg.mla is not None:
        m = cfg.mla
        shapes = ((L_, B, max_len, m.kv_lora_rank), (L_, B, max_len, m.qk_rope_head_dim))
    else:
        shapes = ((L_, B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim),) * 2
    cache = {name: torch.zeros(shape, dtype=dt, device=device)
             for name, shape in zip(cache_names(cfg), shapes)}
    cache["pos"] = torch.zeros((batch_size,), dtype=torch.long, device=device)
    return cache


def decode_step(p: Transformer, cache: dict, tokens: torch.Tensor, cfg):
    """One decode step: tokens ``(B, S_new)`` → ``(logits, cache)``.

    Every slot decodes at its own offset ``cache["pos"]``.  Dense attention
    reads the cache read-only, and after the layer loop the new keys/values
    of all layers are appended at once; MLA writes each layer's new latents
    into the cache inside the layer, then attends (as JAX does).  Then
    ``pos`` advances.  Unlike the JAX version, which returns a new cache,
    this updates ``cache`` **in place** (and returns it): a captured CUDA
    graph needs fixed addresses."""
    _require_ported(cfg)
    pos = cache["pos"]
    S_new = tokens.shape[1]
    x = L.embed_tokens(p.embed, tokens, cfg)
    positions = pos[:, None] + torch.arange(S_new, device=pos.device)[None, :]
    # MLA has written its latents into the cache inside each layer
    x, new, _ = _run_layers(p, x, cfg, positions, cache=cache, keep_new=cfg.mla is None)
    if new is not None:
        L.append_kv(cache["k"], cache["v"], *new, pos)
    pos += S_new                                           # in place
    x = L.apply_norm(p.final_norm, x, cfg)
    return L.unembed(p.embed, x, cfg), cache
