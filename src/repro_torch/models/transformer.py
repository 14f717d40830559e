"""The port's models: one ``nn.Module`` and the functions that run it, for
every family (dense, moe, vlm, hybrid, ssm, audio).

Counterpart of the JAX package's ``models/transformer.py``, with the same
API shape::

    model         = init_model(generator, cfg, device="cuda")
    logits, aux   = forward(model, batch, cfg)          # full sequence
    logits, kv    = prefill(model, tokens, cfg)         # empty cache (attention families)
    memory        = encode_memory(model, frames, cfg)   # audio: the encoder, once
    cache         = init_cache(cfg, batch_size, max_len, device="cuda")
    logits, cache = decode_step(model, cache, tokens, cfg)   # in place
    model, axes   = abstract_model(cfg)                 # on "meta": the dry run

``batch`` holds ``tokens`` and, per family, ``vision_embeds`` (vlm) or
``frames`` (audio).  The JAX package stacks the layers and runs them under
``lax.scan`` (and the hybrid's shared block under ``lax.cond``); here they
are ``nn.ModuleList``s walked by a Python loop, the condition a Python
``if`` on the layer index.  Each layer's parameters carry the JAX parameter
names, so :mod:`repro_torch.bridge` maps a JAX parameter tree onto the
module one leaf at a time.  A MoE layer (``cfg.moe``) has ``moe`` in place
of ``ffn`` (Arctic keeps its parallel dense ``ffn`` too); an MLA layer
(``cfg.mla``, DeepSeek-V2) has the latent projections as ``attn`` and
caches latents (``ckv``/``krope``) instead of keys and values.  Every
decode state (KV cache, latents, SSD and conv state, xLSTM cells) is
updated in place, where JAX returns a new cache.

Every parameter carries its logical axes (``param.axes``, JAX's axes
string; a leaf JAX stacks over layers, ``"layers " + s``, is a per-layer
parameter here and carries ``s``): :func:`param_axes` returns them by
name, :func:`cache_axes` gives the cache's, and
:mod:`repro_torch.distributed` maps both onto a mesh.  ``init_cache(...,
per_slot=False)`` gives the synchronized batch decode its one scalar
offset.  Under a sharding context (DTensor parameters and inputs) the
layers carry JAX's ``constrain`` call sites: the residual stream laid out
as ``(batch, seq, embed)`` after each block, the logits as ``(batch, seq,
vocab)``; :func:`layer_period` gives the dry run the depth at which the
stack's pattern repeats.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch.distributed import constrain, replicate_like

from . import layers as L
from . import ssm as SSM
from . import xlstm as XL
from .layers import Shape
from .mla import mla_attention, mla_prefill, mla_shapes
from .moe import apply_moe, moe_shapes

ATTENTION_FAMILIES = ("dense", "moe", "vlm")
# a random draw of more elements is made in chunks of the leading axis, so
# that its float32 temporary stays near 1 GiB at any model size
INIT_CHUNK = 2**28


def _param(shape: Shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter of ``shape``, carrying its logical axes
    as ``axes``."""
    param = nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)
    param.axes = shape.axes
    return param


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
    """``{"a": Shape, "b.c": Shape}`` → parameters, with dotted names
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
    p = {"scale": _param(Shape((d,), "_"), torch.float32, device)}
    if cfg.norm == "layernorm":
        p["bias"] = _param(Shape((d,), "_"), torch.float32, device)
    return Group(p)


# leaves that are float32 whatever the model's dtype, as in JAX
F32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "kv_norm_scale", "router") \
    + SSM.F32_LEAVES + XL.F32_LEAVES


def _leaves(shapes: dict, dt, device) -> dict:
    """:func:`_nest` with float32 for the leaves of :data:`F32_LEAVES` and
    ``dt`` for the rest."""
    return _nest(shapes, lambda n: torch.float32 if n.rsplit(".", 1)[-1] in F32_LEAVES
                 else dt, device)


def _attn_params(cfg, dt, device) -> Group:
    """``init_attention``'s leaves: ``wq``, ``wk``, ``wv``, ``wo`` (and the
    qk-norm scales)."""
    d, h, nh, nkv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": Shape((d, nh, h), "fsdp heads head_dim"),
              "wk": Shape((d, nkv, h), "fsdp kv_heads head_dim"),
              "wv": Shape((d, nkv, h), "fsdp kv_heads head_dim"),
              "wo": Shape((nh, h, d), "heads head_dim fsdp")}
    if cfg.qk_norm:
        shapes.update({"q_norm": Shape((h,), "_"), "k_norm": Shape((h,), "_")})
    return Group(_leaves(shapes, dt, device))


def _ffn_params(cfg, dt, device) -> Group:
    d, f = cfg.d_model, cfg.d_ff
    return Group(_leaves({"w_gate": Shape((d, f), "fsdp mlp"), "w_up": Shape((d, f), "fsdp mlp"),
                          "w_down": Shape((f, d), "mlp fsdp")}, dt, device))


def _attn_block(cfg, dt, device) -> Group:
    """One pre-norm attention block (``_init_attn_block`` in JAX)."""
    if cfg.mla is not None:
        attn = Group(_leaves(mla_shapes(cfg), dt, device))
    else:
        attn = _attn_params(cfg, dt, device)
    block = {"attn": attn, "ln1": _norm(cfg, device), "ln2": _norm(cfg, device)}
    if cfg.moe is not None:
        block["moe"] = Group(_leaves(moe_shapes(cfg), dt, device))
    if cfg.moe is None or cfg.d_ff:      # arctic: a parallel dense branch
        block["ffn"] = _ffn_params(cfg, dt, device)
    if cfg.post_attn_norm:
        block["ln_post_attn"] = _norm(cfg, device)
        block["ln_post_ffn"] = _norm(cfg, device)
    return Group(block)


def _xlstm_kind(cfg, i: int) -> str:
    return "slstm" if i in cfg.xlstm.slstm_at else "mlstm"


class Transformer(nn.Module):
    """Parameters of a model of any family, laid out as the JAX parameter
    tree: ``embed`` (``tok``, ``unembed`` unless tied) and ``final_norm``,
    then by family

    * dense / moe / vlm: ``layers[i]`` with ``attn`` (``wq``, ``wk``,
      ``wv``, ``wo``, or MLA's latent projections), ``ln1``, ``ln2``,
      ``ffn`` (``w_gate``, ``w_up``, ``w_down``) and/or ``moe`` and, for
      gemma2, ``ln_post_attn`` / ``ln_post_ffn``; vlm adds ``projector``
      (``w1``, ``w2``);
    * hybrid: ``layers[i]`` with ``mamba`` and ``ln``, and one
      ``shared_attn`` block (as a dense layer);
    * ssm (xLSTM): ``layers[i]`` with ``ln`` and ``cell``, an mLSTM or, at
      ``xlstm.slstm_at``, an sLSTM;
    * audio: ``encoder[i]`` (``attn``, ``ffn``, ``ln1``, ``ln2``),
      ``decoder[i]`` (``self_attn``, ``cross_attn``, ``ffn``, ``ln1``-``ln3``),
      ``enc_final_norm`` and ``frontend_proj`` (``w``).

    The leaves of :data:`F32_LEAVES` (norms, router, gate biases, the SSD's
    scalars) are float32 and the rest is ``dtype`` (default ``cfg.dtype``),
    as in JAX.  Each parameter carries its logical axes as ``axes``.  The
    tensors are allocated uninitialised; :func:`init_model` or
    :func:`repro_torch.bridge.params_from_jax` fills them.  On
    ``device="meta"`` nothing is allocated (:func:`abstract_model`)."""

    def __init__(self, cfg, *, device="cuda", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        dt = dtype or getattr(torch, cfg.dtype)
        d, fam = cfg.d_model, cfg.family
        embed = {"tok": _param(Shape((cfg.padded_vocab, d), "vocab fsdp"), dt, device)}
        if not cfg.tie_embeddings:
            embed["unembed"] = _param(Shape((d, cfg.padded_vocab), "fsdp vocab"), dt, device)
        self.embed = Group(embed)
        self.final_norm = _norm(cfg, device)
        if fam in ATTENTION_FAMILIES:
            self.layers = nn.ModuleList(_attn_block(cfg, dt, device)
                                        for _ in range(cfg.n_layers))
            if fam == "vlm":
                self.projector = Group(_leaves(
                    {"w1": Shape((cfg.vision_dim, d), "_ fsdp"), "w2": Shape((d, d), "fsdp fsdp")},
                    dt, device))
        elif fam == "hybrid":
            self.layers = nn.ModuleList(
                Group({"mamba": Group(_leaves(SSM.mamba2_shapes(cfg), dt, device)),
                       "ln": _norm(cfg, device)})
                for _ in range(cfg.n_layers))
            self.shared_attn = _attn_block(cfg, dt, device)
        elif fam == "ssm":
            shapes = {"slstm": XL.slstm_shapes(cfg), "mlstm": XL.mlstm_shapes(cfg)}
            self.layers = nn.ModuleList(
                Group({"ln": _norm(cfg, device),
                       "cell": Group(_leaves(shapes[_xlstm_kind(cfg, i)], dt, device))})
                for i in range(cfg.n_layers))
        elif fam == "audio":
            self.encoder = nn.ModuleList(
                Group({"attn": _attn_params(cfg, dt, device), "ffn": _ffn_params(cfg, dt, device),
                       "ln1": _norm(cfg, device), "ln2": _norm(cfg, device)})
                for _ in range(cfg.n_enc_layers))
            self.decoder = nn.ModuleList(
                Group({"self_attn": _attn_params(cfg, dt, device),
                       "cross_attn": _attn_params(cfg, dt, device),
                       "ffn": _ffn_params(cfg, dt, device),
                       **{n: _norm(cfg, device) for n in ("ln1", "ln2", "ln3")}})
                for _ in range(cfg.n_layers))
            self.enc_final_norm = _norm(cfg, device)
            self.frontend_proj = Group(_leaves({"w": Shape((cfg.audio_dim, d), "_ fsdp")}, dt,
                                               device))
        else:
            raise ValueError(f"unknown family {fam}")

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits ``(B, S, padded_vocab)`` of a text-only
        batch (``vision_embeds`` or ``frames`` go through :func:`forward`)."""
        return forward(self, {"tokens": tokens}, self.cfg)[0]


def abstract_model(cfg) -> tuple[Transformer, dict[str, str]]:
    """``(Transformer on the meta device, param_axes(cfg))``: every
    parameter's shape and dtype and its axes, with nothing allocated (JAX's
    ``abstract_model``, for the dry run)."""
    model = Transformer(cfg, device="meta")
    return model, {name: p.axes for name, p in model.named_parameters()}


def param_axes(cfg) -> dict[str, str]:
    """Each parameter's logical axes string, by its name in
    :class:`Transformer` (the names :mod:`repro_torch.bridge` gives the
    JAX leaves: ``layers.3.attn.wq``); a per-layer leaf carries JAX's
    axes without the stacked ``layers`` axis."""
    return abstract_model(cfg)[1]


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
        elif leaf in ("bias", "conv_b", "A_log", "dt_bias"):
            t.zero_()
        elif leaf == "scale":
            # layernorm scales start at 1, rmsnorm's (1 + scale) at 0
            t.fill_(1.0 if cfg.norm == "layernorm" else 0.0)
        elif leaf in ("q_norm", "k_norm", "kv_norm_scale", "D"):
            t.fill_(1.0)
        elif leaf in ("b_if", "b_gates"):
            t.copy_(XL.gate_bias(leaf, t.numel()))
        elif name.endswith("moe.w_down"):
            normal_(t, 1.0 / math.sqrt(t.shape[1]))      # (E, F, D): fan-in F
        else:
            normal_(t, 1.0 / math.sqrt(t.shape[0]))      # fan-in: axis 0
    return model


# ---------------------------------------------------------------------------
# layer block
# ---------------------------------------------------------------------------

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` remat policy (JAX's ``dots_with_no_batch_dims_saveable``):
    keep the outputs of matrix products with no batch dimension, recompute
    the rest."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` (a layer body) under activation checkpointing when
    ``cfg.remat`` is set and grad is enabled, as JAX wraps its scan bodies
    in ``jax.checkpoint``: its activations are recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), all of them under the
    ``full`` policy, all but the matrix products' outputs under ``dots``."""
    if not cfg.remat or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_dots)
    return functools.partial(ckpt.checkpoint, fn, **kw)


def _window_schedule(cfg) -> Optional[list[int]]:
    """Per-layer attention window: gemma2 alternates local / global."""
    if not cfg.local_global_pattern or not cfg.sliding_window:
        return None
    k = cfg.local_global_pattern
    return [2**30 if i % k == k - 1 else cfg.sliding_window for i in range(cfg.n_layers)]


def _attn_ffn_block(lp, x, cfg, *, positions, window, cache=None, prompt=False,
                    update_cache=False):
    """Pre-norm transformer block; returns ``(x, new_kv, aux)``.

    ``new_kv`` is this call's new keys/values, or MLA's new latents.  With
    ``cache``, dense attention reads it read-only (deferred append) or,
    with ``update_cache`` (the hybrid's shared block in decode), writes the
    new keys/values into it in place first; MLA writes its latents into it
    first; ``prompt`` runs MLA's prompt pass (the absorbed form, as on an
    empty cache).  ``aux`` is the router's loss, None without MoE."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    if cfg.mla is None:
        attn_out, new_kv = L.attention(
            lp["attn"], h, cfg, positions=positions, layer_window=window,
            cache=cache, update_cache=update_cache,
        )
    elif prompt:
        attn_out, new_kv = mla_prefill(lp["attn"], h, cfg, positions=positions)
    else:
        attn_out, new_kv = mla_attention(lp["attn"], h, cfg, positions=positions,
                                         cache=cache)
    if cfg.post_attn_norm:
        attn_out = L.apply_norm(lp["ln_post_attn"], attn_out, cfg)
    x = constrain(x + attn_out, "batch", "seq", "embed")
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
    return constrain(x + ffn_out, "batch", "seq", "embed"), new_kv, aux


def cache_names(cfg) -> tuple[str, str]:
    """The cache's per-layer leaves besides ``pos``: MLA's latent and rope
    key, or keys and values."""
    return ("ckv", "krope") if cfg.mla is not None else ("k", "v")


def _run_layers(p, x, cfg, positions, cache=None, pos=None, prompt=False, keep_new=True):
    """Walk the layer stack; returns ``(x, new_kv, aux)`` with the layers'
    router losses summed (None without MoE) and, with ``keep_new``, each
    layer's new keys/values (or latents) stacked on a leading layer axis
    (else None).  With ``cache``, ``pos`` is the slots' offsets ``(B,)``."""
    news: tuple[list, list] = ([], [])
    auxs = []
    windows = _window_schedule(cfg) or [None] * cfg.n_layers
    block = _remat(_attn_ffn_block, cfg) if cache is None else _attn_ffn_block
    for i, (lp, w) in enumerate(zip(p.layers, windows)):
        lcache = None
        if cache is not None:
            lcache = {name: cache[name][i] for name in cache_names(cfg)}
            lcache["pos"] = pos
        x, new_kv, aux = block(lp, x, cfg, positions=positions, window=w,
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
# per-family layer stacks
# ---------------------------------------------------------------------------

def _xlstm_layer(lp, x, cfg, *, kind: str, cache=None):
    """Pre-norm xLSTM layer; returns ``(x, state)`` (the state written into
    ``cache`` in place when one is given)."""
    h = L.apply_norm(lp["ln"], x, cfg)
    block = XL.slstm_block if kind == "slstm" else XL.mlstm_block
    out, state = block(lp["cell"], h, cfg, cache=cache)
    return x + out, state


def layer_period(cfg) -> int:
    """The fewest layers whose pattern repeats through the stack (xLSTM's
    sLSTM positions, the hybrid's shared attention, gemma2's windows): the
    smallest divisor P of ``n_layers`` with layer i alike layer i mod P."""
    windows = _window_schedule(cfg) or [None] * cfg.n_layers
    kinds = [(windows[i],
              _xlstm_kind(cfg, i) if cfg.family == "ssm" else None,
              _is_attn_layer(cfg, i) if cfg.family == "hybrid" else None)
             for i in range(cfg.n_layers)]
    return next(p for p in range(1, cfg.n_layers + 1)
                if cfg.n_layers % p == 0 and all(k == kinds[i % p] for i, k in enumerate(kinds)))


def _is_attn_layer(cfg, i: int) -> bool:
    """Zamba2 applies its shared attention block after every
    ``hybrid_attn_every``-th Mamba2 layer."""
    every = cfg.hybrid_attn_every
    return i % every == every - 1


def _hybrid_layer(lp, shared, x, cfg, positions, with_attn: bool):
    out, _ = SSM.mamba2_block(lp["mamba"], L.apply_norm(lp["ln"], x, cfg), cfg)
    x = x + out
    if with_attn:
        x, _, _ = _attn_ffn_block(shared, x, cfg, positions=positions, window=None)
    return x


def _forward_hybrid(p, x, cfg, positions):
    """Zamba2: the Mamba2 layers (chunked SSD), the shared attention block
    (flash attention) after every ``hybrid_attn_every``-th."""
    layer = _remat(_hybrid_layer, cfg)
    for i, lp in enumerate(p.layers):
        x = layer(lp, p.shared_attn, x, cfg, positions, _is_attn_layer(cfg, i))
    return x


def _encoder_layer(lp, x, cfg, positions):
    o, _ = L.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                       positions=positions, causal=False)
    x = x + o
    x = x + L.apply_ffn(lp["ffn"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return constrain(x, "batch", "seq", "embed")


def encode_memory(p: Transformer, frames: torch.Tensor, cfg) -> torch.Tensor:
    """The audio encoder, run once (enc-dec prefill): frames (B, T,
    audio_dim) through ``frontend_proj``, the encoder layers (bidirectional
    flash attention) and ``enc_final_norm``; returns the memory (B, T, D)."""
    x = frames.to(p.frontend_proj["w"].dtype) @ p.frontend_proj["w"]
    positions = _positions(x)
    layer = _remat(_encoder_layer, cfg)
    for lp in p.encoder:
        x = layer(lp, x, cfg, positions)
    return L.apply_norm(p.enc_final_norm, x, cfg)


def _decoder_layer(lp, x, memory, cfg, *, positions, cache=None):
    """One audio decoder layer: causal self-attention (flash attention
    without a cache; with one, the in-layer KV update), cross attention
    over ``memory`` (flash attention), the FFN."""
    o, _ = L.attention(lp["self_attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                       positions=positions, cache=cache)
    x = x + o
    x = x + L.cross_attention(lp["cross_attn"], L.apply_norm(lp["ln2"], x, cfg), memory, cfg)
    x = x + L.apply_ffn(lp["ffn"], L.apply_norm(lp["ln3"], x, cfg), cfg)
    return constrain(x, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# forward (full sequence) and prefill into an empty cache
# ---------------------------------------------------------------------------

def _positions(x: torch.Tensor) -> torch.Tensor:
    """``(B, S)`` positions 0..S-1 of ``x`` ``(B, S, ...)``, laid out as
    its batch under a sharding context."""
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return constrain(replicate_like(positions, x), "batch", "seq")


def _embed_input(p, batch, cfg) -> torch.Tensor:
    """Token embeddings; for vlm, the projected vision embeddings (the tanh
    gelu of ``vision_embeds @ w1``, then ``@ w2``) placed before them."""
    x = L.embed_tokens(p.embed, batch["tokens"], cfg)
    if cfg.family == "vlm":
        ve = batch["vision_embeds"].to(x.dtype)               # (B, T_img, vision_dim)
        proj = F.gelu(ve @ p.projector["w1"], approximate="tanh") @ p.projector["w2"]
        x = torch.cat([proj, x], dim=1)
    return x


def forward(p: Transformer, batch: dict, cfg):
    """Full-sequence forward: returns ``(logits, {"aux_loss": ...})``, the
    router losses summed over layers (0 but for MoE).  ``batch`` holds
    ``tokens`` and, for vlm, ``vision_embeds`` (B, T_img, vision_dim), whose
    logits come first, or, for audio, ``frames`` (B, T, audio_dim).  Every
    full-sequence attention (dense, the hybrid's shared block, the encoder,
    the decoder's self and cross attention) runs through the flash kernel
    (its plain version on the CPU), MLA in its expanded form."""
    tokens = batch["tokens"]
    fam = cfg.family
    aux = None
    if fam == "audio":
        memory = encode_memory(p, batch["frames"], cfg)
        x = L.embed_tokens(p.embed, tokens, cfg)
        positions = _positions(tokens)
        layer = _remat(_decoder_layer, cfg)
        for lp in p.decoder:
            x = layer(lp, x, memory, cfg, positions=positions)
    else:
        x = _embed_input(p, batch, cfg)
        positions = _positions(x)
        if fam in ATTENTION_FAMILIES:
            x, _, aux = _run_layers(p, x, cfg, positions, keep_new=False)
        elif fam == "hybrid":
            x = _forward_hybrid(p, x, cfg, positions)
        else:
            for i, lp in enumerate(p.layers):
                x, _ = _xlstm_layer(lp, x, cfg, kind=_xlstm_kind(cfg, i))
    x = L.apply_norm(p.final_norm, x, cfg)
    logits = constrain(L.unembed(p.embed, x, cfg), "batch", "seq", "vocab")
    if aux is None:
        aux = replicate_like(torch.zeros((), device=tokens.device), logits)
    return logits, {"aux_loss": aux}


def prefill(p: Transformer, tokens: torch.Tensor, cfg):
    """Prompt pass for a slot whose cache is empty (dense, moe and vlm; a
    vlm prompt is text only, as the JAX engine serves it).

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
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"prefill serves the {ATTENTION_FAMILIES} families, not {cfg.family}")
    x = L.embed_tokens(p.embed, tokens, cfg)
    x, new, _ = _run_layers(p, x, cfg, _positions(tokens),
                            prompt=True)
    x = L.apply_norm(p.final_norm, x, cfg)
    return L.unembed(p.embed, x, cfg), new


# ---------------------------------------------------------------------------
# decode: cache init + single step
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, *, memory_len: int = 0,
               per_slot: bool = True, device="cuda") -> dict:
    """Decode state as JAX's ``init_cache`` lays it out.  ``pos`` is
    ``(B,)`` with ``per_slot`` (every batch slot at its own write offset:
    continuous batching) and 0-d without (one offset for the whole batch:
    the synchronized batch decode of :func:`decode_step`); int64, the
    port's index type, where JAX's is int32.  Besides ``pos``:

    * dense / vlm / moe: ``k``/``v`` ``(n_layers, B, max_len, n_kv_heads,
      head_dim)`` in ``cfg.dtype``, or MLA's latents ``ckv`` ``(n_layers, B,
      max_len, kv_lora_rank)`` and ``krope`` ``(..., qk_rope_head_dim)``;
    * hybrid: ``ssm_h`` ``(n_layers, B, H, head_dim, state_dim)`` float32,
      ``conv`` ``(n_layers, B, conv_width - 1, conv channels)`` and the
      shared block's ``attn_k``/``attn_v`` ``(applications, B, max_len,
      n_kv_heads, head_dim)``;
    * ssm: ``layers``, a list with one dict per layer (sLSTM ``c``, ``n``,
      ``m``, ``h``; mLSTM ``C``, ``n``, ``m``);
    * audio: ``k``/``v`` of the decoder and ``memory`` ``(B, memory_len,
      d_model)``, which the caller fills from :func:`encode_memory`."""
    dt = getattr(torch, cfg.dtype)
    L_, B, fam = cfg.n_layers, batch_size, cfg.family

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv_shape = (B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if fam in ATTENTION_FAMILIES:
        if cfg.mla is not None:
            m = cfg.mla
            shapes = ((L_, B, max_len, m.kv_lora_rank), (L_, B, max_len, m.qk_rope_head_dim))
        else:
            shapes = ((L_,) + kv_shape,) * 2
        cache = {name: zeros(shape) for name, shape in zip(cache_names(cfg), shapes)}
    elif fam == "hybrid":
        s = cfg.ssm
        _, H, conv_ch = SSM.ssm_dims(cfg)
        n_apps = -(-cfg.n_layers // cfg.hybrid_attn_every)
        cache = {"ssm_h": zeros((L_, B, H, s.head_dim, s.state_dim), torch.float32),
                 "conv": zeros((L_, B, s.conv_width - 1, conv_ch)),
                 "attn_k": zeros((n_apps,) + kv_shape), "attn_v": zeros((n_apps,) + kv_shape)}
    elif fam == "ssm":
        H, d = cfg.n_heads, cfg.d_model
        hd_up = int(d * cfg.xlstm.proj_factor) // H
        f32 = torch.float32
        layers = []
        for i in range(L_):
            if _xlstm_kind(cfg, i) == "slstm":
                layers.append({"c": zeros((B, d), f32), "n": torch.ones((B, d), device=device),
                               "m": zeros((B, d), f32), "h": zeros((B, d))})
            else:
                layers.append({"C": zeros((B, H, hd_up, hd_up), f32), "n": zeros((B, H, hd_up), f32),
                               "m": torch.full((B, H), -1e30, device=device)})
        cache = {"layers": layers}
    elif fam == "audio":
        cache = {"k": zeros((L_,) + kv_shape), "v": zeros((L_,) + kv_shape),
                 "memory": zeros((B, memory_len, cfg.d_model))}
    else:
        raise ValueError(f"unknown family {fam}")
    cache["pos"] = torch.zeros((batch_size,) if per_slot else (), dtype=torch.long,
                               device=device)
    return cache


def cache_axes(cfg, per_slot: bool = True) -> dict:
    """Logical-axes strings in the structure of :func:`init_cache`'s cache
    (JAX's ``cache_axes``, for the dry run's placements)."""
    fam = cfg.family
    pos = "batch" if per_slot else ""
    kv = "layers batch kv_seq kv_heads _"
    if fam in ATTENTION_FAMILIES:
        if cfg.mla is not None:
            return {"ckv": "layers batch kv_seq _", "krope": "layers batch kv_seq _", "pos": pos}
        return {"k": kv, "v": kv, "pos": pos}
    if fam == "hybrid":
        return {"ssm_h": "layers batch heads _ _", "conv": "layers batch _ mlp",
                "attn_k": "_ batch kv_seq kv_heads _", "attn_v": "_ batch kv_seq kv_heads _",
                "pos": pos}
    if fam == "ssm":
        slstm = {"c": "batch _", "n": "batch _", "m": "batch _", "h": "batch _"}
        mlstm = {"C": "batch heads _ _", "n": "batch heads _", "m": "batch heads"}
        return {"layers": [dict(slstm if _xlstm_kind(cfg, i) == "slstm" else mlstm)
                           for i in range(cfg.n_layers)], "pos": pos}
    if fam == "audio":
        return {"k": kv, "v": kv, "memory": "batch _ _", "pos": pos}
    raise ValueError(f"unknown family {fam}")


def decode_step(p: Transformer, cache: dict, tokens: torch.Tensor, cfg):
    """One decode step: tokens ``(B, S_new)`` → ``(logits, cache)``.

    Every slot decodes at its own offset ``cache["pos"]`` ``(B,)``, or,
    with a 0-d ``pos`` (``init_cache(per_slot=False)``), all at that one
    offset: the synchronized batch decode.  Dense attention
    reads the cache read-only, and after the layer loop the new keys/values
    of all layers are appended at once (synchronized: one write of all
    layers and slots at ``pos``, an ``index_copy_`` at a device-side
    offset, so a CUDA graph captures it); MLA writes each layer's new latents
    into the cache inside the layer, then attends (as JAX does).  The
    hybrid's SSD and conv state, its shared block's keys/values (written
    inside the layer), the xLSTM cells and the audio decoder's keys/values
    (written inside the layer, then cross attention over
    ``cache["memory"]`` on the flash kernel) advance one token.  Then
    ``pos`` advances: by ``S_new`` for the attention families, by 1 for
    hybrid, ssm and audio, as in JAX.  Unlike the JAX version, which
    returns a new cache, this updates ``cache`` **in place** (and returns
    it): a captured CUDA graph needs fixed addresses."""
    B, S_new = tokens.shape
    synced = cache["pos"].dim() == 0
    pos = cache["pos"].expand(B)             # a scalar offset broadcast, as in JAX
    fam = cfg.family
    x = L.embed_tokens(p.embed, tokens, cfg)
    positions = pos[:, None] + replicate_like(torch.arange(S_new, device=pos.device), pos)[None, :]
    if fam in ATTENTION_FAMILIES:
        # MLA has written its latents into the cache inside each layer
        x, new, _ = _run_layers(p, x, cfg, positions, cache=cache, pos=pos,
                                keep_new=cfg.mla is None)
        if new is not None and synced:
            L.append_kv_synced(cache["k"], cache["v"], *new, cache["pos"])
        elif new is not None:
            L.append_kv(cache["k"], cache["v"], *new, pos)
        step = S_new
    elif fam == "hybrid":
        for i, lp in enumerate(p.layers):
            out, _ = SSM.mamba2_block(lp["mamba"], L.apply_norm(lp["ln"], x, cfg), cfg,
                                      cache={"h": cache["ssm_h"][i], "conv": cache["conv"][i]})
            x = x + out
            if _is_attn_layer(cfg, i):
                app = i // cfg.hybrid_attn_every
                x, _, _ = _attn_ffn_block(
                    p.shared_attn, x, cfg, positions=positions, window=None,
                    cache={"k": cache["attn_k"][app], "v": cache["attn_v"][app], "pos": pos},
                    update_cache=True)
        step = 1
    elif fam == "ssm":
        for i, lp in enumerate(p.layers):
            x, _ = _xlstm_layer(lp, x, cfg, kind=_xlstm_kind(cfg, i), cache=cache["layers"][i])
        step = 1
    else:
        for i, lp in enumerate(p.decoder):
            x = _decoder_layer(lp, x, cache["memory"], cfg, positions=positions,
                               cache={"k": cache["k"][i], "v": cache["v"][i], "pos": pos})
        step = 1
    cache["pos"] += step                                   # in place
    x = L.apply_norm(p.final_norm, x, cfg)
    return L.unembed(p.embed, x, cfg), cache
