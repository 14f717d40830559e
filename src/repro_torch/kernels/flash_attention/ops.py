"""Model-layout flash attention, and its gradient.

Takes model-layout tensors ``(B, S, heads, head_dim)`` and picks by the
tensors' device: CUDA tensors go to the Hopper kernel, which reads them
through their strides as they come (no layout copy for the layouts the
model makes; see :func:`.kernel.prepare`) and writes a contiguous
``(B, Sq, heads, head_dim)`` output, so the model's ``reshape(B, S,
heads * head_dim)`` is a view; it raises on what it cannot run.  CPU
tensors go to the plain PyTorch version in its ``(B·heads, S, head_dim)``
layout; so do meta tensors, whose plain version only propagates shapes
(:func:`repro_torch.kernels.takes_plain`).

With grad enabled and an input that requires it, the call goes through
:class:`FlashAttention`: its forward also keeps each row's log-sum-exp,
its backward is the backward kernel (:mod:`.backward`) on CUDA tensors and
:func:`.ref.flash_attention_bwd_ref` on CPU tensors.  Otherwise (serving)
the forward runs alone.

DTensors (sharded execution) run through ``local_map``: each device
attends over its own batch rows and heads, forward and backward, with no
collective.  q, k and v must be placed alike, sharded on batch or heads
only, so that the local q heads keep their GQA grouping over the local kv
heads; anything else raises with the shapes and placements.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import run_plain, takes_plain

from . import backward, kernel
from .ref import flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) → (B·H, S, hd); a 3-d tensor as it is."""
    if t.dim() == 3:
        return t
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd)


def _model(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_flat` for a tensor shaped like ``like``."""
    if like.dim() == 3:
        return t
    B, S, H, hd = like.shape
    return t.reshape(B, H, S, hd).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of q, k, v, all 4-d (model layout) or all 3-d, with the
    gradient of o; the LSE (float32, ``(B, NH, Sq)`` or ``(BH, Sq)``) is
    not differentiable.  Arguments after v: group, scale, softcap, causal,
    window."""

    @staticmethod
    def forward(q, k, v, group, scale, softcap, causal, window):
        kw = dict(group=group, scale=scale, softcap=softcap, causal=causal, window=window)
        if not takes_plain(q):
            return kernel.attend(q, k, v, with_lse=True, **kw)
        return run_plain(functools.partial(_plain_lse, **kw), q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, group, scale, softcap, causal, window = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(group=group, scale=scale, softcap=softcap, causal=causal, window=window)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if not takes_plain(q):
            dq, dk, dv = backward.attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        else:
            dq, dk, dv = run_plain(functools.partial(_plain_bwd, **ctx.kw), q, k, v, o, lse, do)
        return dq, dk, dv, None, None, None, None, None


def _plain_lse(q, k, v, **kw):
    """The plain version of the forward with its LSE, in q's layout."""
    o, lse = flash_attention_lse_ref(_flat(q), _flat(k), _flat(v), **kw)
    if q.dim() == 4:
        lse = lse.reshape(q.shape[0], q.shape[2], q.shape[1])
    return _model(o, q), lse


def _plain_bwd(q, k, v, o, lse, do, **kw):
    """The plain version of the backward: ``(dq, dk, dv)`` in the inputs'
    layouts."""
    dq, dk, dv = flash_attention_bwd_ref(_flat(q), _flat(k), _flat(v), _flat(o),
                                         lse.reshape(-1, q.shape[1]), _flat(do), **kw)
    return _model(dq, q), _model(dk, k), _model(dv, v)


def _plain(q, k, v, **kw):
    return _model(flash_attention_ref(_flat(q), _flat(k), _flat(v), **kw), q)


#: calls that ran on DTensors' local shards through ``local_map``
on_shards = 0


def _on_shards(q, k, v, **kw) -> torch.Tensor:
    """:func:`mha_flash` of DTensors, on each device's local shards."""
    global on_shards
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise TypeError("q is a DTensor: k and v must be DTensors on its mesh")
    places = q.placements, k.placements, v.placements
    if len(set(places)) != 1 or any(p.is_partial() or (isinstance(p, Shard) and p.dim not in (0, 2))
                                    for p in places[0]):
        raise ValueError(
            f"flash attention on shards needs q, k and v placed alike, sharded on batch or "
            f"heads only, so that the local q heads keep their GQA groups: q {tuple(q.shape)} "
            f"{places[0]}, k {tuple(k.shape)} {places[1]}, v {tuple(v.shape)} {places[2]}")
    on_shards += 1
    local = local_map(functools.partial(mha_flash, **kw), out_placements=list(places[0]),
                      in_placements=places, device_mesh=q.device_mesh)
    return local(q, k, v)


def mha_flash(
    q: torch.Tensor,           # (B, Sq, NH, hd)
    k: torch.Tensor,           # (B, Skv, NKV, hd)
    v: torch.Tensor,
    *,
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    if isinstance(q, DTensor):
        return _on_shards(q, k, v, scale=scale, softcap=softcap, causal=causal, window=window)
    B, Sq, NH, hd = q.shape
    group = NH // k.shape[2]
    kw = dict(group=group, scale=scale, softcap=softcap, causal=causal, window=window)
    if not takes_plain(q):
        return kernel.attention(q, k, v, **kw)
    if kernel.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, group, scale, softcap, causal, window)[0]
    return run_plain(functools.partial(_plain, **kw), q, k, v)
