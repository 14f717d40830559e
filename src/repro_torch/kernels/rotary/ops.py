"""B9's autograd Function, and the RoPE the model layers call.

:func:`apply_rope` computes the cos and sin tables once a call
(:func:`.ref.rope_tables`) and rotates x by them: with grad enabled and x
requiring it through :class:`Rotary`, whose backward is the same kernel
with ``-sin`` (it saves the tables, not x); otherwise the forward alone
(serving).  CPU and meta tensors take the plain version through the same
wrapper (:mod:`.kernel`).

A ``DTensor`` runs on its local shards through ``local_map``: each device
rotates its own batch rows, positions and heads by its positions' tables
(a head's width is never sharded; a sharded one, or a partial sum, is made
whole first), with no collective.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import keep_shards, on_local_shards
from repro_torch.kernels import needs_grad

from . import kernel
from .ref import rope_tables


class Rotary(torch.autograd.Function):
    """x rotated by the tables cos and sin, with the gradient of x."""

    @staticmethod
    def forward(x, cos, sin):
        return kernel.rotary(x, cos, sin)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, cos, sin = inputs
        ctx.save_for_backward(cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        return kernel.rotary(dy, cos, sin, negate=True), None, None


# the named dimensions of x (B, S, heads, head_dim) and of positions (B, S)
_X = {"batch": 0, "seq": 1, "heads": 2}
_POSITIONS = {"batch": 0, "seq": 1}


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``(B, S, heads, head_dim)`` rotated by the angles of ``positions``
    ``(B, S)``: the halves of head_dim as ``[x1 cos - x2 sin, x2 cos + x1
    sin]`` in float32, rounded once to x's dtype."""
    if isinstance(x, DTensor):
        x = keep_shards(x, tuple(_X.values()))
        return on_local_shards(functools.partial(apply_rope, theta=theta), x, _X,
                               [(x, _X), (positions, _POSITIONS)], [_X])
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    if needs_grad(x):
        return Rotary.apply(x, cos, sin)
    return kernel.rotary(x, cos, sin)
