"""Expanded attention's gradient (B7): :class:`ExpandedAttention`.

Its forward is the forward kernel writing each row's log-sum-exp too
(:func:`.kernel.attend` with ``with_lse=True``) on CUDA tensors, the plain
version on CPU and meta tensors (through :func:`repro_torch.kernels.
run_plain`, so the dry run counts it as one launch); its backward is the
backward kernel (:func:`.backward.expanded_attention_bwd`, four kernels a
call) on CUDA tensors and :func:`.ref.expanded_attention_bwd_ref` through
``run_plain`` on the others.  No path falls back from one to the other.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import run_plain, takes_plain

from . import backward, kernel
from .ref import expanded_attention_bwd_ref, expanded_attention_ref


class ExpandedAttention(torch.autograd.Function):
    """``(o, lse)`` of ``(q_nope, q_rope, k_nope, k_rope, v, q_pos,
    scale)``, with the gradient of o; the LSE (float32 ``(B, N, S)``) is
    not differentiable, nor are q_pos and the scale."""

    @staticmethod
    def forward(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale):
        if not takes_plain(q_nope):
            return kernel.attend(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale=scale,
                                 with_lse=True)
        return run_plain(functools.partial(expanded_attention_ref, scale=scale), q_nope, q_rope,
                         k_nope, k_rope, v, q_pos)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q_nope, q_rope, k_nope, k_rope, v, q_pos, scale = inputs
        o, lse = output
        ctx.save_for_backward(q_nope, q_rope, k_nope, k_rope, v, o, lse, q_pos)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q_nope, q_rope, k_nope, k_rope, v, o, lse, q_pos = ctx.saved_tensors
        args = (q_nope, q_rope, k_nope, k_rope, v, o, lse, do, q_pos)
        if not takes_plain(q_nope):
            grads = backward.expanded_attention_bwd(*args, scale=ctx.scale)
        else:
            grads = run_plain(functools.partial(expanded_attention_bwd_ref, scale=ctx.scale),
                              *args)
        return (*grads, None, None)
