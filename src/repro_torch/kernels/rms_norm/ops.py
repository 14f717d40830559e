"""B8's autograd Function, and the RMSNorm the model layers call.

:func:`rms_norm` picks by the tensors: with grad enabled and x or scale
requiring it, :class:`RMSNorm` (the forward kernel, which saves x and each
row's float32 rstd, no float32 copy of a row; the backward kernel for dx
and dscale); otherwise the forward alone (serving).  CPU and meta tensors
take the plain versions through the same wrappers (:mod:`.kernel`).

A ``DTensor`` runs on its local shards through ``local_map``: a row is
whole on every device ("embed" is replicated, a head's width never
sharded; a row sharded anyway, or a partial sum, is made whole first), so
each device normalizes its own rows with no collective, and scale's
gradient is a partial sum over the devices that split the rows.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import keep_shards, on_local_shards
from repro_torch.kernels import needs_grad

from . import backward, kernel


class RMSNorm(torch.autograd.Function):
    """``(y, rstd)`` of x and scale, with the gradient of y; arguments
    after scale: eps, offset.  rstd is not differentiable."""

    @staticmethod
    def forward(x, scale, eps, offset):
        return kernel.rms_norm(x, scale, eps, offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _, offset = inputs
        ctx.save_for_backward(x, scale, output[1])
        ctx.offset = offset
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, dy, _drstd):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = backward.rms_norm_bwd(x, scale, rstd, dy, ctx.offset)
        return dx, dscale, None, None


def _on_shards(x: DTensor, scale, eps: float, offset: float) -> DTensor:
    dims = {f"dim{i}": i for i in range(x.dim() - 1)}
    x = keep_shards(x, tuple(dims.values()))
    return on_local_shards(functools.partial(rms_norm, eps=eps, offset=offset), x, dims,
                           [(x, dims), (scale, {})], [dims])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float, offset: float
             ) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps) * (offset + scale)).to(x.dtype)`` over
    x's last dimension, computed in float32 (scale float32 ``(width,)``;
    offset 1.0 for ``apply_norm``, 0.0 for ``_rms(x) * scale``)."""
    if isinstance(x, DTensor):
        return _on_shards(x, scale, eps, offset)
    if needs_grad(x, scale):
        return RMSNorm.apply(x, scale, eps, offset)[0]
    return kernel.rms_norm(x, scale, eps, offset)[0]
