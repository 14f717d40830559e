"""Public wrappers for stream_pack.

``stream_pack(x, w)`` picks by the tensors' device: CPU and meta tensors
go to the plain PyTorch version (:func:`repro_torch.kernels.takes_plain`),
CUDA tensors to the Hopper kernel (which raises on what it cannot run).  The kernel masks its ragged edge, so these wrappers
pass one block per dimension and take any M, N and K; the TPU's block
contract is :func:`kernel.stream_pack_matmul`'s, for callers that name
blocks.  ``packed_branches(xs, ws)`` is the drop-in for "run these k
independent matmuls on k streams": stack, one kernel, unstack.  Gradients
flow through :class:`StreamPack`, whose backward is the same kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import takes_plain

from . import kernel
from .ref import stream_pack_matmul_ref


class StreamPack(torch.autograd.Function):
    """:func:`stream_pack` with its gradient, whose two products are again
    lanes of same-shape GEMMs, run by the same kernel (its plain version
    on CPU tensors): ``dx = dy · wᵀ`` ``(lanes, M, N) × (lanes, N, K)``,
    summed over the lanes for a shared ``(M, K)`` x, and ``dw = xᵀ · dy``
    ``(lanes, K, M) × (lanes, M, N)``, xᵀ shared when x is.  The kernel
    takes its right operand contiguous, so ``wᵀ`` and ``xᵀ`` are one copy
    each."""

    @staticmethod
    def forward(x, w):
        return _stream_pack(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _stream_pack(dy, w.transpose(1, 2).contiguous())
            if x.dim() == 2:
                dx = dx.sum(0)
        if ctx.needs_input_grad[1]:
            xt = x.transpose(-2, -1).contiguous()
            dw = _stream_pack(xt, dy)
        return dx, dw


def stream_pack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (lanes, M, K), or (M, K) shared by every lane (passed to the
    kernel with lane stride 0, never copied); w: (lanes, K, N) →
    (lanes, M, N).  Strided operands are made contiguous first.  With grad
    enabled and an operand that requires it, through :class:`StreamPack`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return StreamPack.apply(x, w)
    return _stream_pack(x, w)


def _stream_pack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        x = x.contiguous().expand(w.shape[0], *x.shape)
    if takes_plain(x):
        return stream_pack_matmul_ref(x, w)
    _, M, K = x.shape
    if x.stride(0) != 0 or not x[0].is_contiguous():
        x = x.contiguous()
    return kernel.stream_pack_matmul(x, w.contiguous(), block_m=M, block_n=w.shape[2],
                                     block_k=K)


def packed_branches(xs, ws) -> list[torch.Tensor]:
    """List-of-branches API: [(M,K)]*k, [(K,N)]*k → list of (M,N).  When
    every branch reads the same tensor it is passed once, shared."""
    x = xs[0] if all(t is xs[0] for t in xs) else torch.stack(xs)
    return list(stream_pack(x, torch.stack(ws)).unbind(0))
