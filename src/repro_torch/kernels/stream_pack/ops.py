"""Public wrappers for stream_pack.

``stream_pack(x, w)`` picks by the tensors' device: CPU tensors go to the
plain PyTorch version, CUDA tensors to the Hopper kernel (which raises on
what it cannot run).  The kernel masks its ragged edge, so these wrappers
pass one block per dimension and take any M, N and K; the TPU's block
contract is :func:`kernel.stream_pack_matmul`'s, for callers that name
blocks.  ``packed_branches(xs, ws)`` is the drop-in for "run these k
independent matmuls on k streams": stack, one kernel, unstack.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import stream_pack_matmul_ref


def stream_pack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (lanes, M, K), or (M, K) shared by every lane (passed to the
    kernel with lane stride 0, never copied); w: (lanes, K, N) →
    (lanes, M, N).  Strided operands are made contiguous first."""
    if x.dim() == 2:
        x = x.contiguous().expand(w.shape[0], *x.shape)
    if x.device.type == "cpu":
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
