"""Public wrappers for stream_pack.

``stream_pack(x, w)`` picks by the tensors' device: CPU and meta tensors
go to the plain PyTorch version (:func:`repro_torch.kernels.takes_plain`),
CUDA tensors to the Hopper kernel (which raises on what it cannot run).  The kernel masks its ragged edge, so these wrappers
pass one block per dimension and take any M, N and K; the TPU's block
contract is :func:`kernel.stream_pack_matmul`'s, for callers that name
blocks.  ``packed_branches(xs, ws)`` is the drop-in for "run these k
independent matmuls on k streams": stack, one kernel, unstack.  Gradients
flow through :class:`StreamPack`, whose backward is the same kernel.

DTensors (sharded execution, a MoE layer's experts) run through
``local_map``: each device multiplies its own lanes (experts), and its own
slice of K (a partial sum, reduced where the result is next read) or of
N, with no collective.  A replicated operand is sliced to its partner's
shard, which sends nothing; an operand that would have to be gathered
first raises, with the shapes and placements.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import run_plain, takes_plain

from . import kernel
from .ref import stream_pack_matmul_ref


class StreamPack(torch.autograd.Function):
    """:func:`stream_pack` with its gradient, whose two products are again
    lanes of same-shape GEMMs, run by the same kernel (its plain version
    on CPU tensors): ``dx = dy · wᵀ`` ``(lanes, M, N) × (lanes, N, K)``,
    summed over the lanes for a shared ``(M, K)`` x, and ``dw = xᵀ · dy``
    ``(lanes, K, M) × (lanes, M, N)``, xᵀ shared when x is.  The kernel
    reads either operand transposed where it lies, so ``wᵀ`` and ``xᵀ``
    are views: no copy of w or x (``kernel.layout_copies`` counts any)."""

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
            dx = _stream_pack(dy, w.transpose(1, 2))
            if x.dim() == 2:
                dx = dx.sum(0)
        if ctx.needs_input_grad[1]:
            dw = _stream_pack(x.transpose(-2, -1), dy)
        return dx, dw


#: calls that ran on DTensors' local shards through ``local_map``
on_shards = 0

_X_DIMS, _W_DIMS = ("lanes", "m", "k"), ("lanes", "k", "n")


def _role(p, dims: tuple[str, str, str]):
    """What a placement does to an operand: None (replicated), the name of
    the dimension it shards, or ``"partial"``."""
    if isinstance(p, Shard):
        return dims[p.dim]
    return "partial" if p.is_partial() else None


def _local_product(px, pw):
    """``(x's, w's, the output's, x's gradient's, w's gradient's)``
    placements on one mesh dimension for a product of local shards that
    sends nothing, or None: lanes sharded (out and both gradients sharded
    on lanes), K sharded (a partial sum), N sharded in w (out sharded on N;
    x's gradient a partial sum over N), M sharded in x over a replicated w
    (w's gradient a partial sum over M), or nothing sharded.  A replicated
    operand is sliced to its partner's shard."""
    rx, rw = _role(px, _X_DIMS), _role(pw, _W_DIMS)
    if (rx, rw) in (("lanes", "lanes"), (None, "lanes"), ("lanes", None)):
        return (Shard(0),) * 5
    if (rx, rw) in (("k", "k"), (None, "k"), ("k", None)):
        return Shard(2), Shard(1), Partial(), Shard(2), Shard(1)
    if (rx, rw) == (None, "n"):
        return Replicate(), Shard(2), Shard(2), Partial(), Shard(2)
    if (rx, rw) == ("m", None):
        return Shard(1), Replicate(), Shard(1), Shard(1), Partial()
    if (rx, rw) == (None, None):
        return (Replicate(),) * 5
    return None


def _on_shards(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`stream_pack` of DTensors, on each device's local shards."""
    global on_shards
    if not isinstance(w, DTensor) or x.dim() != 3:
        raise TypeError("stream_pack on shards takes a DTensor w and a 3-d x")
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    places = [_local_product(px, pw) for px, pw in zip(x.placements, w.placements)]
    if None in places:
        raise ValueError(
            f"stream_pack on shards would gather an operand: x {tuple(x.shape)} "
            f"{x.placements}, w {tuple(w.shape)} {w.placements}")
    px, pw, po, gx, gw = (tuple(p[i] for p in places) for i in range(5))
    x, w = x.redistribute(mesh, px), w.redistribute(mesh, pw)
    on_shards += 1
    out = local_map(stream_pack, out_placements=list(po), in_placements=(px, pw),
                    in_grad_placements=(gx, gw), device_mesh=mesh)(x, w)
    if Partial() in po:        # the partial sums over K, reduced at once
        out = out.redistribute(mesh, [Replicate() if p.is_partial() else p for p in po])
    return out


def stream_pack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (lanes, M, K), or (M, K) shared by every lane (passed to the
    kernel with lane stride 0, never copied); w: (lanes, K, N) →
    (lanes, M, N).  Each operand's matrices may lie row-major or
    transposed; any other layout is copied once
    (``kernel.layout_copies``).  With grad
    enabled and an operand that requires it, through :class:`StreamPack`;
    DTensors on their local shards."""
    if isinstance(w, DTensor) or isinstance(x, DTensor):
        return _on_shards(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return StreamPack.apply(x, w)
    return _stream_pack(x, w)


def _stream_pack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        x = x.expand(w.shape[0], *x.shape)
    if takes_plain(x):
        return run_plain(stream_pack_matmul_ref, x, w)
    x, w = kernel.operands(x, w)
    _, M, K = x.shape
    return kernel.stream_pack_matmul(x, w, block_m=M, block_n=w.shape[2], block_k=K)


def packed_branches(xs, ws) -> list[torch.Tensor]:
    """List-of-branches API: [(M,K)]*k, [(K,N)]*k → list of (M,N).  When
    every branch reads the same tensor it is passed once, shared."""
    x = xs[0] if all(t is xs[0] for t in xs) else torch.stack(xs)
    return list(stream_pack(x, torch.stack(ws)).unbind(0))
