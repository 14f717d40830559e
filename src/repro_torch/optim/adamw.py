"""AdamW with global-norm clipping, the JAX package's ``optim/adamw.py``.

The moments are float32 whatever the parameters' dtype, and the step
counter is an int32 device tensor, so a step captured in a CUDA graph
reads it afresh on every replay.  Trees are any pytree of tensors
(``torch.utils._pytree``): a dict of a model's named parameters, say.

Unlike the JAX version, which returns new trees, :func:`adamw_update`
updates the parameters and the moments **in place** (the counterpart of
JAX's ``donate_argnums=(0, 1)``): a captured step needs fixed addresses,
and a model at full width has no room for a second copy of its state.  The
casts are JAX's: the gradients are clipped in their own dtype, the update
is computed in float32 and rounded to the parameter's dtype.

The arithmetic runs in B4 (``repro_torch.kernels.adamw``), as XLA fuses it
inside JAX's jitted step: one pass that reads every gradient for the norm,
one tiny kernel for the norm, the clip scale, the step and the bias
corrections, and one pass that reads each leaf's gradient, parameter and
moments once and writes the parameter and the moments once; on the CPU
and the meta device their plain versions, one leaf at a time.  Nothing
reads a value back to the host: a step captured in a CUDA graph reads the
step counter and a tensor learning rate afresh on every replay.

Sharded parameters (DTensors) keep their moments on the same placements,
and the step counter is replicated over their mesh, as JAX's
``adamw_init_shardings`` places them; the update then runs on each
device's local shards in place (it is element-wise: no communication).
Each leaf's sum of squares is summed over the devices that hold its
shards, all leaves at once (one all-reduce of the sums per mesh axis that
shards any leaf; a replicated leaf's sum is kept on the axis's first
device and is 0 on the others), and the sums are then added in tree
order: on a mesh whose axes shard nothing the norm is the unsharded one,
bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils import _pytree as pytree

from repro_torch.kernels.adamw import kernel


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    mu: Any                     # float32, the parameters' tree
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero float32 moments shaped and placed as the parameters, and the
    step counter 0 on their device (replicated over their mesh).  On a
    CUDA device B4's kernels are loaded here, so that a step captured in a
    CUDA graph later loads none."""
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    if leaves and _local(leaves[0]).device.type == "cuda":
        kernel.load(_local(leaves[0]).device)
    zeros = pytree.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False), params)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if leaves and isinstance(leaves[0], DTensor):
        mesh = leaves[0].device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return AdamWState(step=step, mu=zeros, nu=pytree.tree_map(torch.clone, zeros))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _grads(leaves: list) -> list:
    """The gradients' local tensors, each contiguous (a counted copy,
    ``kernel.layout_copies``, where autograd gave another layout)."""
    return [kernel.contiguous(_local(g)) for g in leaves]


def _leaf_sums(leaves: list, local: list) -> torch.Tensor:
    """B4's buffer of each leaf's float32 sum of squares over the whole
    leaf (for a DTensor, summed over the devices holding its shards), and
    room for the finish's four scalars; ``local`` are the leaves'
    :func:`_grads`."""
    first = leaves[0]
    if not isinstance(first, DTensor):
        return kernel.adamw_sumsq(local)
    mesh = first.device_mesh
    for i, leaf in enumerate(leaves):
        if any(pl.is_partial() for pl in leaf.placements):
            raise ValueError(f"adamw: leaf {i} is a partial sum ({leaf.placements}); lay it "
                             "out as its parameter first")
    axes = [d for d in range(mesh.ndim) if mesh.size(d) > 1
            and any(leaf.placements[d].is_shard() for leaf in leaves)]
    coord = mesh.get_coordinate()
    keep = [all(coord[d] == 0 for d in axes if not leaf.placements[d].is_shard())
            for leaf in leaves]
    buf = kernel.adamw_sumsq(local, keep)
    if axes:
        n = len(leaves)
        parts = DTensor.from_local(buf[:n], mesh, [Partial() if d in axes else Replicate()
                                                   for d in range(mesh.ndim)], run_check=False)
        buf[:n].copy_(parts.redistribute(mesh, [Replicate()] * mesh.ndim).to_local())
    return buf


def _like(t: torch.Tensor, leaf) -> torch.Tensor:
    """``t``, a value of every device, replicated over ``leaf``'s mesh if
    ``leaf`` is a DTensor."""
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


def _norm_and_scale(leaves: list, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        out = kernel.adamw_finish(_leaf_sums(leaves, _grads(leaves)), None, max_norm=max_norm)
    return _like(out[0], leaves[0]), _like(out[1], leaves[0])


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of the leaves' squares in float32, a device tensor:
    each leaf's sum, then the leaves' sums added in tree order."""
    return _norm_and_scale(pytree.tree_leaves(tree), 1.0)[0]


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """A new tree of the gradients times ``min(1, max_norm / (norm +
    1e-9))``, the scale cast to each leaf's dtype, and the norm, computed
    on the device (no ``.item()``).  The training step does not call it:
    :func:`adamw_update` clips inside its update pass."""
    norm, scale = _norm_and_scale(pytree.tree_leaves(grads), max_norm)
    return pytree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    *,
    lr: float | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> tuple[Any, AdamWState, torch.Tensor]:
    """Returns (params, state, pre-clip grad norm), ``params`` and the
    moments updated in place and ``state.step`` advanced in place."""
    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_flatten(grads)[0]
    flat_m, flat_v = pytree.tree_leaves(state.mu), pytree.tree_leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"trees differ: {len(flat_p)} params, {len(flat_g)} grads, "
                         f"{len(flat_m)} and {len(flat_v)} moments")
    with torch.no_grad():
        local = _grads(flat_g)
        scalars = kernel.adamw_finish(_leaf_sums(flat_g, local), _local(state.step),
                                      max_norm=max_grad_norm, b1=b1, b2=b2)
        kernel.adamw_step(local, [_local(t) for t in flat_m],
                          [_local(t) for t in flat_v], [_local(t) for t in flat_p], scalars,
                          _local(lr), b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                          clip=bool(max_grad_norm))
    return pytree.tree_unflatten(flat_p, spec), state, _like(scalars[0], flat_g[0])
