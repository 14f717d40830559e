"""AdamW with global-norm clipping, the JAX package's ``optim/adamw.py``.

The moments are float32 whatever the parameters' dtype, and the step
counter is an int32 device tensor, so a step captured in a CUDA graph
reads it afresh on every replay.  Trees are any pytree of tensors
(``torch.utils._pytree``): a dict of a model's named parameters, say.

Unlike the JAX version, which returns new trees, :func:`adamw_update`
updates the parameters and the moments **in place** (the counterpart of
JAX's ``donate_argnums=(0, 1)``): a captured step needs fixed addresses,
and a model at full width has no room for a second copy of its state.  It
walks the leaves one by one, so the float32 temporaries of the update are
those of one leaf at a time.  The casts are JAX's: the gradients are
clipped in their own dtype, the update is computed in float32 and rounded
to the parameter's dtype.

Sharded parameters (DTensors) keep their moments on the same placements,
and the step counter is replicated over their mesh, as JAX's
``adamw_init_shardings`` places them; the update then runs on each
device's shards in place, and the global norm sums every shard.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    mu: Any                     # float32, the parameters' tree
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero float32 moments shaped and placed as the parameters, and the
    step counter 0 on their device (replicated over their mesh)."""
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    zeros = pytree.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False), params)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if leaves and isinstance(leaves[0], DTensor):
        mesh = leaves[0].device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return AdamWState(step=step, mu=zeros, nu=pytree.tree_map(torch.clone, zeros))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of the leaves' squares in float32, a device tensor."""
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Gradients times ``min(1, max_norm / (norm + 1e-9))``, the scale cast
    to each leaf's dtype, computed on the device (no ``.item()``)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
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
    if max_grad_norm:
        grads, norm = clip_by_global_norm(grads, max_grad_norm)
    else:
        norm = global_norm(grads)
    step = state.step
    step.add_(1)
    s = step.float()
    bc1 = 1.0 - torch.pow(b1, s)
    bc2 = 1.0 - torch.pow(b2, s)
    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_flatten(grads)[0]
    flat_m, flat_v = pytree.tree_leaves(state.mu), pytree.tree_leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"trees differ: {len(flat_p)} params, {len(flat_g)} grads, "
                         f"{len(flat_m)} and {len(flat_v)} moments")
    with torch.no_grad():
        for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
            gf = g.float()
            m.mul_(b1).add_(gf, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(gf, gf, value=1.0 - b2)
            del gf
            delta = torch.div(v, bc2).sqrt_().add_(eps)
            delta = torch.div(m, bc1).div_(delta)
            pf = p.float()
            delta.add_(pf, alpha=weight_decay)
            p.copy_(pf.sub_(delta.mul_(lr)))
    return pytree.tree_unflatten(flat_p, spec), state, norm
