"""Collective-byte accounting of a sharded step, for the dry run and the
roofline: the counterpart of the JAX package's ``launch/hlo_analysis.py``,
named for what it reads, since the port has no HLO.

DTensor lowers every redistribution to PyTorch's functional collectives
(``_c10d_functional.all_reduce``, ``all_gather_into_tensor``, ...).
:class:`CommCounter`, a ``CommDebugMode``, sees them on one device's local
tensors, as it counts them, and records each op's name with its operand
bytes (its input tensors' shapes and dtypes); it also counts the FLOPs of
the products it sees on those local tensors: one device's share of a
partitioned step (``FlopCounterMode`` around DTensor code counts neither
the global step nor one device's share).  :func:`collective_bytes` turns
the records into JAX's record, with JAX's kind names and conventions:
operand bytes on one device, ``wait_tensor`` skipped (as JAX skips an
async pair's ``-done``), a coalesced op's operands summed.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import flop_registry

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# functional collectives (any namespace) by JAX's kind; DTensor's shard to
# shard move is an all-to-all; nothing of DTensor's lowers to a permute
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
# the namespaces whose ops are recorded
NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def shape_bytes(dtype: torch.dtype | str, dims: Iterable[int]) -> int:
    """Bytes of a tensor of ``dtype`` (a torch dtype or its name) and shape
    ``dims``; 0 for a name that is no torch dtype."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
        if not isinstance(dtype, torch.dtype):
            return 0
    n = 1
    for d in dims:
        n *= int(d)
    return n * dtype.itemsize


def operand_bytes(args: Any) -> int:
    """Bytes of every tensor among ``args`` (a coalesced op's list too)."""
    return sum(shape_bytes(t.dtype, t.shape) for t in pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor))


# the tensor types of a device's own (local) ops
_LOCAL = (torch.Tensor, torch.nn.Parameter)


class CommCounter(CommDebugMode):
    """``CommDebugMode`` that also keeps ``records``, ``(op name, operand
    bytes)`` of every op of the collective namespaces it sees on local
    tensors (``wait_tensor`` among them), and ``flops``, the FLOPs of the
    products it sees on them (``torch.utils.flop_counter``'s formulas): one
    device's share of the work, when each device runs the same program."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[tuple[str, int]] = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is NotImplemented or not isinstance(func, torch._ops.OpOverload)
                or any(t not in _LOCAL for t in types)):
            # a DTensor op (its local ops come back here), or DTensor's
            # sharding propagation running an op on fake tensors
            return out
        packet = func._overloadpacket
        if func.namespace in NAMESPACES:
            self.records.append((packet.__name__, operand_bytes(args)))
        elif packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **(kwargs or {}), out_val=out))
        return out


def collective_bytes(records: Iterable[tuple[str, int]]) -> dict[str, Any]:
    """Sum the operand bytes of every collective among ``records`` (``(op
    name, operand bytes)``), per kind: ``{"bytes_per_kind", "counts",
    "total_bytes"}``, as JAX's ``hlo_analysis.collective_bytes`` gives
    them.  ``wait_tensor`` and every other op are skipped."""
    per_kind = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for name, nbytes in records:
        kind = KINDS.get(name)
        if kind is None:
            continue
        per_kind[kind] += nbytes
        counts[kind] += 1
    return {
        "bytes_per_kind": per_kind,
        "counts": counts,
        "total_bytes": sum(per_kind.values()),
    }
