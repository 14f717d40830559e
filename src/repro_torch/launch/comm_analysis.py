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

In the same pass the counter keeps one device's memory traffic and
footprint, JAX's ``cost_analysis()["bytes accessed"]`` and
``memory_analysis()`` on the port's terms:

* ``bytes_accessed``: for each op on local tensors that is not a view (an
  in-place op counts) and not a collective, the bytes of its tensor inputs
  plus its outputs.  The port's step is unfused, and a CUDA graph replays
  the same ops, so this is what the port reads and writes; XLA counts
  after fusion, where intermediates of a fused region never reach memory.
  An indexed read or write (``index``, ``index_put_``, ``index_copy_``)
  counts the rows it names, not the tensor it indexes: its indices, and
  the rows read and written (a cache write moves its new rows, as XLA's
  in-place ``dynamic-update-slice`` does).
* ``live_bytes`` and ``peak_bytes``: the bytes of the storages the ops
  make (an op's outputs that share no input's storage), added when an op
  makes one and taken off when it dies (a weak reference to the storage
  calls back), and their peak over the pass.  Storages made before the pass
  (the step's arguments) are not among them.

A kernel's plain version (the meta device and the CPU run it in the
kernel's place, through ``repro_torch.kernels.run_plain``) counts as the
one launch it stands for: its inputs read and its outputs written and
made, none of its intermediates (B1's plain version holds every score);
its products' FLOPs are counted as they run.  The tensors it names as
written in place (AdamW's parameters and moments) count as read and
written, and as made by no one.
"""

from __future__ import annotations

import weakref
from typing import Any, Iterable

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import plain_watchers

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
    "all_reduce_": "all-reduce",
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
# the namespaces of every op CommDebugMode counts
_COMMS = NAMESPACES + ("c10d",)
_aten = torch.ops.aten
# indexed reads (the rows are the output) and writes (the rows are the
# source; argument position), which touch only the rows they name
_INDEXED_READS = (_aten.index,)
_INDEXED_WRITES = {_aten.index_put_: 2, _aten._index_put_impl_: 2, _aten.index_copy_: 3}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _indexed_bytes(packet, args, out) -> int | None:
    """The bytes an indexed read or write moves: its indices, and the rows
    it reads and writes twice over (read, then written); None for any
    other op."""
    if packet in _INDEXED_READS:
        return _nbytes(_tensors(args[1:], [])) + 2 * _nbytes(_tensors(out, []))
    at = _INDEXED_WRITES.get(packet)
    if at is None:
        return None
    rows = _nbytes(_tensors(args[at], []))
    return _nbytes(_tensors(args[1:at], [])) + 2 * rows


def _tensors(tree: Any, out: list) -> list:
    """The tensors of a tree of tuples, lists and dicts (an op's arguments
    or outputs), appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class CommCounter(CommDebugMode):
    """``CommDebugMode`` that also keeps ``records``, ``(op name, operand
    bytes)`` of every op of the collective namespaces it sees on local
    tensors (``wait_tensor`` among them), ``flops``, the FLOPs of the
    products it sees on them (``torch.utils.flop_counter``'s formulas),
    ``bytes_accessed``, ``live_bytes`` and ``peak_bytes`` (the module's
    docstring): one device's share of the work, when each device runs the
    same program."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[tuple[str, int]] = []
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        # the live storages the ops made: id -> a weak reference whose
        # callback takes the storage's bytes off when it dies
        self._made: dict[int, weakref.ref] = {}
        self._kinds: dict = {}
        self._in_plain = 0

    def __enter__(self):
        plain_watchers.append(self._plain)
        return super().__enter__()

    def __exit__(self, *exc):
        plain_watchers.remove(self._plain)
        return super().__exit__(*exc)

    def _plain(self, fn, args, writes=()):
        """A kernel's plain version run under the counter: one launch, which
        writes ``writes`` in place."""
        self._in_plain += 1
        try:
            out = fn(*args)
        finally:
            self._in_plain -= 1
        self._account(_tensors(args, []), _tensors(out, []), written=_tensors(writes, []))
        return out

    def made(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made by an op this counter saw and
        is alive."""
        return id(t.untyped_storage()) in self._made

    def _free(self, key: int, nbytes: int) -> None:
        del self._made[key]
        self.live_bytes -= nbytes

    def _kind(self, func) -> tuple[bool, bool]:
        """(is a view, is mutable) by ``func``'s schema."""
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            aliased = any(r.alias_info is not None for r in schema.returns)
            kind = self._kinds[func] = (aliased and not schema.is_mutable, schema.is_mutable)
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (isinstance(func, torch._ops.OpOverload) and func.namespace not in _COMMS
                and all(t in _LOCAL for t in types)):
            out = func(*args, **(kwargs or {}))     # CommDebugMode keeps nothing of it
        else:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is NotImplemented or not isinstance(func, torch._ops.OpOverload)
                or any(t not in _LOCAL for t in types)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None):
            # a DTensor op (its local ops come back here), or DTensor's
            # sharding propagation running an op on fake tensors (and making
            # them under its fake mode)
            return out
        kwargs = kwargs or {}
        packet = func._overloadpacket
        collective = func.namespace in NAMESPACES
        if collective:
            self.records.append((packet.__name__, operand_bytes(args)))
        elif packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        view, mutable = self._kind(func)
        if view or self._in_plain:
            return out
        indexed = None if collective else _indexed_bytes(packet, args, out)
        self._account(_tensors(kwargs, _tensors(args, [])), _tensors(out, []),
                      made=not mutable, accessed=not collective and indexed is None)
        self.bytes_accessed += indexed or 0
        return out

    def _account(self, ins, outs, *, made: bool = True, accessed: bool = True,
                 written=()) -> None:
        """Count an op's (or a plain version's) tensors: with ``made``, the
        storages of ``outs`` that no input shares as made; with
        ``accessed``, all their bytes as read or written, and the bytes of
        ``written`` (inputs written in place) once more.  An op that
        writes nothing in place and whose every output shares an input's
        storage is a view by another name (``_unsafe_view``) and counts for
        neither."""
        if made:
            inputs = {id(t.untyped_storage()) for t in ins}
            new = [st for st in (t.untyped_storage() for t in outs) if id(st) not in inputs]
            if outs and not new and not written:
                return
            for st in new:
                self._track(st)
        if accessed:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs + list(written))

    def _track(self, storage) -> None:
        key = id(storage)
        if key in self._made:
            return
        nbytes = storage.nbytes()
        self._made[key] = weakref.ref(storage, lambda _, key=key: self._free(key, nbytes))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)


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
