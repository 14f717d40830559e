"""Logical-axis sharding rules (MaxText-style), the JAX package's
``distributed/sharding.py`` for DTensor.

Parameters, caches and activations are annotated with *logical* axis
names; a rule table maps logical axes to mesh axes.  An axis is sharded
only when its size divides the product of the mapped mesh axes, and no
mesh axis shards two dimensions of one tensor; otherwise it is replicated
(e.g. phi4's 24 query heads on a 16-way model axis).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any object
with ``mesh_dim_names`` and a ``shape`` (``launch.mesh.MeshSpec``, the
production mesh as a description), so the dry run maps a model onto 512
devices with no process group.  :func:`logical_to_pspec` gives JAX's
``PartitionSpec`` entries as a plain tuple (per tensor dimension: None, a
mesh axis name, or a tuple of them); :func:`placements_for` turns that
into DTensor placements, one per mesh dimension.

``use_sharding_ctx(mesh, rules)`` installs a thread-local context so that
model code can call ``constrain(x, "batch", "seq", "embed")`` without
threading the mesh through every function.  Outside a context, and on a
plain tensor, ``constrain`` and ``gather_fsdp`` return their input; on a
``DTensor`` they redistribute it.  The models call neither yet: the call
sites come with sharded execution.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),   # weight-shard dim for FSDP/ZeRO
    "embed": None,              # activations' feature dim: replicated
    "seq": None,
    "kv_seq": None,             # decode KV cache sequence dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "state": None,
    "lora": None,
}

# Rules for the long-context decode shape: batch=1 so the data axis instead
# shards the KV-cache sequence dimension (sequence/context parallelism).
LONG_CONTEXT_OVERRIDES: dict[str, Any] = {
    "kv_seq": ("pod", "data"),
    "batch": None,
}

Spec = tuple  # per tensor dimension: None, a mesh axis name, or a tuple of them


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any
    rules: dict[str, Any]


_tls = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_tls, "ctx", None)


def with_defaults(rules: Optional[Mapping[str, Any]] = None) -> dict[str, Any]:
    """:data:`DEFAULT_RULES` updated with ``rules``."""
    return {**DEFAULT_RULES, **(rules or {})}


@contextlib.contextmanager
def use_sharding_ctx(mesh: Any, rules: Optional[dict] = None) -> Iterator[Optional[ShardingCtx]]:
    """Install ``(mesh, DEFAULT_RULES + rules)`` for this thread; a None
    mesh clears the context inside the block."""
    prev = current_ctx()
    _tls.ctx = None if mesh is None else ShardingCtx(mesh=mesh, rules=with_defaults(rules))
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Mesh axis name → its size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _filter_entry(mesh: Any, entry: Any) -> Any:
    """Drop mesh axes absent from this mesh (e.g. 'pod' on single-pod)."""
    present = tuple(a for a in _axes(entry) if a in mesh.mesh_dim_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def logical_to_pspec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Any,
    rules: Mapping[str, Any],
) -> Spec:
    """Map logical axes to PartitionSpec entries, respecting divisibility
    and never using one mesh axis twice."""
    sizes = axis_sizes(mesh)
    entries = []
    used: set[str] = set()
    for ax_name, dim in zip(logical_axes, shape):
        entry = None
        if ax_name is not None:
            entry = _filter_entry(mesh, rules.get(ax_name))
            axes = _axes(entry)
            size = math.prod(sizes[a] for a in axes)
            if any(a in used for a in axes) or size <= 1 or dim % size != 0:
                entry = None
            else:
                used.update(axes)
        entries.append(entry)
    return tuple(entries)


def placements_for(spec: Spec, mesh: Any) -> list:
    """DTensor placements of ``spec``, one per mesh dimension: ``Shard(d)``
    where the mesh axis shards tensor dimension ``d``, else
    ``Replicate()``.  A dimension over several mesh axes (``("pod",
    "data")``) is sharded by each, major to minor, as in JAX."""
    by_axis = {a: dim for dim, entry in enumerate(spec) for a in _axes(entry)}
    return [Shard(by_axis[name]) if name in by_axis else Replicate()
            for name in mesh.mesh_dim_names]


def local_shape(shape: Sequence[int], spec: Spec, mesh: Any) -> tuple[int, ...]:
    """One device's share of a tensor of ``shape`` laid out by ``spec``:
    each sharded dimension divided by its mesh axes' size."""
    sizes = axis_sizes(mesh)
    return tuple(dim // math.prod(sizes[a] for a in _axes(entry))
                 for dim, entry in zip(shape, spec))


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by its logical axes under the installed context: a
    ``DTensor`` is redistributed; a plain tensor, or any tensor outside a
    context, comes back as it is."""
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(logical_axes, x.shape, ctx.mesh, ctx.rules)
    return x.redistribute(ctx.mesh, placements_for(spec, ctx.mesh))


def gather_fsdp(x: torch.Tensor, *logical_axes: Optional[str],
                group: str = "all") -> torch.Tensor:
    """FSDP weight-gather at use: re-constrain a parameter with its ``fsdp``
    dims replicated, so contractions see a full (weight-gathered) operand.

    Opt-in via the rules entry ``{"gather_fsdp": "all" | "moe" | "attn" |
    "ffn"}``, off by default, as in JAX; a no-op outside a context and on
    a plain tensor."""
    ctx = current_ctx()
    if ctx is None:
        return x
    mode = ctx.rules.get("gather_fsdp", "off")
    if mode != "all" and mode != group:
        return x
    return constrain(x, *(None if a == "fsdp" else a for a in logical_axes))


def parse_axes(spec: str) -> tuple[Optional[str], ...]:
    """Parse a whitespace-separated logical-axes string; ``_`` = replicated."""
    if not spec:
        return ()
    return tuple(None if tok == "_" else tok for tok in spec.split())


def tree_shardings(
    leaves: Mapping[str, tuple[Sequence[int], str]],
    mesh: Any,
    rules: Optional[Mapping[str, Any]] = None,
) -> dict[str, list]:
    """``{name: (shape, axes string)}`` → ``{name: DTensor placements}``
    under ``DEFAULT_RULES + rules`` (JAX's ``tree_shardings`` over a
    flattened tree)."""
    return {name: placements_for(pspec(shape, axes, mesh, rules), mesh)
            for name, (shape, axes) in leaves.items()}


def pspec(shape: Sequence[int], axes: str, mesh: Any,
          rules: Optional[Mapping[str, Any]] = None) -> Spec:
    """:func:`logical_to_pspec` of an axes string under ``DEFAULT_RULES +
    rules``; raises if the axes' rank is not the shape's."""
    parsed = parse_axes(axes)
    if len(parsed) != len(shape):
        raise ValueError(f"axes {axes!r} rank {len(parsed)} != shape {tuple(shape)}")
    return logical_to_pspec(parsed, shape, mesh, with_defaults(rules))
