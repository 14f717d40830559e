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
``DTensor`` they redistribute it.  The models call them where the JAX
models do.

Sharded execution places tensors on a ``DeviceMesh`` as DTensors:
:func:`shard_model` replaces every parameter of a model by one placed by
its axes (JAX's ``jax.device_put(params, tree_shardings(...))``),
:func:`shard_tree` places a batch or a cache by an axes tree, and
:func:`replicate_like` lifts a plain tensor made inside the model (RoPE's
table, a mask, positions) to a replicated DTensor beside a DTensor
partner, since DTensor refuses to mix the two.  :func:`place` never
communicates: every process holds the same full tensor (drawn from one
seed) and keeps its own shard; a meta tensor becomes a DTensor over an
empty meta shard, which the dry run partitions with no devices.

Code that runs on each device's local shards (``local_map`` regions)
reduces and gathers across them with functional collectives over the
groups :func:`shard_groups` names, none on a mesh dimension of one device:
:func:`all_reduce_over` (B5's and B3's combines), :func:`all_gather_over`
(shards stacked in shard order) and :func:`sum_over` (an in-place sum
whose gradient is the output's: the MoE's dispatch and combine).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

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


def constrain_split(x: torch.Tensor, shape: Sequence[int],
                    *logical_axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out as ``constrain(x.reshape(shape), *logical_axes)``
    would, before the reshape, so that the reshape never cuts a shard:
    ``x``'s last dimension is ``shape``'s dimensions from there on merged,
    of which only the first may be sharded (``(B, S, heads·hd)`` split
    into ``(B, S, heads, hd)``).  A no-op where :func:`constrain` is."""
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(logical_axes, shape, ctx.mesh, ctx.rules)
    last = x.dim() - 1
    if any(entry is not None for entry in spec[last + 1:]):
        raise ValueError(f"only the outer part of a split may be sharded: {spec} of {shape}")
    return x.redistribute(ctx.mesh, placements_for(spec[:last + 1], ctx.mesh))


def hold_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, whose gradient is laid out as ``x`` before it flows
    on: DTensor may lay a gradient out otherwise (a product's gradient
    sharded on columns that a view back to heads cannot cut, 8 kv heads
    over 16 devices).  A plain tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


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


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor made inside the model, as a DTensor replicated
    over ``like``'s mesh when ``like`` is a DTensor; else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def place(t: torch.Tensor, mesh: Any, placements: Sequence) -> DTensor:
    """``t``, the full tensor every process holds, as a DTensor with
    ``placements`` on ``mesh``: each process keeps its own shard and nothing
    is sent.  A meta tensor gets an empty meta shard (the dry run)."""
    if t.is_meta:
        local = torch.empty(local_part(t, mesh, placements).shape, dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def local_part(full: torch.Tensor, mesh: Any, placements: Sequence) -> torch.Tensor:
    """This process's shard of ``full`` under ``placements`` (a view: a
    ``torch.chunk`` per sharded mesh dimension, as DTensor cuts)."""
    coord = mesh.get_coordinate()
    for i, placement in enumerate(placements):
        if isinstance(placement, Shard):
            full = full.chunk(mesh.size(i), dim=placement.dim)[coord[i]]
    return full


def shard_model(model: nn.Module, axes: Mapping[str, str], mesh: Any,
                rules: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Replace, in place, every parameter of ``model`` by an ``nn.Parameter``
    holding a DTensor placed on ``mesh`` by its axes (``axes``: parameter
    name → axes string, :func:`repro_torch.models.param_axes`) under
    ``DEFAULT_RULES + rules``; each keeps its ``axes`` and ``requires_grad``.
    Returns ``model``."""
    placements = tree_shardings({name: (p.shape, axes[name])
                                 for name, p in model.named_parameters()}, mesh, rules)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        new = nn.Parameter(place(p.detach(), mesh, placements[name]),
                           requires_grad=p.requires_grad)
        new.axes = axes[name]
        module._parameters[leaf] = new
    return model


def shard_tree(tree: Any, axes: Any, mesh: Any,
               rules: Optional[Mapping[str, Any]] = None) -> Any:
    """A tree of dicts and lists of full tensors (a batch, a cache) placed
    on ``mesh`` by the matching tree of axes strings; the data axis takes
    each process's slice of the batch."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes[k], mesh, rules) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, a, mesh, rules) for v, a in zip(tree, axes))
    return place(tree, mesh, placements_for(pspec(tree.shape, axes, mesh, rules), mesh))


def batch_axes(batch: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """The logical axes of a training or prefill batch's leaves, as JAX's
    input shardings give them: token ids and labels ``batch seq``, vision
    embeddings and audio frames ``batch _ _``, anything else replicated."""
    axes = {}
    for k, v in batch.items():
        if k in ("tokens", "labels"):
            axes[k] = "batch seq"
        elif k in ("vision_embeds", "frames"):
            axes[k] = "batch _ _"
        else:
            axes[k] = " ".join(["_"] * v.dim())
    return axes


def _mesh_axes(like: DTensor, axes: Mapping[str, int]) -> list[Optional[str]]:
    """Per mesh dimension, the name in ``axes`` (axis name → dimension of
    ``like``) of the dimension ``like`` is sharded on there, or None where
    it is replicated; raises where it is sharded on a dimension ``axes``
    does not name, or partial."""
    by_dim = {d: name for name, d in axes.items()}
    names = []
    for p in like.placements:
        if p.is_replicate():
            names.append(None)
        elif isinstance(p, Shard) and p.dim in by_dim:
            names.append(by_dim[p.dim])
        else:
            raise ValueError(f"{tuple(like.shape)} {like.placements} is sharded on another axis "
                             f"than {sorted(axes)}")
    return names


def keep_shards(t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``t`` laid out to run on local shards over ``dims``: on each mesh
    dimension its shard kept where it cuts one of ``dims``, else made whole
    (a partial sum reduced, another dimension's shard gathered).  A plain
    tensor comes back as it is."""
    if not isinstance(t, DTensor):
        return t
    keep = [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in t.placements]
    return t if list(t.placements) == keep else t.redistribute(t.device_mesh, keep)


def on_local_shards(fn, like: DTensor, axes: Mapping[str, int], args: Sequence,
                    out_axes: Sequence[Mapping[str, int]]):
    """``fn`` on each device's local shards, through ``local_map``, where
    ``like`` sets the layout: on each mesh dimension it shards one named
    axis (``axes``: name → its dimension of ``like``)
    or none.  ``args`` are ``(value, {name: dimension})`` pairs: a tensor
    is laid out sharded on its own dimension of each axis ``like`` shards
    (replicated where it has no such dimension: its gradient there is a
    partial sum), anything else is passed as it is.  ``out_axes`` names
    each output's dimensions the same way; one output unless several are
    given.  Attention cores run this way on their local batch rows and
    heads, where DTensor would flatten two sharded dimensions."""
    mesh = like.device_mesh
    names = _mesh_axes(like, axes)

    def layout(dims):
        return [Shard(dims[n]) if n in dims else Replicate() for n in names]

    def grads(dims):
        return [Replicate() if n is None else Shard(dims[n]) if n in dims else Partial()
                for n in names]

    placed, in_p, in_g = [], [], []
    for value, dims in args:
        if isinstance(value, torch.Tensor):
            value = replicate_like(value, like)
            if list(value.placements) != layout(dims):    # else in place: a cache written
                value = value.redistribute(mesh, layout(dims))
            in_p.append(layout(dims))
            in_g.append(grads(dims))
        else:
            in_p.append(None)
            in_g.append(None)
        placed.append(value)
    outs = [layout(dims) for dims in out_axes]
    return local_map(fn, out_placements=tuple(outs) if len(outs) > 1 else outs[0],
                     in_placements=tuple(in_p), in_grad_placements=tuple(in_g),
                     device_mesh=mesh)(*placed)


def shard_groups(like: DTensor, dim: int) -> tuple[str, ...]:
    """The names of the process groups of the mesh dimensions that split
    ``like`` along ``dim`` into more than one shard, major to minor: the
    groups a reduction over that dimension's shards runs on."""
    mesh = like.device_mesh
    return tuple(mesh.get_group(i).group_name for i, p in enumerate(like.placements)
                 if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1)


def shard_group(like: DTensor, dim: int) -> Optional[str]:
    """The name of one process group over the devices that split ``like``
    along ``dim`` (where several mesh dimensions do, their flattened
    mesh's), or None when no mesh dimension of more than one device does:
    a reduction over that dimension's shards is one collective on it."""
    mesh = like.device_mesh
    names = tuple(mesh.mesh_dim_names[i] for i, p in enumerate(like.placements)
                  if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1)
    if not names:
        return None
    sub = mesh[names[0]] if len(names) == 1 else mesh[names]._flatten("_".join(names))
    return sub.get_group().group_name


def all_reduce_over(groups: Sequence[str]):
    """``reduce(t, op)``: ``t`` all-reduced with ``op`` ("max" or "sum")
    over each process group in ``groups``, in order, as functional
    collectives (a CUDA graph captures them); None for no group.  Every
    rank of a group sums the same values in the same order, so every rank
    gets the same bits."""
    if not groups:
        return None

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        c10d = torch.ops._c10d_functional
        for name in groups:
            t = c10d.wait_tensor(c10d.all_reduce(t, op, name))
        return t

    return reduce


def shard_offset(like: DTensor, dim: int) -> int:
    """Where this process's shard of ``like`` starts along ``dim``: a
    ``torch.chunk`` per mesh dimension sharding it, major to minor."""
    return placed_offset(like.device_mesh, like.placements, like.shape[dim], dim)


def placed_offset(mesh: Any, placements: Sequence, size: int, dim: int) -> int:
    """Where this process's shard starts along ``dim`` (of ``size``) of a
    tensor laid out by ``placements`` on ``mesh``: :func:`shard_offset`
    before the tensor exists."""
    start, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            size = -(-size // mesh.size(i))
            start += coord[i] * size
    return start


def all_gather_over(groups: Sequence[str]):
    """``gather(t)``: every shard's ``t`` over the process groups
    ``groups`` (major to minor), stacked as ``(shards, *t.shape)`` in shard
    order, the order :func:`shard_offset` cuts them in; functional
    collectives (a CUDA graph captures them), none for no group.  No
    gradient flows through it."""
    if not groups:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group

    sizes = [_resolve_process_group(name).size() for name in groups]

    def gather(t: torch.Tensor) -> torch.Tensor:
        c10d = torch.ops._c10d_functional
        out = t.reshape(-1)
        for name, n in zip(reversed(groups), reversed(sizes)):    # minor first
            out = c10d.wait_tensor(c10d.all_gather_into_tensor(out, n, name))
        return out.view(math.prod(sizes), *t.shape)

    return gather


class _SumOver(torch.autograd.Function):
    """``t`` summed in place over the process groups ``groups``; the
    gradient is the output's, unchanged: every rank's ``t`` enters the sum
    once, and the sum is the same on every rank, so each rank's gradient
    of it is the one its callers give."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, groups: tuple) -> torch.Tensor:
        c10d = torch.ops._c10d_functional
        for name in groups:
            c10d.wait_tensor(c10d.all_reduce_(t, "sum", name))
        ctx.mark_dirty(t)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(t: torch.Tensor, groups: Sequence[str]) -> torch.Tensor:
    """``t``, a contiguous tensor no one else reads, summed in place over
    each process group in ``groups``, in order (no collective for no
    group), as functional collectives; its gradient is the output's.  A
    sum whose every entry has one nonzero term is exact, and every rank
    gets the same bits."""
    return _SumOver.apply(t, tuple(groups)) if groups else t
