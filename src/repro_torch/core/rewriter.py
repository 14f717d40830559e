"""Graph rewriting: stream packing, the single-launch alternative to streams.

Paper §4.2 assigns independent operators to different CUDA streams so the
GPU overlaps them; core/aot.py captures exactly that.  This pass runs
Algorithm 1's concurrency the other way: it **packs** groups of mutually
independent, identically shaped tasks that live on different streams into
one launch (horizontal fusion).  k independent ``(M,K) x (K,N)`` products
become one stream_pack kernel (B2) over k lanes; k elementwise operators
become one operator over the stacked lanes (``torch.vmap`` of the aten
operator, the counterpart of the JAX package's ``vmap(prim.bind)``).

Grouping rule (as in the JAX package): tasks are packable when they
  * are assigned different streams by Algorithm 1 (logically concurrent),
  * sit at the same DAG depth (same-depth nodes are provably unordered),
  * run the same aten operator with identical non-tensor arguments and
    identical input shapes/dtypes,
  * have a single tensor output, draw no random numbers, and take tensors
    only as direct arguments.
Among the matmul kind only ``aten.mm`` packs, onto B2.  A group whose
members share their left operand (parallel branches off one activation)
passes it once, with lane stride 0; weights that are function inputs are
stacked once at schedule time, and re-stacked in place only when written.

Synchronization edges from the sync plan map to the data dependencies of
the packed op's consumers — the join is free (an unbind), which is why the
minimum-sync objective of Algorithm 1 matters: every avoided sync edge is an
avoided join boundary between packs.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable

import torch
from torch import fx

from repro_torch.kernels.stream_pack import stream_pack

from .streams import StreamAssignment
from .trace import TracedGraph, op_name, read

_PACKABLE_KINDS = {"matmul", "ewise"}


@dataclasses.dataclass
class PackReport:
    num_groups: int = 0
    packed_tasks: int = 0
    total_tasks: int = 0
    groups: list = dataclasses.field(default_factory=list)  # [(aten op, size)]
    baked_groups: int = 0                                   # AoT-prestacked

    @property
    def packed_fraction(self) -> float:
        return self.packed_tasks / self.total_tasks if self.total_tasks else 0.0


def _arg_signature(a) -> tuple:
    if isinstance(a, fx.Node):
        v = a.meta.get("val")
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), str(v.dtype))
        return ("value", repr(v))
    return ("lit", repr(a))


def _node_signature(node: fx.Node) -> tuple:
    return (
        str(node.target),
        tuple(_arg_signature(a) for a in node.args),
        tuple(sorted((k, _arg_signature(v)) for k, v in node.kwargs.items())),
    )


def _packable(node: fx.Node, kind: str) -> bool:
    if kind not in _PACKABLE_KINDS or (kind == "matmul" and op_name(node) != "mm"):
        return False
    if not isinstance(node.meta.get("val"), torch.Tensor):
        return False                        # several outputs, or none
    if torch.Tag.nondeterministic_seeded in getattr(node.target, "tags", ()):
        return False                        # draws random numbers
    # tensors only as direct arguments, never inside a list
    direct = {a for a in (*node.args, *node.kwargs.values()) if isinstance(a, fx.Node)}
    return set(node.all_input_nodes) <= direct and not any(
        isinstance(v, fx.Node) for v in node.kwargs.values())


def plan_packs(traced: TracedGraph, sa: StreamAssignment) -> tuple[list, PackReport]:
    """Compute the packed execution plan: an ordered list of steps, each
    either ``("one", node)`` or ``("pack", [nodes])``."""
    g = traced.graph
    nodes = traced.node_of_task
    depth = g.depth()

    # bucket candidates by (depth, signature)
    buckets: dict[tuple, list[int]] = defaultdict(list)
    for t in g.tasks:
        node = nodes[t.id]
        if _packable(node, t.kind):
            buckets[(depth[t.id], _node_signature(node))].append(t.id)

    group_of: dict[int, int] = {}
    groups: list[list[int]] = []
    for key, tids in buckets.items():
        # packable only across *different* streams (that's the semantics:
        # same-stream tasks are serialized by FIFO order anyway)
        by_stream: dict[int, list[int]] = defaultdict(list)
        for tid in tids:
            by_stream[sa.stream_of[tid]].append(tid)
        # one representative per stream per group instance
        lanes = [v[:] for v in by_stream.values()]
        while sum(1 for l in lanes if l) >= 2:
            members = [l.pop() for l in lanes if l]
            gi = len(groups)
            groups.append(sorted(members))
            for m in members:
                group_of[m] = gi

    # Emit steps in depth-level order (a valid topological order in which
    # group members — all at equal depth — are adjacent).
    order = sorted(range(g.num_tasks), key=lambda v: (depth[v], v))
    steps: list = []
    emitted_groups: set[int] = set()
    for tid in order:
        gi = group_of.get(tid)
        if gi is None:
            steps.append(("one", nodes[tid]))
        elif gi not in emitted_groups:
            emitted_groups.add(gi)
            steps.append(("pack", [nodes[m] for m in groups[gi]]))

    report = PackReport(
        num_groups=len(groups),
        packed_tasks=sum(len(m) for m in groups),
        total_tasks=g.num_tasks,
        groups=[(op_name(nodes[m[0]]), len(m)) for m in groups],
    )
    return steps, report


def _shared(members: list[fx.Node], i: int) -> bool:
    """All pack members read the same graph node at argument slot i."""
    a0 = members[0].args[i]
    return isinstance(a0, fx.Node) and all(m.args[i] is a0 for m in members[1:])


def pack_streams_fn(
    fn: Callable,
    traced: TracedGraph,
    sa: StreamAssignment,
    example_args: tuple = (),
) -> Callable:
    """Return a callable equivalent to ``fn`` that executes the packed plan.

    Each ``mm`` group runs as one B2 launch (``stream_pack``: the kernel on
    CUDA tensors, its plain version on CPU ones); each other group runs its
    aten operator once over lanes stacked on a new leading axis.  A lane
    input that a previous group produced in the same lane order is read from
    that group's output without a copy.

    **AoT argument preparation** (the paper's "function arguments … recorded
    in the task schedule"): when ``example_args`` are given, pack-group
    inputs that are direct function inputs (typically the per-branch weights)
    are stacked ONCE at schedule time and baked into the schedule — per-call
    work only stacks activation inputs.  A baked stack follows the example
    tensors it was stacked from: ``.refresh_baked()`` re-stacks, in place,
    the lanes of every example tensor written since (by a CUDA-graph replay
    that copied a caller's weights into it, or by an update in place), and a
    call with other tensors than the example ones stacks those afresh.

    The callable takes ``fn``'s arguments; ``.run_flat(flat_args)`` takes
    them flattened and returns ``(flat_outputs, env)``, ``env`` holding
    every intermediate.  ``.report`` is the :class:`PackReport`.
    """
    steps, report = plan_packs(traced, sa)

    # --- AoT: pre-stack lane inputs that are function inputs --------------
    # baked[step][slot] = (stack, flat index of each lane's example tensor)
    baked: dict[int, dict[int, tuple[torch.Tensor, list[int]]]] = {}
    examples: list = []
    stacked_at: dict[int, int] = {}        # flat index -> its _version when stacked
    if example_args:
        examples = traced.flatten_args(example_args)
        index_of = {p: j for j, p in enumerate(traced.placeholders)}
        for si, (kind, members) in enumerate(steps):
            if kind != "pack":
                continue
            for i, a0 in enumerate(members[0].args):
                if not isinstance(a0, fx.Node) or _shared(members, i):
                    continue
                if all(m.args[i] in index_of for m in members):
                    js = [index_of[m.args[i]] for m in members]
                    with torch.no_grad():
                        stack = torch.stack([examples[j] for j in js])
                    baked.setdefault(si, {})[i] = (stack, js)
                    stacked_at.update((j, examples[j]._version) for j in js)
        report.baked_groups = sum(1 for v in baked.values() if v)

    def refresh_baked() -> None:
        """Copy every example tensor written since it was stacked into its
        lanes of the baked stacks (no allocation, on the current stream)."""
        stale = {j for j, v in stacked_at.items() if examples[j]._version != v}
        if not stale:
            return
        with torch.no_grad():
            for pre in baked.values():
                for stack, js in pre.values():
                    for lane, j in enumerate(js):
                        if j in stale:
                            stack[lane].copy_(examples[j])
        for j in stale:
            stacked_at[j] = examples[j]._version

    def run_flat(flat_args: list) -> tuple[list, dict]:
        refresh_baked()
        env = traced.input_env(flat_args)
        lane_of: dict[fx.Node, tuple[torch.Tensor, int]] = {}   # node -> (pack, lane)

        def lanes(members: list[fx.Node], i: int, pre: dict) -> torch.Tensor:
            """Argument slot i of every member, stacked on a leading axis."""
            if i in pre and all(flat_args[j] is examples[j] for j in pre[i][1]):
                return pre[i][0]
            srcs = [lane_of.get(m.args[i]) for m in members]
            if all(srcs) and all(s[0] is srcs[0][0] for s in srcs) \
                    and [s[1] for s in srcs] == list(range(srcs[0][0].shape[0])):
                return srcs[0][0]        # one earlier pack, in this lane order
            return torch.stack([read(env, m.args[i]) for m in members])

        for si, (kind, payload) in enumerate(steps):
            if kind == "one":
                traced.run_task(payload, env)
                continue
            members, pre = payload, baked.get(si, {})
            m0 = members[0]
            if op_name(m0) == "mm":
                x = read(env, m0.args[0]) if _shared(members, 0) else lanes(members, 0, pre)
                out = stream_pack(x, lanes(members, 1, pre))
            else:
                tensor_slots = [i for i, a in enumerate(m0.args) if isinstance(a, fx.Node)]
                batched = [i for i in tensor_slots if not _shared(members, i)]
                args = list(m0.args)
                for i in tensor_slots:
                    args[i] = read(env, m0.args[i])
                if not batched:                 # every member reads the same inputs
                    one = m0.target(*args, **m0.kwargs)
                    for m in members:
                        env[m] = one
                    continue

                def lane_op(*xs, _args=args, _batched=batched, _op=m0.target, _kw=m0.kwargs):
                    full = list(_args)
                    for i, v in zip(_batched, xs):
                        full[i] = v
                    return _op(*full, **_kw)

                out = torch.vmap(lane_op)(*(lanes(members, i, pre) for i in batched))
            for k, m in enumerate(members):
                env[m] = out[k]
                lane_of[m] = (out, k)
        return traced.outputs(env), env

    def packed_fn(*args: Any) -> Any:
        return traced.unflatten_out(run_flat(traced.flatten_args(args))[0])

    packed_fn.run_flat = run_flat      # type: ignore[attr-defined]
    packed_fn.refresh_baked = refresh_baked  # type: ignore[attr-defined]
    packed_fn.report = report          # type: ignore[attr-defined]
    return packed_fn
