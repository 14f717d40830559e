"""Capture a TaskGraph from a PyTorch function (the "pre-run" trace source).

Nimble's pre-run intercepts the GPU tasks the base framework emits.  Here
``make_fx`` traces the function at the shapes of its example arguments into
an FX graph of aten operators: each ``call_function`` node is a task, and its
def-use chains are the dependency edges.  The graph is shape-specialized, so
the paper's static-network/fixed-shape precondition holds by construction.

The function is traced through ``torch.func.functionalize``, so in-place
operators inside it become out-of-place ones and the def-use edges are every
dependency.  A function that writes into its own arguments is refused: the
task graph could not order that write after the argument's other readers.

Tracing runs under ``FakeTensorMode`` (``tracing_mode="fake"``): no kernel
runs and the example arguments may be tensors on the ``meta`` device, as
``ScheduleKey`` allows.  ``operator.getitem`` nodes, which pick one output
of a multi-output operator, are not tasks: they stand for their producer.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable

import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from .graph import TaskGraph

# Operators that are pure metadata / layout and cost ~nothing (the
# counterparts of the JAX package's _FREE_PRIMS and _MATMUL_PRIMS)
_LAYOUT_OPS = {
    "view", "reshape", "t", "transpose", "permute", "expand", "squeeze",
    "unsqueeze", "slice", "cat", "_to_copy",
}
_MATMUL_OPS = {"mm", "bmm", "addmm", "convolution"}


def op_name(node: fx.Node) -> str:
    """The aten operator's name without its overload (``"mm"`` for
    ``aten.mm.default``)."""
    return node.target.overloadpacket.__name__


def out_vals(node: fx.Node) -> tuple:
    """The fake values of a node's outputs, one per output."""
    val = node.meta.get("val")
    return tuple(val) if isinstance(val, (tuple, list)) else (val,)


def read(env: dict, node: fx.Node) -> Any:
    """The value of ``node`` in ``env``; an ``operator.getitem`` node, which
    is not a task, picks from its producer's value."""
    if node in env:
        return env[node]
    if node.op == "call_function" and node.target is operator.getitem:
        return read(env, node.args[0])[node.args[1]]
    raise KeyError(f"{node} has no value yet")


def _shape(v) -> tuple[int, ...]:
    return tuple(int(d) for d in v.shape) if isinstance(v, torch.Tensor) else ()


def _bytes(v) -> int:
    return v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 0


def _flops_of_node(node: fx.Node) -> float:
    """Analytic FLOP estimate per task: exact for mm/bmm/addmm, one per
    output element otherwise."""
    name = op_name(node)
    if name in ("mm", "bmm", "addmm"):
        a, b = (node.args[1], node.args[2]) if name == "addmm" else node.args[:2]
        sa, sb = _shape(a.meta["val"]), _shape(b.meta["val"])
        batch = sa[0] if name == "bmm" else 1
        m, k, n = sa[-2], sa[-1], sb[-1]
        return 2.0 * batch * m * n * k
    total = 0.0
    for v in out_vals(node):
        if isinstance(v, torch.Tensor):
            total += v.numel()
    return total


@dataclasses.dataclass
class TracedGraph:
    """TaskGraph + bookkeeping to re-execute it (see core/aot.py and
    core/engine.py)."""

    graph: TaskGraph
    gm: fx.GraphModule
    n_inputs: int
    node_of_task: list = dataclasses.field(default_factory=list)
    in_tree: Any = None             # TreeSpec of (args,)
    out_tree: Any = None            # TreeSpec of the function output
    # the flattened outputs: graph nodes, or constants such as None
    output_nodes: list = dataclasses.field(default_factory=list)

    @property
    def placeholders(self) -> list[fx.Node]:
        """One graph input per flattened argument leaf, in order."""
        return [n for n in self.gm.graph.nodes if n.op == "placeholder"]

    def input_env(self, flat_args: list) -> dict:
        """The environment a run starts from: each placeholder bound to its
        flattened argument, each constant the trace lifted to its value."""
        env: dict = dict(zip(self.placeholders, flat_args))
        for n in self.gm.graph.nodes:
            if n.op == "get_attr":
                env[n] = getattr(self.gm, n.target)
        return env

    def run_task(self, node: fx.Node, env: dict) -> None:
        """Run one task on the current stream; its result goes into ``env``."""
        args, kwargs = fx.node.map_arg((node.args, node.kwargs), lambda n: read(env, n))
        env[node] = node.target(*args, **kwargs)

    def outputs(self, env: dict) -> list:
        """The flattened outputs of a finished run."""
        return [read(env, n) if isinstance(n, fx.Node) else n for n in self.output_nodes]

    def flatten_args(self, args: tuple) -> list:
        flat, treedef = pytree.tree_flatten(args)
        if self.in_tree is not None and treedef != self.in_tree:
            raise TypeError(f"input structure changed: {treedef} vs {self.in_tree}")
        return flat

    def unflatten_out(self, flat_out: list) -> Any:
        if self.out_tree is None:
            return flat_out[0] if len(flat_out) == 1 else tuple(flat_out)
        return pytree.tree_unflatten(flat_out, self.out_tree)


def trace_to_taskgraph(fn: Callable, *example_args: Any) -> TracedGraph:
    """Trace ``fn`` at the shapes of ``example_args`` and lift to a TaskGraph."""
    def call(*args):                 # traced by position: fn's defaults stay out
        return fn(*args)

    gm = make_fx(torch.func.functionalize(call, remove="mutations"),
                 tracing_mode="fake")(*example_args)
    _, in_tree = pytree.tree_flatten(example_args)
    out = next(n for n in reversed(gm.graph.nodes) if n.op == "output")
    info = getattr(gm.graph._codegen, "pytree_info", None)
    if info is not None:             # pytree arguments: the output is flat
        output_nodes, out_tree = list(out.args[0]), info.out_spec
    else:
        output_nodes, out_tree = pytree.tree_flatten(out.args[0])

    g = TaskGraph()
    node_of_task: list[fx.Node] = []
    producer: dict[fx.Node, int] = {}   # graph node -> producing task id
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            src = producer.get(node.args[0])
            if src is not None:
                producer[node] = src
            continue
        schema = getattr(node.target, "_schema", None)
        if schema is not None and schema.is_mutable:
            raise ValueError(
                f"{fn!r} writes into an argument ({node.target}): Nimble "
                "schedules functions that leave their inputs unchanged")
        vals = out_vals(node)
        t = g.add_task(
            op_name(node),
            op=node,
            out_shapes=tuple(_shape(v) for v in vals),
            out_dtypes=tuple(str(v.dtype) if isinstance(v, torch.Tensor) else "" for v in vals),
            flops=_flops_of_node(node),
            kind=(
                "matmul" if op_name(node) in _MATMUL_OPS
                else "layout" if op_name(node) in _LAYOUT_OPS
                else "ewise"
            ),
        )
        t.meta["out_bytes"] = sum(_bytes(v) for v in vals)
        node_of_task.append(node)
        for inp in node.all_input_nodes:
            p = producer.get(inp)
            if p is not None and p != t.id:
                g.add_edge(p, t.id)
        producer[node] = t.id

    return TracedGraph(
        graph=g,
        gm=gm,
        n_inputs=sum(1 for n in gm.graph.nodes if n.op == "placeholder"),
        node_of_task=node_of_task,
        in_tree=in_tree,
        out_tree=out_tree,
        output_nodes=output_nodes,
    )
