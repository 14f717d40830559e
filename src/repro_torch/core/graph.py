"""Task graph IR: the operator-level DAG that Nimble schedules.

A :class:`TaskGraph` is a finite DAG ``G = (V, E)`` whose nodes are *tasks*
(operators — a GPU kernel on the paper's hardware, one aten operator here)
and whose edges are data/control dependencies.  This is the input to the
stream-assignment algorithm (paper Alg. 1) and to the AoT scheduler.

The IR is deliberately minimal and framework-agnostic: nodes carry an opaque
``op`` payload (a callable, an FX node, or nothing for synthetic graphs
used in tests/benchmarks) plus shape/dtype metadata used by the memory
planner and the packing rewriter.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Hashable, Iterable, Iterator, Mapping, Sequence


@dataclasses.dataclass
class Task:
    """One schedulable unit (an operator / GPU task in the paper's terms)."""

    id: int
    name: str
    op: Any = None                      # opaque payload (callable / eqn / None)
    out_shapes: tuple = ()              # tuple[tuple[int,...]] of outputs
    out_dtypes: tuple = ()              # tuple[str]
    flops: float = 0.0                  # estimated compute, for cost models
    kind: str = "generic"               # e.g. "matmul", "ewise", "reduce"
    meta: dict = dataclasses.field(default_factory=dict)

    def __hash__(self) -> int:
        return self.id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Task({self.id}:{self.name})"


class TaskGraph:
    """A DAG of :class:`Task` nodes with O(1) edge queries.

    Node ids are dense ints ``0..n-1`` assigned at :meth:`add_task` time.
    """

    def __init__(self) -> None:
        self.tasks: list[Task] = []
        self._succ: list[set[int]] = []
        self._pred: list[set[int]] = []

    # -- construction ------------------------------------------------------
    def add_task(self, name: str, **kw: Any) -> Task:
        t = Task(id=len(self.tasks), name=name, **kw)
        self.tasks.append(t)
        self._succ.append(set())
        self._pred.append(set())
        return t

    def add_edge(self, u: int | Task, v: int | Task) -> None:
        ui = u.id if isinstance(u, Task) else u
        vi = v.id if isinstance(v, Task) else v
        if ui == vi:
            raise ValueError(f"self-edge on node {ui}")
        self._succ[ui].add(vi)
        self._pred[vi].add(ui)

    @classmethod
    def from_edges(
        cls, n: int, edges: Iterable[tuple[int, int]], names: Sequence[str] | None = None
    ) -> "TaskGraph":
        g = cls()
        for i in range(n):
            g.add_task(names[i] if names else f"t{i}")
        for u, v in edges:
            g.add_edge(u, v)
        if not g.is_acyclic():
            raise ValueError("edge list forms a cycle; TaskGraph must be a DAG")
        return g

    # -- queries -----------------------------------------------------------
    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def successors(self, v: int) -> frozenset[int]:
        return frozenset(self._succ[v])

    def predecessors(self, v: int) -> frozenset[int]:
        return frozenset(self._pred[v])

    def edges(self) -> Iterator[tuple[int, int]]:
        for u, outs in enumerate(self._succ):
            for v in sorted(outs):
                yield (u, v)

    @property
    def num_edges(self) -> int:
        return sum(len(s) for s in self._succ)

    def has_edge(self, u: int, v: int) -> bool:
        return v in self._succ[u]

    def topo_order(self) -> list[int]:
        """Kahn's algorithm; raises on cycles."""
        indeg = [len(self._pred[v]) for v in range(self.num_tasks)]
        q = deque(v for v, d in enumerate(indeg) if d == 0)
        order: list[int] = []
        while q:
            v = q.popleft()
            order.append(v)
            for w in sorted(self._succ[v]):
                indeg[w] -= 1
                if indeg[w] == 0:
                    q.append(w)
        if len(order) != self.num_tasks:
            raise ValueError("graph has a cycle")
        return order

    def is_acyclic(self) -> bool:
        try:
            self.topo_order()
            return True
        except ValueError:
            return False

    def reachability(self) -> list[set[int]]:
        """``reach[u]`` = set of nodes reachable from u (excluding u itself
        unless u lies on a cycle, which a DAG forbids).  O(V·E/64) via
        bitset-free set union in reverse topological order."""
        reach: list[set[int]] = [set() for _ in range(self.num_tasks)]
        for v in reversed(self.topo_order()):
            for w in self._succ[v]:
                reach[v].add(w)
                reach[v] |= reach[w]
        return reach

    def depth(self) -> list[int]:
        """Longest-path depth of each node (roots have depth 0)."""
        d = [0] * self.num_tasks
        for v in self.topo_order():
            for w in self._succ[v]:
                d[w] = max(d[w], d[v] + 1)
        return d

    def critical_path_cost(self, cost: Callable[[Task], float]) -> float:
        """Cost of the longest (weighted) path — the paper's *critical path
        time* (Fig. 2c): the lower bound on runtime under perfect task
        parallelism."""
        best = [0.0] * self.num_tasks
        for v in self.topo_order():
            best[v] += cost(self.tasks[v])
            for w in self._succ[v]:
                best[w] = max(best[w], best[v])
        return max(best, default=0.0)

    def total_cost(self, cost: Callable[[Task], float]) -> float:
        return sum(cost(t) for t in self.tasks)

    # -- max antichain = degree of logical concurrency ----------------------
    def max_logical_concurrency(self) -> int:
        """Paper Table 1's *Deg.*: the largest set of pairwise-incomparable
        nodes (maximum antichain).  By Mirsky/Dilworth duality on the
        *comparability* relation we compute it as ``n - |maximum matching of
        the transitive-closure bipartite graph|`` (minimum path cover of the
        closure).  Exact, polynomial."""
        from .matching import hopcroft_karp

        reach = self.reachability()
        adj = [sorted(reach[u]) for u in range(self.num_tasks)]
        m = hopcroft_karp(self.num_tasks, self.num_tasks, adj)
        return self.num_tasks - sum(1 for x in m if x >= 0)

    # -- io ------------------------------------------------------------------
    def to_dot(self, streams: Mapping[int, int] | None = None) -> str:
        palette = [
            "lightblue", "lightyellow", "lightpink", "lightgreen", "orange",
            "violet", "cyan", "tan", "tomato", "gold",
        ]
        lines = ["digraph G {"]
        for t in self.tasks:
            color = ""
            if streams is not None:
                color = f' style=filled fillcolor="{palette[streams[t.id] % len(palette)]}"'
            lines.append(f'  n{t.id} [label="{t.name}"{color}];')
        for u, v in self.edges():
            lines.append(f"  n{u} -> n{v};")
        lines.append("}")
        return "\n".join(lines)

    def copy(self) -> "TaskGraph":
        g = TaskGraph()
        g.tasks = [dataclasses.replace(t) for t in self.tasks]
        g._succ = [set(s) for s in self._succ]
        g._pred = [set(p) for p in self._pred]
        return g
