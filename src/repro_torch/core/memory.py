"""Static memory planning (Nimble's "reserve GPU memory during pre-run").

During its pre-run Nimble intercepts every allocate/free the base framework
issues and reserves exactly that memory for replay; the run loop then never
touches the allocator.  We reproduce this at task-schedule granularity:

1. from the task schedule, derive each intermediate buffer's *lifetime*
   [def_index, last_use_index] in submission order;
2. pack buffers into a single arena with a greedy best-fit offset assignment
   (buffers with disjoint lifetimes may alias the same bytes — the classic
   "memory reuse" a caching allocator gives PyTorch, made static here);
3. the resulting :class:`MemoryPlan` has a fixed arena size and per-buffer
   offsets.

On the card the schedule's CUDA graph does not index this arena yet: its
private memory pool keeps every intermediate of the capture allocated (see
core/aot.py), so the pool is larger than the plan.  The plan is the quantity
reported as ``ScheduleStats.arena_bytes`` and is sanity-checked by tests: no
two live buffers overlap, and arena size is never worse than
sum-of-all-buffers (no-reuse upper bound).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .trace import op_name, out_vals

ALIGN = 512  # bytes; matches common accelerator allocator alignment


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """One intermediate buffer: produced by ``def_idx``-th task in submission
    order, last read at ``last_use`` (inclusive); ``size`` bytes."""

    name: str
    size: int
    def_idx: int
    last_use: int

    def overlaps(self, other: "BufferSpec") -> bool:
        return not (self.last_use < other.def_idx or other.last_use < self.def_idx)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    arena_size: int
    offsets: tuple[int, ...]          # per buffer, aligned arena offset
    buffers: tuple[BufferSpec, ...]
    peak_live_bytes: int              # lower bound: max over time of live set

    @property
    def reuse_factor(self) -> float:
        total = sum(_align(b.size) for b in self.buffers)
        return total / self.arena_size if self.arena_size else 1.0

    def validate(self) -> None:
        """No two temporally-overlapping buffers may share bytes."""
        n = len(self.buffers)
        for i in range(n):
            bi, oi = self.buffers[i], self.offsets[i]
            for j in range(i + 1, n):
                bj, oj = self.buffers[j], self.offsets[j]
                if bi.overlaps(bj):
                    if not (oi + _align(bi.size) <= oj or oj + _align(bj.size) <= oi):
                        raise AssertionError(
                            f"live buffers {bi.name} and {bj.name} overlap in arena"
                        )


def plan_memory(buffers: Sequence[BufferSpec]) -> MemoryPlan:
    """Greedy best-fit static packing, processing buffers by decreasing size
    (a standard offline heuristic for the interval-coloring packing problem).
    """
    order = sorted(range(len(buffers)), key=lambda i: -buffers[i].size)
    offsets = [0] * len(buffers)
    placed: list[int] = []  # indices already placed
    arena = 0
    for i in order:
        b = buffers[i]
        size = _align(b.size)
        # Collect occupied [start, end) intervals among temporal conflicts.
        conflicts = sorted(
            (offsets[j], offsets[j] + _align(buffers[j].size))
            for j in placed
            if b.overlaps(buffers[j])
        )
        # Best-fit: smallest gap that fits; fall back to the end.
        best_off, best_gap = None, None
        cursor = 0
        for s, e in conflicts:
            if s - cursor >= size and (best_gap is None or s - cursor < best_gap):
                best_off, best_gap = cursor, s - cursor
            cursor = max(cursor, e)
        off = best_off if best_off is not None else cursor
        offsets[i] = off
        arena = max(arena, off + size)
        placed.append(i)

    peak = _peak_live(buffers)
    return MemoryPlan(
        arena_size=arena,
        offsets=tuple(offsets),
        buffers=tuple(buffers),
        peak_live_bytes=peak,
    )


def _peak_live(buffers: Sequence[BufferSpec]) -> int:
    if not buffers:
        return 0
    events: list[tuple[int, int]] = []
    for b in buffers:
        events.append((b.def_idx, _align(b.size)))
        events.append((b.last_use + 1, -_align(b.size)))
    events.sort()
    live = peak = 0
    for _, delta in events:
        live += delta
        peak = max(peak, live)
    return peak


def buffers_from_traced(traced) -> list[BufferSpec]:
    """Derive BufferSpecs from a TracedGraph's FX graph in submission order.

    One buffer per output of each task, sized from the node's fake value
    (``meta["val"]``); an ``operator.getitem`` node reads the output it picks.
    Buffers of the graph's *outputs* are kept live to the end (they escape).
    """
    nodes = traced.node_of_task
    index = {n: i for i, n in enumerate(nodes)}

    def values(n) -> list[tuple[int, int]]:
        """The (task, output) pairs that graph node ``n`` stands for."""
        if not hasattr(n, "all_input_nodes"):
            return []                                   # a constant output
        if n in index:
            return [(index[n], j) for j in range(len(out_vals(n)))]
        if n.op == "call_function" and n.args and n.args[0] in index:
            return [(index[n.args[0]], n.args[1])]      # operator.getitem
        return []                                       # inputs, constants

    last_use: dict[tuple[int, int], int] = {}
    for i, n in enumerate(nodes):
        for inp in n.all_input_nodes:
            for v in values(inp):
                last_use[v] = i
    escaping = {v for n in traced.output_nodes for v in values(n)}

    out = []
    for i, n in enumerate(nodes):
        name = f"{op_name(n)}@{i}"
        for j, val in enumerate(out_vals(n)):
            size = val.numel() * val.element_size() if hasattr(val, "element_size") else 0
            lu = len(nodes) - 1 if (i, j) in escaping else last_use.get((i, j), i)
            out.append(BufferSpec(name=name, size=size, def_idx=i, last_use=lu))
    return out
