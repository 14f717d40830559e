"""Minimum equivalent graph (Step 1 of paper Algorithm 1).

For a finite DAG the minimum equivalent graph (MEG) coincides with the
*transitive reduction* and is unique (Hsu 1975, paper ref. [23]): it keeps the
same node set and the smallest edge subset preserving reachability.

An edge (u, v) survives iff it is the **only** path from u to v (paper
Lemma 1) — i.e. v is not reachable from u through any intermediate successor.
"""

from __future__ import annotations

from .graph import TaskGraph


def minimum_equivalent_graph(g: TaskGraph) -> TaskGraph:
    """Return G' = (V, E'), the unique MEG/transitive reduction of the DAG g.

    O(V·E) with set-based reachability; fine for operator graphs (|V| up to a
    few thousand).
    """
    reach = g.reachability()
    out = TaskGraph()
    out.tasks = list(g.tasks)  # share Task objects; ids/indices unchanged
    out._succ = [set() for _ in range(g.num_tasks)]
    out._pred = [set() for _ in range(g.num_tasks)]
    for u, v in g.edges():
        # (u,v) is redundant iff some other successor w of u reaches v.
        redundant = any(v in reach[w] for w in g.successors(u) if w != v)
        if not redundant:
            out._succ[u].add(v)
            out._pred[v].add(u)
    return out


def same_reachability(a: TaskGraph, b: TaskGraph) -> bool:
    """Check the MEG invariant (used by property tests)."""
    if a.num_tasks != b.num_tasks:
        return False
    return a.reachability() == b.reachability()
