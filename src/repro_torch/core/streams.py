"""Nimble's stream assignment algorithm (paper §4.2, Algorithm 1).

Given a task DAG ``G = (V, E)`` produce a stream assignment ``f: V → S``
satisfying

* **maximum logical concurrency** — nodes with no path between them get
  different streams, and
* **minimum number of synchronizations** — among all such assignments, the
  fewest cross-stream sync edges, proven equal to ``|E'| − |M|`` (Theorem 3/4)
  where ``E'`` is the MEG edge set and ``M`` a maximum matching of the derived
  bipartite graph.

The synchronization *plan* Λ ⊆ E' is the set of MEG edges not covered by the
matching: each such edge becomes an event recorded on the producer's CUDA
stream and waited on by the consumer's (``cudaStreamWaitEvent``), captured
into the schedule's CUDA graph as an edge (see core/aot.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .graph import TaskGraph
from .matching import ford_fulkerson, hopcroft_karp, matching_size
from .meg import minimum_equivalent_graph


@dataclasses.dataclass(frozen=True)
class StreamAssignment:
    """Result of Algorithm 1."""

    stream_of: tuple[int, ...]          # node id -> stream id (dense, 0-based)
    num_streams: int
    sync_edges: tuple[tuple[int, int], ...]   # Λ: MEG edges requiring a sync
    meg_edges: tuple[tuple[int, int], ...]    # E'
    matching_size: int

    @property
    def num_syncs(self) -> int:
        return len(self.sync_edges)

    def chains(self) -> list[list[int]]:
        """Nodes grouped per stream (each group is a chain in G')."""
        groups: dict[int, list[int]] = {}
        for v, s in enumerate(self.stream_of):
            groups.setdefault(s, []).append(v)
        return [groups[s] for s in sorted(groups)]


class _DSU:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def assign_streams(g: TaskGraph, *, method: str = "hopcroft_karp") -> StreamAssignment:
    """Run Algorithm 1 on the task graph ``g``.

    Steps (paper numbering):
      1. G' = MEG(G)
      2. bipartite B with edge (x_i, y_j) iff (v_i, v_j) ∈ E'
      3. maximum matching M of B
      4. union-find over matched pairs → partition of V into chains
      5. one stream per chain
    """
    n = g.num_tasks
    if n == 0:
        return StreamAssignment((), 0, (), (), 0)

    # Step 1 — minimum equivalent graph.
    meg = minimum_equivalent_graph(g)
    meg_edges = tuple(meg.edges())

    # Step 2 — bipartite graph (left = producers x_i, right = consumers y_j).
    adj: list[list[int]] = [[] for _ in range(n)]
    for u, v in meg_edges:
        adj[u].append(v)

    # Step 3 — maximum matching.
    matcher = hopcroft_karp if method == "hopcroft_karp" else ford_fulkerson
    match_l = matcher(n, n, adj)
    m_size = matching_size(match_l)

    # Step 4 — union matched pairs into chains.
    dsu = _DSU(n)
    matched_edges = set()
    for u, v in enumerate(match_l):
        if v >= 0:
            dsu.union(u, v)
            matched_edges.add((u, v))

    # Step 5 — dense stream ids per chain root.
    root_to_stream: dict[int, int] = {}
    stream_of = []
    for v in range(n):
        r = dsu.find(v)
        if r not in root_to_stream:
            root_to_stream[r] = len(root_to_stream)
        stream_of.append(root_to_stream[r])

    # Synchronization plan Λ = E' \ M  (Theorem 3: |Λ| = |E'| − |M| is minimal).
    sync_edges = tuple(e for e in meg_edges if e not in matched_edges)

    return StreamAssignment(
        stream_of=tuple(stream_of),
        num_streams=len(root_to_stream),
        sync_edges=sync_edges,
        meg_edges=meg_edges,
        matching_size=m_size,
    )


# ---------------------------------------------------------------------------
# Verification helpers — executable statements of the paper's definitions and
# theorems, used by the property-based tests and callable as runtime asserts.
# ---------------------------------------------------------------------------

def satisfies_max_logical_concurrency(g: TaskGraph, stream_of: Sequence[int]) -> bool:
    """Definition (§4.2): unordered node pairs must land on different streams."""
    reach = g.reachability()
    n = g.num_tasks
    for u in range(n):
        for v in range(u + 1, n):
            ordered = v in reach[u] or u in reach[v]
            if not ordered and stream_of[u] == stream_of[v]:
                return False
    return True


def streams_are_chains(g: TaskGraph, stream_of: Sequence[int]) -> bool:
    """Each stream's node set must be totally ordered by reachability (a GPU
    stream is FIFO; co-streamed unordered nodes would deadlock concurrency)."""
    reach = g.reachability()
    groups: dict[int, list[int]] = {}
    for v, s in enumerate(stream_of):
        groups.setdefault(s, []).append(v)
    for nodes in groups.values():
        for i, u in enumerate(nodes):
            for v in nodes[i + 1:]:
                if not (v in reach[u] or u in reach[v]):
                    return False
    return True


def is_safe_sync_plan(
    g: TaskGraph, stream_of: Sequence[int], plan: set[tuple[int, int]]
) -> bool:
    """Definition 2 (App. A): for every edge (u,v) of G, either f(u)=f(v) or
    there EXISTS a path u→v that contains a plan edge.  (Ordering then follows
    inductively: every edge of E is itself subject to the same condition, so
    each hop of the chosen path is ordered.)"""
    reach = g.reachability()
    for u, v in g.edges():
        if stream_of[u] == stream_of[v]:
            continue
        ok = any(
            (a == u or a in reach[u]) and (b == v or v in reach[b])
            for a, b in plan
        )
        if not ok:
            return False
    return True


def min_syncs_bruteforce(g: TaskGraph, stream_of: Sequence[int]) -> int:
    """Exact minimum |Λ| for a given assignment via Lemma 4:
    min_sync = |E'| − |Q(f)| where Q(f) = nodes with a same-stream MEG parent.
    (Used to cross-check Theorem 3 in tests.)"""
    meg = minimum_equivalent_graph(g)
    q = 0
    for v in range(g.num_tasks):
        if any(stream_of[p] == stream_of[v] for p in meg.predecessors(v)):
            q += 1
    return meg.num_edges - q
