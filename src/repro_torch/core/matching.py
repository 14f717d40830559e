"""Maximum bipartite matching (Step 3 of paper Algorithm 1).

The paper uses Ford–Fulkerson (ref. [20]); we provide both that (for the
faithful-reference path and cross-checking) and Hopcroft–Karp
(O(E sqrt(V))) as the default, since MoE task graphs reach thousands of
nodes.  Both return, for each left vertex, the matched right vertex or -1.
"""

from __future__ import annotations

from collections import deque
from typing import Sequence


def ford_fulkerson(n_left: int, n_right: int, adj: Sequence[Sequence[int]]) -> list[int]:
    """Classic augmenting-path matching — the paper's stated method."""
    match_l = [-1] * n_left
    match_r = [-1] * n_right

    def try_augment(u: int, seen: list[bool]) -> bool:
        for v in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            if match_r[v] == -1 or try_augment(match_r[v], seen):
                match_l[u] = v
                match_r[v] = u
                return True
        return False

    for u in range(n_left):
        try_augment(u, [False] * n_right)
    return match_l


def hopcroft_karp(n_left: int, n_right: int, adj: Sequence[Sequence[int]]) -> list[int]:
    """Hopcroft–Karp maximum matching; iterative (no recursion limits)."""
    INF = float("inf")
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    dist = [0.0] * n_left

    def bfs() -> bool:
        q = deque()
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0.0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_r[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(root: int) -> bool:
        # Iterative DFS over layered graph.
        stack: list[tuple[int, int]] = [(root, 0)]
        path: list[tuple[int, int]] = []  # (u, v) tentative matches
        iters: list[iter] = [iter(adj[root])]
        while stack:
            u, _ = stack[-1]
            advanced = False
            for v in iters[-1]:
                w = match_r[v]
                if w == -1 or (dist[w] == dist[u] + 1):
                    if w == -1:
                        # augment along path
                        path.append((u, v))
                        for pu, pv in path:
                            match_l[pu] = pv
                            match_r[pv] = pu
                        return True
                    path.append((u, v))
                    stack.append((w, 0))
                    iters.append(iter(adj[w]))
                    advanced = True
                    break
            if not advanced:
                dist[u] = INF
                stack.pop()
                iters.pop()
                if path:
                    path.pop()
        return False

    while bfs():
        for u in range(n_left):
            if match_l[u] == -1:
                dfs(u)
    return match_l


def matching_size(match_l: Sequence[int]) -> int:
    return sum(1 for v in match_l if v >= 0)
