"""The port's Algorithm 1 and memory planner against the JAX package's.

``graph.py``, ``meg.py``, ``matching.py``, ``streams.py`` and the planner of
``memory.py`` are copies in the port.  On the random DAGs of
``test_streams_properties.py`` the port's ``assign_streams`` must give a
``StreamAssignment`` equal to JAX's, field by field, and its ``plan_memory``
a ``MemoryPlan`` equal to JAX's on the random buffer sets of
``test_aot_engine.py``.  The paper's theorems are checked on the port's
copies too.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import memory as jax_memory  # noqa: E402
from repro.core.graph import TaskGraph as JaxTaskGraph  # noqa: E402
from repro.core.streams import assign_streams as jax_assign_streams  # noqa: E402
from repro_torch.core import memory  # noqa: E402
from repro_torch.core.graph import TaskGraph  # noqa: E402
from repro_torch.core.matching import ford_fulkerson, hopcroft_karp, matching_size  # noqa: E402
from repro_torch.core.meg import minimum_equivalent_graph, same_reachability  # noqa: E402
from repro_torch.core.streams import (  # noqa: E402
    assign_streams,
    is_safe_sync_plan,
    min_syncs_bruteforce,
    satisfies_max_logical_concurrency,
    streams_are_chains,
)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- random DAG strategy (as in test_streams_properties.py) ---------------------

@st.composite
def edge_lists(draw, max_nodes=12):
    n = draw(st.integers(min_value=1, max_value=max_nodes))
    edges = []
    for v in range(1, n):
        for u in range(v):
            if draw(st.booleans()):
                edges.append((u, v))  # u < v guarantees acyclicity
    return n, edges


@given(edge_lists())
@settings(max_examples=200, deadline=None)
@pytest.mark.parametrize("method", ["hopcroft_karp", "ford_fulkerson"])
def test_stream_assignment_equals_jax(method, dag):
    n, edges = dag
    got = assign_streams(TaskGraph.from_edges(n, edges), method=method)
    want = jax_assign_streams(JaxTaskGraph.from_edges(n, edges), method=method)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.num_syncs == want.num_syncs
    assert got.chains() == want.chains()


@given(edge_lists())
@settings(max_examples=100, deadline=None)
def test_graph_queries_equal_jax(dag):
    n, edges = dag
    g, jg = TaskGraph.from_edges(n, edges), JaxTaskGraph.from_edges(n, edges)
    assert list(g.edges()) == list(jg.edges())
    assert g.topo_order() == jg.topo_order()
    assert g.depth() == jg.depth()
    assert g.max_logical_concurrency() == jg.max_logical_concurrency()


@given(edge_lists())
@settings(max_examples=100, deadline=None)
def test_theorems_hold_on_the_port(dag):
    """Lemma 1, Theorems 2-4 and Definition 2 on the port's copies."""
    g = TaskGraph.from_edges(*dag)
    meg = minimum_equivalent_graph(g)
    assert same_reachability(g, meg)
    adj = [sorted(meg.successors(u)) for u in range(g.num_tasks)]
    n = g.num_tasks
    assert matching_size(ford_fulkerson(n, n, adj)) == matching_size(hopcroft_karp(n, n, adj))
    sa = assign_streams(g)
    assert satisfies_max_logical_concurrency(g, sa.stream_of)
    assert streams_are_chains(g, sa.stream_of)
    assert sa.num_syncs == len(sa.meg_edges) - sa.matching_size
    assert sa.num_syncs == min_syncs_bruteforce(g, sa.stream_of)
    assert is_safe_sync_plan(g, sa.stream_of, set(sa.sync_edges))


def test_fork_join_and_figure6():
    edges = [(0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4)]
    sa = assign_streams(TaskGraph.from_edges(5, edges))
    assert (sa.num_streams, sa.num_syncs) == (3, 4)
    fig6 = [(0, 1), (0, 2), (0, 3), (1, 3), (2, 3), (2, 4), (3, 5), (4, 5)]
    g = TaskGraph.from_edges(6, fig6)
    assert not minimum_equivalent_graph(g).has_edge(0, 3)
    assert dataclasses.astuple(assign_streams(g)) == dataclasses.astuple(
        jax_assign_streams(JaxTaskGraph.from_edges(6, fig6)))


# -- memory planner ----------------------------------------------------------------

@st.composite
def buffer_specs(draw):
    n = draw(st.integers(min_value=1, max_value=24))
    out = []
    for i in range(n):
        d = draw(st.integers(min_value=0, max_value=30))
        l = draw(st.integers(min_value=0, max_value=10))
        size = draw(st.integers(min_value=1, max_value=1 << 16))
        out.append((f"b{i}", size, d, d + l))
    return out


@given(buffer_specs())
@settings(max_examples=200, deadline=None)
def test_memory_plan_equals_jax(specs):
    got = memory.plan_memory([memory.BufferSpec(*s) for s in specs])
    want = jax_memory.plan_memory([jax_memory.BufferSpec(*s) for s in specs])
    assert (got.arena_size, got.offsets, got.peak_live_bytes) == (
        want.arena_size, want.offsets, want.peak_live_bytes)
    assert [dataclasses.astuple(b) for b in got.buffers] == [
        dataclasses.astuple(b) for b in want.buffers]
    assert got.reuse_factor == want.reuse_factor
    got.validate()
    no_reuse = sum((s[1] + 511) // 512 * 512 for s in specs)
    assert got.peak_live_bytes <= got.arena_size <= no_reuse


def test_disjoint_lifetimes_fully_reuse():
    plan = memory.plan_memory([memory.BufferSpec(f"b{i}", 1024, i * 2, i * 2 + 1)
                               for i in range(10)])
    assert plan.arena_size == 1024
