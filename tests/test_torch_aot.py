"""The port's Nimble pipeline against the JAX package's, on the CPU.

On ``_branchy`` (``test_aot_engine.py``) and the four branchy configs at
full size, with the JAX weights carried over by
``bridge.branchy_params_from_jax``, the port's trace must give JAX's task
graph (task count, edges, kinds, FLOPs), Algorithm 1 the same
``StreamAssignment``, and the planner the same ``MemoryPlan``.  The port's
engines must agree with JAX's ``Nimble`` on the same inputs: ``Nimble`` and
``EagerInterpreter`` within 1e-5, ``Nimble(pack_streams=True)`` within
1e-4 (float32 summation order).  The CUDA-graph seal itself runs on the
card, in ``chip_smoke.py``.
"""

import dataclasses
import functools
import os
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core as J  # noqa: E402
from repro.configs import branchy_cell as jax_cells  # noqa: E402
from repro.core.rewriter import plan_packs as jax_plan_packs  # noqa: E402
from repro.models import branchy as jax_branchy  # noqa: E402
from repro_torch.bridge import branchy_params_from_jax  # noqa: E402
from repro_torch.configs import branchy_cell as cells  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DispatchProfile,
    EagerInterpreter,
    Nimble,
    buffers_from_traced,
    compare_engines,
    plan_memory,
    trace_to_taskgraph,
)
from repro_torch.core import rewriter  # noqa: E402
from repro_torch.core.aot import _Eager  # noqa: E402
from repro_torch.dispatch import ScheduleCache  # noqa: E402
from repro_torch.dispatch.cache import _arena_bytes  # noqa: E402
from repro_torch.models import branchy  # noqa: E402

CONFIGS = ["darts_like", "nasnet_mobile_like", "amoebanet_like", "inception_like"]
CASES = ["branchy4"] + CONFIGS
JAX_NAME = {"dot_general": "mm", "tanh": "tanh", "add": "add"}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_branchy(x, ws):
    outs = [jnp.tanh(jnp.dot(x, w)) for w in ws]
    acc = outs[0]
    for o in outs[1:]:
        acc = acc + o
    return acc


def _branchy(x, ws):
    outs = [torch.tanh(x @ w) for w in ws]
    acc = outs[0]
    for o in outs[1:]:
        acc = acc + o
    return acc


@dataclasses.dataclass
class Case:
    jax_fn: object
    jax_args: tuple
    fn: object
    args: tuple
    n_branches: int
    n_cells: int
    jax_nimble: object
    jax_out: np.ndarray


@functools.lru_cache(maxsize=None)
def _case(name: str) -> Case:
    """JAX function, inputs and sealed ``Nimble``, beside the port's
    function and the same inputs as CPU tensors."""
    if name == "branchy4":
        rng = np.random.default_rng(0)
        x = rng.standard_normal((8, 32), dtype=np.float32)
        ws = [rng.standard_normal((32, 32), dtype=np.float32) for _ in range(4)]
        jax_args = (x, ws)
        args = (torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
        jax_fn, fn, n_branches, n_cells = _jax_branchy, _branchy, 4, 1
    else:
        jcfg, cfg = getattr(jax_cells, name)(), getattr(cells, name)()
        params = jax_branchy.init_branchy(jax.random.key(0), jcfg)
        x = jax_branchy.example_input(jcfg, 0)
        jax_args = (params, x)
        args = (branchy_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu"),
                torch.from_numpy(np.array(x)))

        def jax_fn(p, x, _c=jcfg):
            return jax_branchy.branchy_forward(p, x, _c)

        def fn(p, x, _c=cfg):
            return branchy.branchy_forward(p, x, _c)

        n_branches, n_cells = cfg.n_branches, cfg.n_cells
    jn = J.Nimble(jax_fn, *jax_args)
    return Case(jax_fn, jax_args, fn, args, n_branches, n_cells, jn,
                np.asarray(jn(*jax_args)))


@pytest.mark.parametrize("name", CASES)
def test_taskgraph_equals_jax(name):
    c = _case(name)
    got = trace_to_taskgraph(c.fn, *c.args).graph
    want = c.jax_nimble.schedule.traced.graph
    assert got.num_tasks == want.num_tasks
    assert list(got.edges()) == list(want.edges())
    assert [t.kind for t in got.tasks] == [t.kind for t in want.tasks]
    assert [t.name for t in got.tasks] == [JAX_NAME[t.name] for t in want.tasks]
    assert [t.out_shapes for t in got.tasks] == [t.out_shapes for t in want.tasks]
    assert [t.flops for t in got.tasks] == [t.flops for t in want.tasks]
    assert [t.meta["out_bytes"] for t in got.tasks] == [t.meta["out_bytes"] for t in want.tasks]


@pytest.mark.parametrize("name", CASES)
def test_streams_memory_and_stats_equal_jax(name):
    c = _case(name)
    sched, want = Nimble(c.fn, *c.args).schedule, c.jax_nimble.schedule
    assert dataclasses.astuple(sched.streams) == dataclasses.astuple(want.streams)
    assert sched.memory.arena_size == want.memory.arena_size
    assert sched.memory.offsets == want.memory.offsets
    assert sched.memory.peak_live_bytes == want.memory.peak_live_bytes
    st_, jst = sched.stats, want.stats
    for field in ("num_tasks", "num_streams", "num_syncs", "degree_of_concurrency",
                  "arena_bytes", "arena_reuse_factor"):
        assert getattr(st_, field) == getattr(jst, field), field
    assert st_.degree_of_concurrency == c.n_branches
    # Theorem 3: syncs == |E'| - |M|
    assert st_.num_syncs == len(sched.streams.meg_edges) - sched.streams.matching_size


def test_darts_like_numbers():
    """The numbers the JAX trace gives for darts-like, held by the port."""
    st_ = Nimble(_case("darts_like").fn, *_case("darts_like").args).stats
    assert (st_.num_tasks, st_.num_streams, st_.num_syncs, st_.degree_of_concurrency) == (
        86, 25, 48, 7)


ENGINES = {
    "nimble": (lambda c: Nimble(c.fn, *c.args), 1e-5),
    "single_stream": (lambda c: Nimble(c.fn, *c.args, multi_stream=False), 1e-5),
    "eager": (lambda c: EagerInterpreter(c.fn, *c.args), 1e-5),
    "packed": (lambda c: Nimble(c.fn, *c.args, pack_streams=True), 1e-4),
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", CASES)
def test_outputs_match_jax_nimble(name, engine):
    c = _case(name)
    make, tol = ENGINES[engine]
    got = make(c)(*c.args)
    assert got.shape == c.jax_out.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), c.jax_out, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), c.fn(*c.args).numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_packed_matches_jax_concat_gemm(name):
    """Shared-LHS mm groups run on stream_pack with lane stride 0; JAX runs
    them as one GEMM against the concatenated weights.  Same numbers."""
    c = _case(name)
    want = np.asarray(J.Nimble(c.jax_fn, *c.jax_args, pack_streams=True)(*c.jax_args))
    got = Nimble(c.fn, *c.args, pack_streams=True)(*c.args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CASES)
def test_pack_report(name):
    """In each cell one mm group and one tanh group of n_branches members;
    every mm group's weights baked at schedule time; JAX's groups alike."""
    c = _case(name)
    rep = Nimble(c.fn, *c.args, pack_streams=True).schedule.pack_report
    assert rep.groups == [("mm", c.n_branches), ("tanh", c.n_branches)] * c.n_cells
    assert rep.baked_groups == c.n_cells
    assert rep.packed_tasks == 2 * c.n_branches * c.n_cells
    tr = J.trace_to_taskgraph(c.jax_fn, *c.jax_args)
    _, jrep = jax_plan_packs(tr, J.assign_streams(tr.graph))
    assert rep.groups == [(JAX_NAME[p], n) for p, n in jrep.groups]


def test_packed_mm_groups_go_through_stream_pack(monkeypatch):
    """Every packed mm group is one stream_pack call, its x shared."""
    c = _case("darts_like")
    calls = []

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return rewriter_stream_pack(x, w)

    rewriter_stream_pack = rewriter.stream_pack
    monkeypatch.setattr(rewriter, "stream_pack", spy)
    nimble = Nimble(c.fn, *c.args, pack_streams=True)
    calls.clear()
    nimble(*c.args)
    assert calls == [((8, 64), (7, 64, 64))] * 4


@pytest.mark.parametrize("bake", [True, False])
def test_packed_schedule_follows_other_and_changed_weights(bake):
    """A packed schedule called with other weights, or after its example
    weights change in place, computes with those weights, baked or not;
    JAX's ``Nimble`` on the other weights is the reference."""
    c = _case("darts_like")
    jcfg, cfg = jax_cells.darts_like(), cells.darts_like()
    params = {k: v.clone() for k, v in c.args[0].items()}
    x = c.args[1].clone()
    nimble = Nimble(c.fn, params, x, pack_streams=True, bake_weights=bake)
    assert nimble.schedule.pack_report.baked_groups == (cfg.n_cells if bake else 0)

    jparams = jax_branchy.init_branchy(jax.random.key(1), jcfg)
    jx = jax_branchy.example_input(jcfg, 1)
    want = np.asarray(c.jax_nimble(jparams, jx))
    other = branchy_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = nimble(other, torch.from_numpy(np.array(jx)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nimble(params, x).numpy(), c.jax_out, rtol=1e-4, atol=1e-4)

    for k in params:                                    # weights updated in place
        params[k].copy_(other[k])
    got = nimble(params, torch.from_numpy(np.array(jx)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_changed_pytree_raises():
    c = _case("branchy4")
    x, ws = c.args
    for engine in (Nimble(_branchy, x, ws), EagerInterpreter(_branchy, x, ws)):
        with pytest.raises(TypeError):
            engine(x, ws[:-1])


def test_eager_interpreter_checks_shapes():
    c = _case("branchy4")
    x, ws = c.args
    prof = DispatchProfile()
    eager = EagerInterpreter(_branchy, x, ws)
    eager.run(x, ws, profile=prof)
    assert prof.num_tasks == 11 and prof.total_s >= prof.schedule_s > 0
    with pytest.raises(TypeError, match="shape mismatch"):
        eager.run(x[:4], ws)


def test_schedule_cache_pays_one_build():
    c = _case("darts_like")
    cache = ScheduleCache(capacity=4)
    a = Nimble(c.fn, *c.args, cache=cache)
    b = Nimble(c.fn, *c.args, cache=cache)
    assert cache.stats.builds == 1 and cache.stats.hits == 1
    assert a.schedule is b.schedule
    assert cache.snapshot()["entries"][0]["arena_bytes"] == a.stats.arena_bytes > 0
    a.prepare(*c.args)                                  # same shapes: a no-op
    assert cache.stats.builds == 1 and cache.stats.hits == 1
    np.testing.assert_allclose(b(*c.args).numpy(), c.jax_out, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_seal_a_plain_callable():
    c = _case("branchy4")
    sched = Nimble(_branchy, *c.args).schedule
    assert isinstance(sched.executable, _Eager)
    assert sched.stats.device_bytes == 0


def test_cache_charges_a_schedule_its_larger_footprint():
    """A schedule is charged the larger of its planned arena and the bytes
    its seal holds on the card."""
    def stats(arena, device):
        return SimpleNamespace(stats=SimpleNamespace(arena_bytes=arena, device_bytes=device))

    assert _arena_bytes(stats(18_432, 33_700_000)) == 33_700_000
    assert _arena_bytes(stats(18_432, 0)) == 18_432
    assert _arena_bytes(stats(18_432, 33_700_000), explicit=5) == 5


def test_device_rules():
    """Meta tensors trace and key but do not seal; mixed devices and
    non-tensor leaves raise."""
    x, ws = _case("branchy4").args
    meta = (x.to("meta"), [w.to("meta") for w in ws])
    assert trace_to_taskgraph(_branchy, *meta).graph.num_tasks == 11
    with pytest.raises(ValueError, match="cannot seal"):
        Nimble(_branchy, *meta)
    with pytest.raises(ValueError, match="one device"):
        Nimble(_branchy, x, [w.to("meta") for w in ws])
    with pytest.raises(TypeError, match="tensors only"):
        Nimble(lambda x, s: x * s, x, 2.0)


def test_trace_kinds_flops_and_multi_output():
    """Layout, matmul and ewise kinds; exact addmm FLOPs; a multi-output
    operator (split) is one task whose outputs its consumers read."""

    def fn(x, w, b):
        y = torch.addmm(b, x, w)              # (8, 16)
        lo, hi = torch.split(y, 8, dim=1)
        return torch.tanh(lo).t().reshape(-1), hi.sum(dim=0)

    rng = np.random.default_rng(3)
    args = tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 for s in ((8, 32), (32, 16), (16,)))
    tr = trace_to_taskgraph(fn, *args)
    names = [t.name for t in tr.graph.tasks]
    kinds = dict(zip(names, (t.kind for t in tr.graph.tasks)))
    assert names[:2] == ["addmm", "split"]
    assert kinds["addmm"] == "matmul" and kinds["t"] == "layout" and kinds["tanh"] == "ewise"
    assert tr.graph.tasks[0].flops == 2.0 * 8 * 16 * 32
    assert tr.graph.tasks[1].out_shapes == ((8, 8), (8, 8))
    plan = plan_memory(buffers_from_traced(tr))
    plan.validate()
    assert plan.arena_size >= plan.peak_live_bytes > 0
    want = fn(*args)
    for engine in (Nimble(fn, *args), Nimble(fn, *args, pack_streams=True),
                   EagerInterpreter(fn, *args)):
        for g, w in zip(engine(*args), want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


def test_function_writing_its_input_is_refused():
    def fn(x):
        x.add_(1.0)
        return x * 2

    with pytest.raises(ValueError, match="leave their inputs unchanged"):
        trace_to_taskgraph(fn, torch.ones(4))


def test_compare_engines_on_the_cpu():
    c = _case("branchy4")
    res = compare_engines(_branchy, *c.args, iters=2, warmup=1)
    assert res["eager_us"] > 0 and res["aot_us"] > 0
    assert res["concurrency_degree"] == 4 and res["num_tasks"] == 11
