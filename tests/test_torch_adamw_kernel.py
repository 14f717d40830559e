"""B4, the port's AdamW kernels (``repro_torch.kernels.adamw``), on the CPU.

The kernels run only on the card (``chip_smoke.py`` phase 19f holds them
against their plain versions there); here the plain versions stand in for
them, through the same wrappers: one numpy-seeded tree with odd leaf sizes
goes through the JAX package's ``optim/adamw.py`` and the port's, within
1e-6 as in ``test_torch_optim.py``.  Beside that: the routing (CPU and meta
through ``run_plain``, a DTensor refused), the wrapper's refusals, the
launch plan (every element once, a function of a leaf's size and dtype
alone), the library call over a fake library (the leaves' own pointers, no
copy, nothing allocated but the sums' buffer, a failed launch raises), the
dry run's count of one step (each pass one launch, its bytes the hand
count, nothing made but the sums' buffer), and the case list of 19f.
"""

import importlib.util
import inspect
import os
import types
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.optim import adamw as J  # noqa: E402
from repro_torch.kernels import plain_watchers, run_plain  # noqa: E402
from repro_torch.kernels.adamw import kernel  # noqa: E402
from repro_torch.kernels.adamw.ref import adamw_step_ref, sumsq_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_analysis import CommCounter, collective_bytes  # noqa: E402
from repro_torch.optim import adamw as T  # noqa: E402

# odd sizes: a lone element, a tail shorter than a vector, whole vectors,
# a tail past whole vectors, a 2-d leaf
SHAPES = {"a": (1,), "b": (5,), "c": (3072,), "d": (4097,), "e": (7, 129)}
TOL = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _both(tree, dtype):
    return ({k: jnp.asarray(a, dtype) for k, a in tree.items()},
            {k: torch.tensor(a).to(getattr(torch, dtype)) for k, a in tree.items()})


def _close(jtree, ttree, tol=TOL):
    for k in SHAPES:
        np.testing.assert_allclose(ttree[k].float().numpy(), np.asarray(jtree[k], np.float32),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
@pytest.mark.parametrize("lr_form", ["float", "tensor"])
def test_adamw_update_matches_jax_at_odd_sizes(dtype, clip, lr_form):
    jp, tp = _both(_tree(0), dtype)
    js, ts = J.adamw_init(jp), T.adamw_init(tp)
    for step in range(3):
        jg, tg = _both(_tree(10 + step, scale=3.0), dtype)
        lr = 1e-2 * (step + 1)
        jp, js, jn = J.adamw_update(jg, js, jp, lr=lr, max_grad_norm=clip)
        _, ts, tn = T.adamw_update(tg, ts, tp, lr=torch.tensor(lr) if lr_form == "tensor" else lr,
                                   max_grad_norm=clip)
        np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _close(jp, tp)
    _close(js.mu, ts.mu)
    _close(js.nu, ts.nu)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_norm_and_clip_match_jax_at_odd_sizes(dtype, max_norm):
    jg, tg = _both(_tree(2, scale=5.0), dtype)
    np.testing.assert_allclose(float(T.global_norm(tg)), float(J.global_norm(jg)), rtol=TOL)
    jc, jn = J.clip_by_global_norm(jg, max_norm)
    tc, tn = T.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _close(jc, tc)
    assert all(tc[k].dtype == tg[k].dtype and tc[k] is not tg[k] for k in SHAPES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sumsq_and_step_ref_match_jax(dtype):
    """``sumsq_ref`` is each leaf's JAX sum of squares; ``adamw_step_ref``
    is JAX's ``upd`` after the clip, for one leaf."""
    jg, tg = _both(_tree(3, scale=2.0), dtype)
    got = sumsq_ref(list(tg.values()))
    want = [float(jnp.sum(jnp.square(g.astype(jnp.float32)))) for g in jg.values()]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)
    jp, tp = _both(_tree(4), dtype)
    m = {k: torch.full(s, 0.01) for k, s in SHAPES.items()}
    v = {k: torch.full(s, 0.02) for k, s in SHAPES.items()}
    scale = torch.tensor(0.5)
    bc1, bc2 = torch.tensor(0.19), torch.tensor(0.0975)
    for k in SHAPES:
        adamw_step_ref(tg[k], m[k], v[k], tp[k], scale=scale, lr=1e-2, bc1=bc1, bc2=bc2, b1=0.9,
                       b2=0.95, eps=1e-8, weight_decay=0.1)
        g = (jg[k] * jnp.asarray(0.5, jg[k].dtype)).astype(jnp.float32)
        m2 = 0.9 * 0.01 + 0.1 * g
        v2 = 0.95 * 0.02 + 0.05 * g * g
        p = jp[k].astype(jnp.float32)
        p2 = (p - 1e-2 * ((m2 / 0.19) / (jnp.sqrt(v2 / 0.0975) + 1e-8) + 0.1 * p)).astype(
            jp[k].dtype)
        np.testing.assert_allclose(m[k].numpy(), np.asarray(m2), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(v[k].numpy(), np.asarray(v2), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(p2, np.float32), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# routing and refusals
# ---------------------------------------------------------------------------

def _state(shapes, dtype=torch.bfloat16, device="cpu"):
    g = torch.Generator().manual_seed(0)

    def leaf(s, dt):
        return torch.randn(s, generator=g).to(dt).to(device)

    params = [leaf(s, dtype) for s in shapes]
    grads = [leaf(s, dtype) for s in shapes]
    mus = [leaf(s, torch.float32) for s in shapes]
    nus = [leaf(s, torch.float32).abs() for s in shapes]
    return grads, mus, nus, params


def _update(grads, mus, nus, params, lr=1e-3):
    step = torch.zeros((), dtype=torch.int32, device=params[0].device)
    scalars = kernel.adamw_finish(kernel.adamw_sumsq(grads), step, max_norm=1.0)
    kernel.adamw_step(grads, mus, nus, params, scalars, lr, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1, clip=True)
    return scalars, step


def test_cpu_and_meta_take_the_plain_versions_through_run_plain():
    seen = []

    def watcher(fn, args, writes=()):
        seen.append(len(writes) if isinstance(writes, tuple) else writes)
        return fn(*args)

    before = kernel.launches
    plain_watchers.append(watcher)
    try:
        scalars, step = _update(*_state([(5,), (3, 7)]))
        meta = _state([(5,), (3, 7)], device="meta")
        mscalars, _ = _update(*meta)
    finally:
        plain_watchers.remove(watcher)
    # three passes a step: the sums (writing nothing in place), the finish
    # (its scalars and the step), the update (the moments and parameters)
    assert seen == [0, 2, 3] * 2
    assert kernel.launches == before
    assert int(step) == 1 and torch.isfinite(scalars).all()
    assert mscalars.is_meta and mscalars.shape == (4,)
    assert all(t.is_meta for tree in meta for t in tree)


def test_a_dtensor_is_refused():
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed import place

    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        leaf = place(torch.empty(8, device="meta"), mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="local shard"):
            kernel.adamw_sumsq([leaf])
        with pytest.raises(TypeError, match="local shard"):
            kernel.adamw_step([leaf], [leaf], [leaf], [leaf], torch.zeros(4), 1e-3, b1=0.9,
                              b2=0.95, eps=1e-8, weight_decay=0.1, clip=True)


def _bad(case):
    grads, mus, nus, params = _state([(5,), (3, 7)])
    if case == "float16":
        params = [p.half() for p in params]
        grads = [g.half() for g in grads]
    elif case == "float64":
        params = [p.double() for p in params]
        grads = [g.double() for g in grads]
    elif case == "bf16 moments":
        mus = [m.bfloat16() for m in mus]
    elif case == "gradient dtype":
        grads = [g.float() for g in grads]
    elif case == "lengths":
        nus = nus[:1]
    elif case == "shapes":
        mus = [mus[0], torch.zeros(7, 3)]
    elif case == "non-contiguous":
        params = [params[0], torch.zeros(7, 3, dtype=torch.bfloat16).t()]
    elif case == "devices":
        mus = [mus[0], torch.zeros(3, 7, device="meta")]
    return grads, mus, nus, params


@pytest.mark.parametrize("case", ["float16", "float64", "bf16 moments", "gradient dtype",
                                  "lengths", "shapes", "non-contiguous", "devices"])
def test_the_wrapper_refuses(case):
    grads, mus, nus, params = _bad(case)
    with pytest.raises(ValueError, match="adamw"):
        kernel.adamw_step(grads, mus, nus, params, torch.zeros(4), 1e-3, b1=0.9, b2=0.95,
                          eps=1e-8, weight_decay=0.1, clip=True)


def test_the_sums_refuse_other_dtypes_and_layouts():
    for leaves in ([torch.zeros(4, dtype=torch.float16)], [torch.zeros(4, dtype=torch.float64)],
                   [torch.zeros(3, 4).t()], []):
        with pytest.raises(ValueError, match="adamw"):
            kernel.adamw_sumsq(leaves)


def test_the_scalars_and_lr_are_checked():
    grads, mus, nus, params = _state([(5,)])
    buf = kernel.adamw_sumsq(grads)
    with pytest.raises(ValueError, match="step counter"):
        kernel.adamw_finish(buf, torch.zeros((), dtype=torch.int64), max_norm=1.0)
    for scalars, lr in ((torch.zeros(3), 1e-3), (torch.zeros(4), torch.tensor(1e-3,
                                                                             dtype=torch.float64)),
                        (torch.zeros(4), torch.zeros(1)), (torch.zeros(4), "1e-3")):
        with pytest.raises(ValueError, match="adamw"):
            kernel.adamw_step(grads, mus, nus, params, scalars, lr, b1=0.9, b2=0.95, eps=1e-8,
                              weight_decay=0.1, clip=True)


def test_an_optimizer_step_copies_a_strided_gradient_once():
    """autograd may give a gradient in another layout: the optimizer makes
    it contiguous with one counted copy, and the step equals the step on a
    contiguous gradient."""
    p = {"w": torch.randn(6, 4).bfloat16()}
    g = torch.randn(4, 6).bfloat16()
    q = {"w": p["w"].clone()}
    sp, sq = T.adamw_init(p), T.adamw_init(q)
    before = kernel.layout_copies
    T.adamw_update({"w": g.t()}, sp, p, lr=1e-2)
    assert kernel.layout_copies == before + 1
    T.adamw_update({"w": g.t().contiguous()}, sq, q, lr=1e-2)
    assert kernel.layout_copies == before + 1
    assert torch.equal(p["w"], q["w"]) and torch.equal(sp.mu["w"], sq.mu["w"])


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

GRID = kernel.MAX_BLOCKS * kernel.THREADS


@pytest.mark.parametrize("dtype,vec", [("bfloat16", 8), ("float32", 4)])
@pytest.mark.parametrize("numel", [0, 1, 5, 8, 9, 4097, 3 * 256 * 8 + 5, GRID * 4 + 7,
                                   GRID * 8 + 3])
def test_the_plan_covers_every_element_once(dtype, vec, numel):
    launch = kernel.choose_launch(numel, dtype)
    assert launch.vec == vec and launch.nvec * vec + launch.tail == numel
    assert 0 <= launch.tail < vec and 1 <= launch.grid <= kernel.MAX_BLOCKS
    assert launch.grid == 1 or (launch.grid - 1) * kernel.THREADS < launch.nvec


def test_the_plan_is_a_function_of_size_and_dtype_alone():
    assert list(inspect.signature(kernel.choose_launch).parameters) == ["numel", "dtype"]
    assert kernel.choose_launch(4097, "bfloat16") == kernel.choose_launch(4097, "bfloat16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.choose_launch(8, "float16")


# ---------------------------------------------------------------------------
# the library call, over a fake library
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for the built library: records each call's arguments
    (ctypes arrays as lists) and returns ``rc``, as the C functions return
    a CUDA error."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def _record(self, name, args):
        self.calls.append((name, [list(a) if hasattr(a, "_length_") else a for a in args]))
        return self.rc

    def adamw_sumsq(self, *args):
        return self._record("sumsq", args)

    def adamw_finish(self, *args):
        return self._record("finish", args)

    def adamw_step(self, *args):
        return self._record("step", args)


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers on CPU tensors up to the library call: the routing takes
    the card's branch, the stream is stubbed, the library is a fake."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel, "takes_plain", lambda t: False)
    monkeypatch.setattr(kernel, "_kernel", lambda device: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_the_library_gets_the_leaves_own_pointers_and_plans(fake_launch):
    grads, mus, nus, params = _state([(5,), (4097,), (33, 65)])
    store = torch.zeros(4098, dtype=torch.bfloat16)
    grads[1] = store[1:]                          # a view one element past 16 bytes
    grads[1].copy_(torch.randn(4097))
    step, lr = torch.zeros((), dtype=torch.int32), torch.tensor(1e-3)
    before = kernel.launches
    with _Ops() as seen:
        buf = kernel.adamw_sumsq(grads)
        scalars = kernel.adamw_finish(buf, step, max_norm=1.0)
        kernel.adamw_step(grads, mus, nus, params, scalars, lr, b1=0.9, b2=0.95, eps=1e-8,
                          weight_decay=0.1, clip=True)
    # one allocation, the sums' buffer with its partials; no copy
    assert [op for op in seen.ops if "empty" in op] == ["aten.empty.memory_format"]
    assert not [op for op in seen.ops if "copy" in op or "clone" in op or "contiguous" in op]
    assert kernel.launches == before + 3 + 1 + 3
    (_, s), (_, f), (_, st) = fake_launch.calls
    plans = [kernel.choose_launch(g.numel(), "bfloat16") for g in grads]
    assert s[0] == 3 and s[1] == [g.data_ptr() for g in grads]
    assert s[3] == [p.nvec for p in plans] and s[4] == [p.tail for p in plans]
    assert s[5] == [p.grid for p in plans] and s[6] == [1, 0, 1] and s[7] == [0, 1, 2]
    assert s[8] == buf.data_ptr() - 4 * kernel.HEAD and s[9] == 3
    assert f[0] == buf.data_ptr() and f[1] == 3 and f[2] == scalars.data_ptr()
    assert st[1:5] == [[t.data_ptr() for t in tree] for tree in (grads, mus, nus, params)]
    assert st[9] == [1, 0, 1] and st[10] == scalars.data_ptr()


def test_the_plan_does_not_depend_on_the_address(fake_launch):
    store = torch.zeros(4098, dtype=torch.bfloat16)
    kernel.adamw_sumsq([store[:4097]])
    kernel.adamw_sumsq([store[1:]])
    (_, a), (_, b) = fake_launch.calls
    assert a[3:6] == b[3:6] and (a[6], b[6]) == ([1], [0])


def test_a_kept_leaf_list_skips_the_others(fake_launch):
    grads = _state([(5,), (9,), (17,)])[0]
    kernel.adamw_sumsq(grads, keep=[True, False, True])
    (_, s), = fake_launch.calls
    assert s[0] == 2 and s[1] == [grads[0].data_ptr(), grads[2].data_ptr()] and s[7] == [0, 2]


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("a plain version was called for a kernel launch")

    for name in ("sumsq_ref", "norm_scale_ref", "bias_corrections_ref", "adamw_step_ref"):
        monkeypatch.setattr(kernel, name, plain)
    grads, mus, nus, params = _state([(5,), (9,)])
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    before = kernel.launches
    with pytest.raises(RuntimeError, match="adamw_sumsq launch failed: CUDA error 700"):
        kernel.adamw_sumsq(grads)
    with pytest.raises(RuntimeError, match="adamw_finish launch failed: CUDA error 700"):
        kernel.adamw_finish(torch.zeros(6), None, max_norm=1.0)
    with pytest.raises(RuntimeError, match="adamw_step launch failed: CUDA error 700"):
        kernel.adamw_step(grads, mus, nus, params, torch.zeros(4), 1e-3, b1=0.9, b2=0.95,
                          eps=1e-8, weight_decay=0.1, clip=True)
    assert kernel.launches == before and len(fake_launch.calls) == 3


# ---------------------------------------------------------------------------
# the dry run's count of a step
# ---------------------------------------------------------------------------

def test_run_plain_counts_what_a_kernel_writes_in_place():
    x, y = torch.ones(8), torch.ones(3, dtype=torch.float64)

    def bump(x, y):
        x.add_(1.0)

    with CommCounter() as counter:
        run_plain(bump, x, y, writes=(x,))
    assert counter.bytes_accessed == 2 * 32 + 24 and counter.peak_bytes == 0
    assert torch.equal(x, torch.full((8,), 2.0))


@pytest.mark.parametrize("lr_form", ["float", "tensor"])
def test_one_step_counts_one_launch_a_pass_and_the_hand_counted_bytes(lr_form):
    """An AdamW step on a hand-made tree (bf16 and float32 leaves) under
    the dry run's counter: three launches (the sums, the finish, the
    update); bytes accessed: every gradient read for the sums and the
    sums' buffer (n + 4 floats) written; the finish reads the n sums, its
    four scalars and the step and writes the scalars and the step; the
    update reads the gradients, moments, parameters, scalars (and a tensor
    lr) and writes the moments and parameters.  The only storage made is
    the sums' buffer."""
    params = {"a": torch.randn(3, 5).bfloat16(), "b": torch.randn(7),
              "c": torch.randn(4097).bfloat16()}
    grads = {k: torch.randn(p.shape).to(p.dtype) for k, p in params.items()}
    state = T.adamw_init(params)
    lr = torch.tensor(1e-3) if lr_form == "tensor" else 1e-3
    launches = []
    with CommCounter() as counter:
        inner = plain_watchers[-1]

        def watcher(fn, args, writes=()):
            launches.append(fn)
            return inner(fn, args, writes)

        plain_watchers.append(watcher)
        try:
            _, _, norm = T.adamw_update(grads, state, params, lr=lr)
        finally:
            plain_watchers.remove(watcher)
    n = len(params)
    g = sum(t.numel() * t.element_size() for t in grads.values())
    p = sum(t.numel() * t.element_size() for t in params.values())
    m = sum(4 * t.numel() for t in params.values())
    buf = 4 * (n + 4)
    sums = g + buf
    finish = (4 * n + 16 + 4) + (16 + 4)
    update = (g + 2 * m + p + 16 + (4 if lr_form == "tensor" else 0)) + (2 * m + p)
    assert len(launches) == 3
    assert counter.bytes_accessed == sums + finish + update
    assert counter.peak_bytes == buf and counter.made(norm)
    assert int(state.step) == 1


@pytest.mark.parametrize("shape,rank", [((1, 2), 0), ((2, 2), 3)])
def test_a_sharded_step_reduces_the_sums_once_an_axis(shape, rank):
    """On a fake (1, 2) mesh with one leaf sharded over "model" and one
    replicated: one all-reduce of the n sums (the sharded axis), nothing
    else.  On a fake (2, 2) mesh at coordinate (1, 1), with one leaf
    sharded over each axis: two all-reduces, and this device sums no leaf
    (each is replicated on an axis where its coordinate is not 0)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place

    # dryrun.fake_mesh's group, with this process at ``rank``
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=shape[0] * shape[1])
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))

        def leaf(shape, pl, dtype=torch.bfloat16):
            return place(torch.empty(shape, device="meta", dtype=dtype), mesh, pl)

        params = {"w": leaf((8, 16), [Replicate(), Shard(1)]),
                  "s": leaf((16,), [Replicate(), Replicate()], torch.float32)}
        if shape == (2, 2):
            params["u"] = leaf((8, 16), [Shard(0), Replicate()])
        assert tuple(mesh.get_coordinate()) == (rank // shape[1], rank % shape[1])
        grads = {k: leaf(p.shape, p.placements, p.dtype) for k, p in params.items()}
        state = T.adamw_init(params)
        with CommCounter() as counter:
            _, _, norm = T.adamw_update(grads, state, params, lr=1e-3)
    finally:
        dist.destroy_process_group()
    got = collective_bytes(counter.records)
    axes = sum(n > 1 for n in shape)
    assert got["counts"]["all-reduce"] == axes and got["total_bytes"] == 4 * len(params) * axes
    assert norm.placements == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# chip_smoke.py's 19f
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_19f_covers_odd_sizes_both_dtypes_every_clip_and_lr_form():
    """Odd sizes (a tail in both dtypes), phi4-mini's two largest leaves,
    the misaligned base, both dtypes, every clip mode and both forms of lr,
    each form in at least one case."""
    smoke = _chip_smoke()
    cases = smoke.ADAMW_CASES
    sizes = {n for case in cases for n in case[1]}
    assert {1, 5, 3072, 4097, 2**20 + 3, 25_165_824, 614_989_824} <= sizes
    assert any(n % 4 for n in sizes)              # a tail in either dtype
    assert {c[2] for c in cases} == {"bfloat16", "float32"}
    assert {c[3] for c in cases} == {1.0, 0.0, 1e3}
    assert {c[4] for c in cases} == {"float", "tensor"}
    assert {(c[2], c[5]) for c in cases if c[5]} == {("bfloat16", 1), ("float32", 1)}
    for dt in ("bfloat16", "float32"):
        for clip in (1.0, 0.0, 1e3):
            for lr in ("float", "tensor"):
                assert any(c[2:5] == (dt, clip, lr) for c in cases), (dt, clip, lr)
    assert smoke.ADAMW_STEPS == 3
    leaves = smoke.phi4_leaves()
    assert len(leaves) == 291 and sum(int(np.prod(s)) for s, _ in leaves) == 4_451_404_800
