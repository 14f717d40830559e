"""B5, the port's cross-entropy on a vocabulary shard
(``repro_torch.kernels.cross_entropy``), on the CPU.

The kernels run only on the card (``chip_smoke.py`` phase 19g holds them
against their plain versions there); here the plain versions stand in for
them, through the same wrappers and the same autograd Function.  Inputs are
numpy-seeded float32 logits at small widths; labels hold -1 (masked), 0,
the last column and a fully masked row.  Tolerances: the loss and its
gradient within rtol 1e-5 (the train tests'), atol 1e-6, of JAX's
``cross_entropy`` and ``jax.grad`` of it.

* Unsharded: each token's ``lse - gold`` and ``train_lib.cross_entropy``'s
  mean and ``dlogits`` against JAX.
* Sharded: the columns split over shards (even, and 10 over 3 as
  ``torch.chunk`` splits them: 4, 4, 2, and an empty shard), each shard's
  partials combined by :func:`ops.combine` in lockstep threads whose
  reductions meet as a collective's would, against the unsharded result;
  then on gloo process groups, ``train_lib.cross_entropy`` of
  vocabulary-sharded DTensor logits on (1, 2) and (1, 3) meshes against
  JAX, with the loss's collectives counted: one max all-reduce of
  ``(rows,)`` and one sum all-reduce of ``(rows, 2)`` float32, nothing else.
  On a fake process group (whose collectives move nothing) each rank's
  shard starts where ``torch.chunk`` puts it.
* The wrapper: routing (CPU and meta through ``run_plain``, a DTensor
  refused), its refusals (bf16 logits, int32 labels, a label out of range,
  mismatched shapes), a non-contiguous input copied once and counted, the
  plan a function of the shape alone, the library call over a fake library
  (the tensors' own pointers, a failed launch raises and never reaches the
  plain version), and the dry run's count of each launch.
* ``chip_smoke.py``'s 19g case list covers the shapes the main path gives
  B5 and the label edge cases.
"""

import importlib.util
import inspect
import os
import threading
import types
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from _sharded_harness import run_mesh  # noqa: E402
from repro.training.train_lib import cross_entropy as j_cross_entropy  # noqa: E402
from repro_torch.kernels import plain_watchers  # noqa: E402
from repro_torch.kernels.cross_entropy import kernel, ops  # noqa: E402
from repro_torch.kernels.cross_entropy.ref import ce_backward_ref, ce_partials_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.training.train_lib import cross_entropy  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
# (B, S, V): V 11 and 33 leave a tail after the last group of 4 columns
SHAPES = [(2, 5, 11), (3, 4, 33), (2, 8, 512)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(B, S, V, seed=0):
    """Logits of scale 3 and labels with every edge: -1 (masked), 0, the
    last column, and row 1 fully masked."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V)) * 3.0).astype(np.float32)
    labels = rng.integers(-1, V, (B, S)).astype(np.int64)
    labels[0, :3] = [-1, 0, V - 1]
    labels[1] = -1
    return logits, labels


def _jax(logits, labels):
    """JAX's mean loss, its gradient, and each token's masked loss (the
    mean over one token: its nll, or 0 where it is masked)."""
    jl, jy = jnp.asarray(logits), jnp.asarray(labels.astype(np.int32))
    loss, grad = jax.value_and_grad(j_cross_entropy)(jl, jy)
    per = jax.vmap(lambda x, y: j_cross_entropy(x[None], y[None]))(
        jl.reshape(-1, jl.shape[-1]), jy.reshape(-1))
    return float(loss), np.asarray(grad), np.asarray(per).reshape(labels.shape)


# ---------------------------------------------------------------------------
# the plain Function against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_token_loss_and_grad_match_jax(shape):
    logits, labels = _inputs(*shape)
    want_loss, want_grad, want_per = _jax(logits, labels)
    x = torch.tensor(logits, requires_grad=True)
    y = torch.tensor(labels)
    nll = ops.token_nll(x, y)
    mask = (y >= 0).float()
    np.testing.assert_allclose((nll * mask).detach().numpy(), want_per, rtol=RTOL, atol=ATOL)
    loss = cross_entropy(x, y)
    (grad,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)
    # a masked token (the fully masked row among them) has no gradient
    assert not grad[1].any() and not grad[0, 0].any()


def test_partials_and_backward_ref_are_the_whole_row_arithmetic():
    """On one shard: ``m`` the max, ``lse = m + log(s)`` torch's
    logsumexp, ``gold`` the clamped label's logit; the backward's rows sum
    to ``g·(1 - 1)`` = 0 where the shard holds the label."""
    logits, labels = _inputs(3, 4, 33, seed=1)
    x, y = torch.tensor(logits).view(-1, 33), torch.tensor(labels).view(-1)
    m, s, gold = ce_partials_ref(x, y, 0, 33)
    torch.testing.assert_close(m, x.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(m + torch.log(s), torch.logsumexp(x, -1), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gold, x.gather(-1, y.clamp(min=0)[:, None])[:, 0], rtol=0,
                               atol=0)
    g = torch.rand(12)
    d = ce_backward_ref(x, y, 0, m + torch.log(s), g)
    torch.testing.assert_close(d.sum(-1), torch.zeros(12), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# shards combined: lockstep threads, gloo meshes, a fake mesh
# ---------------------------------------------------------------------------

def _lockstep(n):
    """``n`` reduce functions, one a thread, that meet as a collective's
    ranks do: each call blocks until all ``n`` have given their tensor,
    and every one gets the reduction of all of them (a rank that never
    comes breaks the barrier after 60 s, so a failing rank fails the test
    instead of hanging it)."""
    barrier, slots = threading.Barrier(n, timeout=60), [None] * n

    def make(rank):
        def reduce(t, op):
            slots[rank] = t
            barrier.wait()
            stacked = torch.stack(slots)
            out = stacked.amax(0) if op == "max" else stacked.sum(0)
            barrier.wait()
            return out
        return reduce

    return [make(r) for r in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_sharded_partials_combine_to_the_unsharded_loss(n):
    """10 columns over n shards as ``torch.chunk`` splits them (3: 4, 4, 2;
    6: five of 2 and an empty one): each shard's partials and its combine,
    in lockstep, give every shard the unsharded ``lse`` and ``gold``; the
    shards' gradients laid side by side are the unsharded gradient."""
    V = 10
    logits, labels = _inputs(2, 6, V, seed=2)
    x, y = torch.tensor(logits).view(-1, V), torch.tensor(labels).view(-1)
    whole_m, whole_s, whole_gold = ce_partials_ref(x, y, 0, V)
    lse, gold = ops.combine(whole_m, whole_s, whole_gold)
    g = torch.rand(12)
    want_grad = ce_backward_ref(x, y, 0, lse, g)
    chunks = list(torch.chunk(x, n, dim=-1))
    chunks += [x[:, :0]] * (n - len(chunks))
    starts = np.cumsum([0] + [c.shape[-1] for c in chunks[:-1]])
    reducers = _lockstep(n)
    out = [None] * n

    def rank(r):
        m, s, gd = kernel.ce_partials(chunks[r], y, int(starts[r]), V)
        out[r] = ops.combine(m, s, gd, reducers[r] if n > 1 else None)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for r_lse, r_gold in out:
        torch.testing.assert_close(r_lse, lse, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(r_gold, gold, rtol=0, atol=0)
    got = torch.cat([kernel.ce_backward(c, y, int(st), lse, g, V) for c, st in zip(chunks, starts)],
                    dim=-1)
    torch.testing.assert_close(got, want_grad, rtol=0, atol=0)
    if n == 1:          # one shard is the unsharded arithmetic, bit for bit
        assert torch.equal(out[0][0], lse) and torch.equal(ops.token_nll(x, y), lse - gold)


@pytest.mark.parametrize("n", [1, 3])
def test_minus_inf_columns_match_jax(n):
    """Logits with -inf columns (11-21 of 33, the whole middle shard of
    three, and a scattered few; column 0 and every label finite): each
    token's loss and the gradient against JAX's, the shards combined in
    lockstep.  A shard whose columns are all -inf adds nothing (``s`` 0,
    not NaN)."""
    V = 33
    logits, labels = _inputs(2, 6, V, seed=7)
    logits[..., 11:22] = -np.inf
    logits[0, 1, 5] = logits[1, 3, 30] = -np.inf
    labels[(labels >= 11) & (labels < 22)] = 3
    labels[0, 1] = labels[1, 3] = 2
    want_loss, want_grad, want_per = _jax(logits, labels)
    x, y = torch.tensor(logits).view(-1, V), torch.tensor(labels).view(-1)
    chunks = list(torch.chunk(x, n, dim=-1))
    starts = np.cumsum([0] + [c.shape[-1] for c in chunks[:-1]])
    reducers, out, sums = _lockstep(n), [None] * n, [None] * n

    def rank(r):
        m, sums[r], gd = kernel.ce_partials(chunks[r], y, int(starts[r]), V)
        out[r] = ops.combine(m, sums[r], gd, reducers[r] if n > 1 else None)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert all(torch.isfinite(s).all() for s in sums)
    mask = (y >= 0).float()
    for r_lse, r_gold in out:
        np.testing.assert_allclose(((r_lse - r_gold) * mask).view(labels.shape).numpy(),
                                   want_per, rtol=RTOL, atol=ATOL)
    lse = out[0][0]
    g = mask / mask.sum()
    got = torch.cat([kernel.ce_backward(c, y, int(st), lse, g, V) for c, st in zip(chunks, starts)],
                    dim=-1)
    np.testing.assert_allclose(got.view(logits.shape).numpy(), want_grad, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(((lse - out[0][1]) * g).sum()), want_loss, rtol=RTOL,
                               atol=ATOL)


def sharded_loss(mesh, shape, logits, labels):
    """On one rank of a gloo ``("data", "model")`` mesh: the logits placed
    vocabulary-sharded over "model", the labels replicated; the loss, its
    gradient gathered whole, the loss's collectives by op and operand
    bytes, and each rank's shard width and start (gathered)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place, shard_offset
    from repro_torch.launch.comm_analysis import CommCounter

    x = place(torch.tensor(logits), mesh, [Replicate(), Shard(2)]).requires_grad_()
    y = place(torch.tensor(labels), mesh, [Replicate(), Replicate()])
    with CommCounter() as counter:
        loss = cross_entropy(x, y)
    with CommCounter() as back:
        (grad,) = torch.autograd.grad(loss, x)
    shards = [None] * dist.get_world_size()
    dist.all_gather_object(shards, (x.to_local().shape[-1], shard_offset(x, 2)))
    return dict(loss=float(loss.full_tensor()), grad=grad.full_tensor().numpy(),
                forward=[r for r in counter.records if r[0] != "wait_tensor"],
                backward=[r for r in back.records if r[0] != "wait_tensor"], shards=shards,
                grad_placements=[str(p) for p in grad.placements])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("model,V", [(2, 12), (3, 10)], ids=["even 12 over 2", "uneven 10 over 3"])
def test_vocabulary_sharded_loss_on_gloo_matches_jax(tmp_path, model, V):
    """``train_lib.cross_entropy`` of DTensor logits sharded over a gloo
    mesh's model axis equals JAX's loss and gradient; its only collectives
    are the combine's: a max all-reduce of ``(rows,)`` and a sum all-reduce
    of ``(rows, 2)`` float32 (rows = B·S), none in the backward, and the
    gradient stays sharded as the logits."""
    logits, labels = _inputs(2, 6, V, seed=3)
    want_loss, want_grad, _ = _jax(logits, labels)
    got = run_mesh((1, model), sharded_loss, (logits, labels), tmp_path)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["grad"], want_grad, rtol=RTOL, atol=ATOL)
    rows = labels.size
    assert sorted(got["forward"]) == sorted([("all_reduce", 4 * rows), ("all_reduce", 8 * rows)])
    assert got["backward"] == []
    widths = [c.shape[-1] for c in torch.chunk(torch.zeros(V), model)]
    assert got["shards"] == [(w, sum(widths[:r])) for r, w in enumerate(widths)]
    assert got["grad_placements"] == ["R", "S(2)"]


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_each_rank_of_a_fake_mesh_takes_its_chunk_of_the_columns(rank):
    """10 columns over a fake (1, 3) mesh at each rank: the plain version
    is given that rank's ``torch.chunk`` (4, 4, 2 columns from 0, 4, 8) and
    the loss records the combine's two all-reduces."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place
    from repro_torch.launch.comm_analysis import CommCounter, collective_bytes

    logits, labels = _inputs(2, 6, 10, seed=4)
    seen = []
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=3)
    try:
        mesh = init_device_mesh("cpu", (1, 3), mesh_dim_names=("data", "model"))
        x = place(torch.tensor(logits), mesh, [Replicate(), Shard(2)])
        y = place(torch.tensor(labels), mesh, [Replicate(), Replicate()])
        with CommCounter() as counter:
            inner = plain_watchers[-1]

            def watcher(fn, args, writes=()):
                if fn is ce_partials_ref:
                    seen.append((tuple(args[0].shape), args[2], args[3]))
                return inner(fn, args, writes)

            plain_watchers.append(watcher)
            try:
                cross_entropy(x, y)
            finally:
                plain_watchers.remove(watcher)
    finally:
        dist.destroy_process_group()
    assert seen == [((12, (4, 4, 2)[rank]), (0, 4, 8)[rank], 10)]
    got = collective_bytes(counter.records)
    assert got["counts"]["all-reduce"] == 2 and got["total_bytes"] == 12 * (4 + 8)


# ---------------------------------------------------------------------------
# the wrapper: routing, refusals, copies, the plan
# ---------------------------------------------------------------------------

def test_cpu_and_meta_take_the_plain_versions_through_run_plain():
    seen = []

    def watcher(fn, args, writes=()):
        seen.append(fn)
        return fn(*args)

    before = kernel.launches
    plain_watchers.append(watcher)
    try:
        for device in ("cpu", "meta"):
            x = torch.zeros(2, 3, 8, device=device, requires_grad=True)
            y = torch.zeros(2, 3, dtype=torch.long, device=device)
            nll = ops.token_nll(x, y)
            torch.autograd.grad(nll.sum(), x)
    finally:
        plain_watchers.remove(watcher)
    assert seen == [ce_partials_ref, ce_backward_ref] * 2
    assert kernel.launches == before


def test_a_dtensor_is_refused():
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed import place

    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        x = place(torch.zeros(4, 8), mesh, [Replicate(), Replicate()])
        y = place(torch.zeros(4, dtype=torch.long), mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="local shard"):
            kernel.ce_partials(x, y, 0, 8)
        with pytest.raises(TypeError, match="local shard"):
            kernel.ce_backward(x, y, 0, torch.zeros(4), torch.zeros(4), 8)


@pytest.mark.parametrize("case", ["bf16 logits", "float64 logits", "int32 labels",
                                  "label out of range", "labels' shape", "shard past vocab",
                                  "negative start", "devices"])
def test_the_wrapper_refuses(case):
    x, y, start, vocab = torch.zeros(4, 8), torch.zeros(4, dtype=torch.long), 0, 8
    if case == "bf16 logits":
        x = x.bfloat16()
    elif case == "float64 logits":
        x = x.double()
    elif case == "int32 labels":
        y = y.int()
    elif case == "label out of range":
        y[2] = 8
    elif case == "labels' shape":
        y = torch.zeros(5, dtype=torch.long)
    elif case == "shard past vocab":
        start = 4
    elif case == "negative start":
        start = -1
    elif case == "devices":
        y = y.to("meta")
    with pytest.raises(ValueError, match="cross_entropy"):
        kernel.ce_partials(x, y, start, vocab)


def test_the_backward_checks_lse_and_g():
    x, y = torch.zeros(4, 8), torch.zeros(4, dtype=torch.long)
    for lse, g in ((torch.zeros(3), torch.zeros(4)), (torch.zeros(4), torch.zeros(4).double())):
        with pytest.raises(ValueError, match="cross_entropy"):
            kernel.ce_backward(x, y, 0, lse, g, 8)


def test_a_non_contiguous_input_is_copied_once_and_counted():
    logits, labels = _inputs(2, 5, 11, seed=5)
    x = torch.tensor(logits)
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)   # (2, 5, 11), not contiguous
    assert not strided.is_contiguous()
    y = torch.tensor(labels)
    before = kernel.layout_copies
    got = kernel.ce_partials(strided, y, 0, 11)
    assert kernel.layout_copies == before + 1
    want = kernel.ce_partials(x, y, 0, 11)
    assert kernel.layout_copies == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("width", [0, 1, 4, 11, 512, 12504, 200064])
def test_the_plan_covers_every_column_once(width, fake_launch):
    """One block a row, and the library gets each row's whole width (the
    kernel splits a row's columns among its threads itself); an empty
    shard's backward launches nothing."""
    assert kernel.choose_launch(7, width) == kernel.Launch(grid=7)
    x, y = torch.zeros(7, width), torch.zeros(7, dtype=torch.long)
    before = kernel.launches
    kernel.ce_partials(x, y, 0, max(width, 1))
    kernel.ce_backward(x, y, 0, torch.zeros(7), torch.zeros(7), max(width, 1))
    assert [(c[0], c[1][2], c[1][3]) for c in fake_launch.calls[:1]] == [("partials", 7, width)]
    if width:
        assert fake_launch.calls[1][0] == "backward" and fake_launch.calls[1][1][4:6] == (7, width)
    assert kernel.launches - before == len(fake_launch.calls) == 1 + bool(width)


def test_an_empty_input_launches_and_counts_nothing(fake_launch):
    """No rows (or no columns, backward): nothing reaches the library and
    ``launches`` does not grow; the outputs have the inputs' shapes."""
    before = kernel.launches
    x, y = torch.zeros(0, 12), torch.zeros(0, dtype=torch.long)
    m, s, gold = kernel.ce_partials(x, y, 0, 12)
    dx = kernel.ce_backward(x, y, 0, torch.zeros(0), torch.zeros(0), 12)
    assert m.shape == s.shape == gold.shape == (0,) and dx.shape == (0, 12)
    assert not fake_launch.calls and kernel.launches == before


def test_the_plan_is_a_function_of_the_shape_alone():
    assert list(inspect.signature(kernel.choose_launch).parameters) == ["rows", "width"]
    assert kernel.choose_launch(65536, 12504) == kernel.choose_launch(65536, 12504)
    with pytest.raises(ValueError, match="cross_entropy"):
        kernel.choose_launch(2**31, 8)
    with pytest.raises(ValueError, match="cross_entropy"):
        kernel.choose_launch(-1, 8)


# ---------------------------------------------------------------------------
# the library call, over a fake library
# ---------------------------------------------------------------------------

class _FakeLibrary:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def ce_partials(self, *args):
        self.calls.append(("partials", args))
        return self.rc

    def ce_backward(self, *args):
        self.calls.append(("backward", args))
        return self.rc


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


def test_the_library_gets_the_tensors_own_pointers_and_the_plan(fake_launch):
    x = torch.zeros(2, 3, 12)
    y = torch.zeros(2, 3, dtype=torch.long)
    before, copies = kernel.launches, kernel.layout_copies
    m, s, gold = kernel.ce_partials(x, y, 24, 100)
    lse, g = torch.zeros(2, 3), torch.zeros(2, 3)
    dx = kernel.ce_backward(x, y, 24, lse, g, 100)
    assert kernel.launches == before + 2 and kernel.layout_copies == copies
    (_, p), (_, b) = fake_launch.calls
    assert p[:7] == (x.data_ptr(), y.data_ptr(), 6, 12, 24, 100, 1)
    assert p[7] == m.data_ptr() and s.data_ptr() == m.data_ptr() + 4 * 6
    assert gold.data_ptr() == m.data_ptr() + 8 * 6 and m.shape == (2, 3)
    assert b[:8] == (x.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(), 6, 12, 24, 1)
    assert b[8] == dx.data_ptr() and dx.shape == x.shape
    # a width off the 4-column group, or a base off 16 bytes: scalar loads
    kernel.ce_partials(torch.zeros(6, 11), torch.zeros(6, dtype=torch.long), 0, 11)
    kernel.ce_partials(torch.zeros(49)[1:].view(6, 8), torch.zeros(6, dtype=torch.long), 0, 8)
    assert [c[1][6] for c in fake_launch.calls[2:]] == [0, 0]


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("a plain version was called for a kernel launch")

    monkeypatch.setattr(kernel, "ce_partials_ref", plain)
    monkeypatch.setattr(kernel, "ce_backward_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    x, y = torch.zeros(4, 8), torch.zeros(4, dtype=torch.long)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="ce_partials launch failed: CUDA error 700"):
        kernel.ce_partials(x, y, 0, 8)
    with pytest.raises(RuntimeError, match="ce_backward launch failed: CUDA error 700"):
        kernel.ce_backward(x, y, 0, torch.zeros(4), torch.zeros(4), 8)
    assert kernel.launches == before and len(fake_launch.calls) == 2


# ---------------------------------------------------------------------------
# the dry run's count
# ---------------------------------------------------------------------------

def test_each_launch_counts_its_inputs_and_outputs_once():
    """On meta tensors, rows R x width V: the forward reads the logits and
    the labels and writes three floats a row; the backward reads the
    logits, labels, lse and g and writes the gradient.  Nothing else is
    made (the plain versions' intermediates are not the kernel's)."""
    R, V = 64, 1000
    x = torch.empty(R, V, device="meta")
    y = torch.empty(R, dtype=torch.long, device="meta")
    with torch.no_grad():
        fwd = dryrun.count_step(lambda: kernel.ce_partials(x, y, 0, V))
        lse, g = torch.empty(R, device="meta"), torch.empty(R, device="meta")
        bwd = dryrun.count_step(lambda: kernel.ce_backward(x, y, 0, lse, g, V))
    assert fwd["bytes_accessed"] == 4 * R * V + 8 * R + 3 * 4 * R
    assert fwd["output_bytes"] == 3 * 4 * R and fwd["temp_bytes"] == 0
    assert bwd["bytes_accessed"] == 4 * R * V + 8 * R + 2 * 4 * R + 4 * R * V
    assert bwd["output_bytes"] == 4 * R * V and bwd["temp_bytes"] == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's 19g
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_19g_covers_the_paths_shapes_and_the_label_edges():
    """19c's logits (2 x 512 x 200192: phi4-mini's vocabulary padded), one
    device's shard at phi4-mini's train_4k on 16x16 (65536 x 12512 from a
    nonzero start), xlstm-125m's 2 x 512 x 50432 (21d), the smoke configs'
    widths (19d), a width off the 4-column group, a base off 16 bytes, and
    the label edges: -1, 0, the shard's last column, outside the shard, a
    fully masked row."""
    import repro_torch.configs as C

    smoke = _chip_smoke()
    cases = {c.label: c for c in smoke.ce_cases()}
    shapes = {(c.rows, c.width) for c in cases.values()}
    phi4, xlstm = C.get("phi4-mini-3.8b"), C.get("xlstm-125m")
    assert (1024, phi4.padded_vocab) in shapes and (1024, xlstm.padded_vocab) in shapes
    shard = [c for c in cases.values() if (c.rows, c.width) == (16 * 4096, 12512)]
    assert phi4.padded_vocab == 200192 == 16 * 12512 and xlstm.padded_vocab == 50432
    assert shard and shard[0].start > 0 and shard[0].vocab == phi4.padded_vocab
    for arch in smoke.SMOKE_TRAIN_ARCHS:
        cfg = C.get(arch, smoke=True)
        assert (smoke.TRAIN_BATCH * 64, cfg.padded_vocab) in shapes, arch
    assert any(c.width % 4 for c in cases.values())
    assert any(c.offset for c in cases.values())
    kinds = {k for c in cases.values() for k in smoke.ce_label_edges(c)}
    assert {"masked", "zero", "last", "outside"} <= kinds
    for c in cases.values():
        edges = smoke.ce_label_edges(c)
        assert edges["masked"] == -1 and edges["last"] == c.start + c.width - 1
        assert c.rows > c.seq >= len(edges)    # the edges lie before the masked sequence
        if "outside" in edges:
            assert not c.start <= edges["outside"] < c.start + c.width
    # -inf columns fill the first groups of every thread but thread 0's
    assert any(c.neg_inf >= 4 * kernel.THREADS * 4 and 4 + c.neg_inf < c.width
               for c in cases.values())
    assert smoke.CE_GRAD_RTOL > 0 and smoke.ce_sum_rtol(200064) < 1e-3
