"""B9, the port's rotary embeddings (``repro_torch.kernels.rotary``), on the
CPU.

The kernel runs only on the card (``chip_smoke.py`` phase 3e holds it bit
for bit against its plain version there); here the plain version stands in
for it, through the same wrapper and the same autograd Function.  Inputs are
numpy-seeded at small widths: head_dim 8, 80 (zamba2's half of 40), 16 and
32, DeepSeek's q_rope (a 16-wide slice of 48-wide heads) and k_rope (a
slice of the latents' rows, one head), a decode step at per-row offsets.
Tolerances:

* the forward against JAX's ``apply_rope``: float32 within 1e-6 (rtol and
  atol: the tables' cos and sin of two libraries), bf16 within one bf16
  ulp of JAX's value;
* the backward (:class:`ops.Rotary`: the same rotation by -sin) against
  ``jax.grad`` of ``apply_rope`` within 1e-5, and bit for bit against
  ``torch.autograd`` of the plain forward (each rounds the same products
  and sums once).

Also: the wrapper's refusals, the vector flag, a last dimension that is
not contiguous copied once and counted, the library call over a fake
library (the tensors' own pointers, x's strides and the tables', ``negate``,
a failed launch raises and never reaches the plain version, no tokens
launch nothing), the routing (CPU and meta through ``run_plain``, a DTensor
refused by the wrapper and run on its local shards by ``apply_rope``, on
gloo (1, 2) and (2, 1) meshes with no collective), the dry run's count, the
train step's and the served engine's B8 and B9 calls as ``chip_smoke.py``
counts them in its replays, and its 3e case list.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from _sharded_harness import run_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import plain_watchers  # noqa: E402
from repro_torch.kernels.rotary import kernel, ops  # noqa: E402
from repro_torch.kernels.rotary.ref import rope_tables, rotary_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-6
GRAD_TOL = 1e-5
THETA = 10000.0
# (B, S, heads, head_dim, layout): layout None, ("heads", width, start) a
# slice of wider heads, or ("rows", width, start) a slice of wider rows
CASES = [(2, 5, 3, 8, None), (2, 6, 4, 80, None), (3, 4, 2, 32, None),
         (2, 6, 4, 16, ("heads", 48, 32)), (2, 6, 1, 16, ("rows", 48, 32)), (2, 3, 3, 6, None)]
IDS = ["hd8", "hd80", "hd32", "q_rope view", "k_rope view", "odd half"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(B, S, H, hd, layout, seed=0, offsets=False):
    """x (numpy, its storage's shape) and the torch view the layout makes,
    the positions (per-row offsets with ``offsets``), and dy."""
    rng = np.random.default_rng(seed)
    if layout is None:
        store = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    elif layout[0] == "heads":
        store = rng.standard_normal((B, S, H, layout[1])).astype(np.float32)
    else:
        store = rng.standard_normal((B, S, layout[1])).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    if offsets:
        pos += rng.integers(0, 1000, (B, 1))
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return store, pos, dy


def _view(t, H, hd, layout):
    if layout is None:
        return t
    if layout[0] == "heads":
        return t[..., layout[2]:layout[2] + hd]
    return t[..., layout[2]:layout[2] + hd][:, :, None, :]


def _bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), np.float32(2.0 ** -126))
    return np.ldexp(np.float32(1.0), np.frexp(a)[1] - 8)


# ---------------------------------------------------------------------------
# the plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offsets", [False, True], ids=["arange", "offsets"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax_float32(case, offsets):
    B, S, H, hd, layout = case
    store, pos, _ = _inputs(*case, seed=hd, offsets=offsets)
    x = _view(torch.tensor(store), H, hd, layout)
    got = TL.apply_rope(x, torch.tensor(pos), THETA)
    want = JL.apply_rope(_view(jnp.asarray(store), H, hd, layout), jnp.asarray(pos, jnp.int32),
                         THETA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax_bf16_within_one_ulp(case):
    B, S, H, hd, layout = case
    store, pos, _ = _inputs(*case, seed=hd + 1, offsets=True)
    x = _view(torch.tensor(store).bfloat16(), H, hd, layout)
    got = TL.apply_rope(x, torch.tensor(pos), THETA)
    assert got.dtype == torch.bfloat16
    jx = _view(jnp.asarray(store, jnp.bfloat16), H, hd, layout)
    want = np.asarray(JL.apply_rope(jx, jnp.asarray(pos, jnp.int32), THETA).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), diff.max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_jax_grad(case):
    B, S, H, hd, layout = case
    store, pos, dy = _inputs(*case, seed=hd + 2, offsets=True)
    want = jax.grad(lambda s: jnp.sum(JL.apply_rope(_view(s, H, hd, layout),
                                                    jnp.asarray(pos, jnp.int32), THETA) * dy))(
        jnp.asarray(store))
    ts = torch.tensor(store, requires_grad=True)
    TL.apply_rope(_view(ts, H, hd, layout), torch.tensor(pos), THETA).backward(torch.tensor(dy))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_is_autograd_of_the_plain_forward_bit_for_bit(case, dtype):
    """The rotation by -sin gives the bits autograd gives through the plain
    forward's products, difference, sum, concatenation and casts."""
    B, S, H, hd, layout = case
    store, pos, dy = _inputs(*case, seed=hd + 3, offsets=True)
    cos, sin = rope_tables(torch.tensor(pos), hd, THETA)
    x = _view(torch.tensor(store).to(dtype), H, hd, layout).detach().requires_grad_()
    d = torch.tensor(dy).to(dtype)
    rotary_ref(x, cos, sin).backward(d)
    xx = x.detach().clone().requires_grad_()
    ops.Rotary.apply(xx, cos, sin).backward(d)
    assert torch.equal(xx.grad, x.grad)


# ---------------------------------------------------------------------------
# the wrapper's contracts
# ---------------------------------------------------------------------------

REFUSALS = ["float16 x", "3-d x", "odd head_dim", "float64 tables", "tables' shape",
            "tables apart", "devices"]


@pytest.mark.parametrize("case", REFUSALS)
def test_the_wrapper_refuses(case):
    x = torch.zeros(2, 3, 4, 8)
    cos = sin = torch.zeros(2, 3, 4)
    if case == "float16 x":
        x = x.half()
    elif case == "3-d x":
        x = x[0]
    elif case == "odd head_dim":
        x = torch.zeros(2, 3, 4, 7)
    elif case == "float64 tables":
        cos = sin = cos.double()
    elif case == "tables' shape":
        cos = sin = torch.zeros(2, 4, 4)
    elif case == "tables apart":
        sin = torch.zeros(1, 3, 4)
    elif case == "devices":
        cos = sin = cos.to("meta")
    with pytest.raises(ValueError, match="rotary"):
        kernel.rotary(x, cos, sin)


def test_the_vector_flag():
    """Four elements at a time where x's rows, the tables and the halves sit
    on four elements: 19c's q, DeepSeek's q_rope and k_rope views, the
    tables broadcast over the batch; not an odd half or a base off."""
    cos, sin = rope_tables(torch.arange(6).expand(2, 6), 64, THETA)
    q = torch.zeros(2, 6, 4, 64, dtype=torch.bfloat16)
    q_rope = torch.zeros(2, 6, 4, 192, dtype=torch.bfloat16)[..., 128:]
    k_rope = torch.zeros(2, 6, 576, dtype=torch.bfloat16)[..., 512:][:, :, None, :]
    assert kernel.vectors(q, cos, sin) and kernel.vectors(q_rope, cos, sin)
    assert kernel.vectors(k_rope, cos, sin)
    assert kernel.vectors(q, cos[:1].expand(2, 6, 32), sin[:1].expand(2, 6, 32))
    off = torch.zeros(2 * 6 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 6, 4, 64)
    assert not kernel.vectors(off, cos, sin)
    c3, s3 = rope_tables(torch.arange(6).expand(2, 6), 6, THETA)
    assert not kernel.vectors(torch.zeros(2, 6, 4, 6), c3, s3)


class _FakeLibrary:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def rotary(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrapper on CPU tensors up to the library call: the routing takes
    the card's branch, the stream is stubbed, the library is a fake."""
    import types

    lib = _FakeLibrary()
    monkeypatch.setattr(kernel, "takes_plain", lambda t: False)
    monkeypatch.setattr(kernel, "library", lambda device: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_the_library_gets_the_tensors_own_pointers_and_strides(fake_launch):
    """DeepSeek's q_rope, a 64-wide slice of 192-wide heads, read where it
    lies; the tables broadcast over the batch (stride 0); the backward's
    ``negate``."""
    q_rope = torch.zeros(2, 6, 4, 192, dtype=torch.bfloat16)[..., 128:]
    cos, sin = rope_tables(torch.arange(6)[None], 64, THETA)
    before = (kernel.launches, kernel.layout_copies)
    out = kernel.rotary(q_rope, cos, sin)
    dx = kernel.rotary(q_rope, cos, sin, negate=True)
    assert (kernel.launches, kernel.layout_copies) == (before[0] + 2, before[1])
    a, b = fake_launch.calls
    assert a[:8] == (q_rope.data_ptr(), 2, 6, 4, 32, 6 * 4 * 192, 4 * 192, 192)
    assert a[8:12] == (cos.data_ptr(), sin.data_ptr(), 0, 32)
    assert a[12:16] == (0, 1, 1, out.data_ptr()) and b[12] == 1 and b[15] == dx.data_ptr()
    assert out.shape == dx.shape == q_rope.shape and out.is_contiguous()


def test_a_last_dimension_apart_is_copied_once_and_counted(fake_launch):
    x = torch.zeros(2, 3, 8, 4).transpose(-1, -2)
    cos, sin = rope_tables(torch.arange(3).expand(2, 3), 8, THETA)
    before = kernel.layout_copies
    kernel.rotary(x, cos, sin)
    assert kernel.layout_copies == before + 1
    assert fake_launch.calls[0][0] != x.data_ptr() and fake_launch.calls[0][7] == 8


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("a plain version was called for a kernel launch")

    monkeypatch.setattr(kernel, "rotary_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    cos, sin = rope_tables(torch.arange(3).expand(2, 3), 8, THETA)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="rotary launch failed: CUDA error 700"):
        kernel.rotary(torch.zeros(2, 3, 4, 8), cos, sin)
    assert kernel.launches == before and len(fake_launch.calls) == 1


def test_no_tokens_launch_and_count_nothing(fake_launch):
    cos, sin = rope_tables(torch.zeros(2, 0, dtype=torch.long), 8, THETA)
    before = kernel.launches
    out = kernel.rotary(torch.zeros(2, 0, 4, 8), cos, sin)
    assert out.shape == (2, 0, 4, 8) and not fake_launch.calls and kernel.launches == before


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _watch(seen):
    inner = plain_watchers[-1] if plain_watchers else (lambda fn, args, writes=(): fn(*args))

    def watcher(fn, args, writes=()):
        seen.append(getattr(fn, "func", fn).__name__)
        return inner(fn, args, writes)

    return watcher


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_version_through_run_plain(device):
    x = torch.randn(2, 5, 3, 8, device=device, requires_grad=True)
    pos = torch.arange(5, device=device).expand(2, 5)
    seen = []
    plain_watchers.append(_watch(seen))
    before = kernel.launches
    try:
        y = TL.apply_rope(x, pos, THETA)
        y.backward(torch.ones_like(y))
    finally:
        plain_watchers.pop()
    assert seen == ["rotary_ref", "rotary_ref"] and kernel.launches == before
    assert x.grad.shape == x.shape


def test_a_dtensor_is_refused_by_the_wrapper():
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed import place

    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        x = place(torch.zeros(2, 3, 4, 8), mesh, [Replicate(), Replicate()])
        cos, sin = rope_tables(torch.arange(3).expand(2, 3), 8, THETA)
        with pytest.raises(TypeError, match="local_map"):
            kernel.rotary(x, cos, sin)


def sharded_rope(mesh, shape, x, pos, dy):
    """On one rank of a gloo mesh: x sharded on batch over "data" and heads
    over "model", the positions a plain tensor; the output and x's gradient
    gathered whole, and the forward's collectives."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import place
    from repro_torch.launch.comm_analysis import CommCounter

    xs = place(torch.tensor(x), mesh, [Shard(0), Shard(2)]).requires_grad_()
    with CommCounter() as counter:
        y = TL.apply_rope(xs, torch.tensor(pos), THETA)
    (gx,) = torch.autograd.grad(y, (xs,), place(torch.tensor(dy), mesh, list(y.placements)))
    return dict(y=y.full_tensor().detach().numpy(), gx=gx.full_tensor().numpy(),
                placements=[str(p) for p in y.placements],
                forward=[r for r in counter.records if r[0] != "wait_tensor"])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_a_dtensor_runs_on_its_local_shards(tmp_path, shape):
    store, pos, dy = _inputs(2, 6, 4, 16, None, seed=5, offsets=True)
    got = run_mesh(shape, sharded_rope, (store, pos, dy), tmp_path)
    x = torch.tensor(store, requires_grad=True)
    y = TL.apply_rope(x, torch.tensor(pos), THETA)
    y.backward(torch.tensor(dy))
    assert np.array_equal(got["y"], y.detach().numpy())
    assert np.array_equal(got["gx"], x.grad.numpy())
    assert got["placements"] == ["S(0)", "S(2)"] and got["forward"] == []


# ---------------------------------------------------------------------------
# the dry run's count; the paths' calls as chip_smoke counts them
# ---------------------------------------------------------------------------

def test_each_launch_counts_its_inputs_and_outputs_once():
    """On meta tensors: x and both tables read, the output written; the
    plain version's float32 halves are not the kernel's."""
    B, S, H, hd = 2, 64, 8, 128
    x = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="meta")
    cos, sin = (torch.empty(B, S, hd // 2, device="meta") for _ in range(2))
    with torch.no_grad():
        got = dryrun.count_step(lambda: kernel.rotary(x, cos, sin))
    assert got["bytes_accessed"] == 2 * (2 * B * S * H * hd) + 2 * (4 * B * S * hd // 2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-236b", "arctic-480b",
                                  "llava-next-34b"])
def test_a_train_step_and_a_served_step_call_b8_and_b9_as_chip_smoke_counts(arch):
    """One smoke train step calls each of B8 and B9 forward and backward as
    often as ``chip_smoke.norm_rope_calls`` says a replay runs them, and a
    served decode step and prompt pass forward."""
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.launch.serve import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_train_step
    from repro_torch.training.train_lib import batch_to_device

    c = _chip_smoke()
    cfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="float32")
    norms, ropes = c.norm_rope_calls(cfg)
    model = init_params(cfg, seed=0, device="cpu")
    batch = batch_to_device(SyntheticLM(data_config_for(cfg, batch_size=2, seq_len=8)).batch(0),
                            "cpu")
    seen = []
    plain_watchers.append(_watch(seen))
    try:
        make_train_step(cfg, lr=1e-3)(model, adamw_init(dict(model.named_parameters())), batch)
        train = (seen.count("rms_norm_ref"), seen.count("rms_norm_bwd_ref"),
                 seen.count("rotary_ref"))
        del seen[:]
        engine = ServingEngine(cfg, model, max_slots=2, max_len=32, bucketing="pow2:8:8",
                               device="cpu")
        del seen[:]
        engine._decode(engine.params, engine.kv_cache, torch.zeros((2, 1), dtype=torch.long))
        decode = (seen.count("rms_norm_ref"), seen.count("rotary_ref"))
        del seen[:]
        exe = engine._get_prefill_exec(8)
        exe(engine.params, engine.kv_cache, torch.zeros((1, 8), dtype=torch.long), 0, 8)
        prefill = (seen.count("rms_norm_ref"), seen.count("rotary_ref"))
    finally:
        plain_watchers.pop()
    assert train == (norms, norms, 2 * ropes)
    assert decode == prefill == (norms, ropes)


def test_phase_3e_covers_the_paths_shapes():
    """3e holds B9 at 19c's q and k, 19h's q_rope and k_rope where they lie,
    zamba2's hd 80, a served decode at offsets, float32, an odd half and a
    base 16 bytes off, and times 19c's q and 19h's q_rope."""
    c = _chip_smoke()
    cases = {(B, S, H, hd, layout, dt) for _, B, S, H, hd, layout, dt, _ in c.ROPE_CASES}
    for must in ((2, 512, 24, 128, None, "bfloat16"), (2, 512, 8, 128, None, "bfloat16"),
                 (2, 4096, 128, 64, ("heads", 192, 128), "bfloat16"),
                 (2, 4096, 1, 64, ("rows", 576, 512), "bfloat16"),
                 (4, 512, 32, 80, None, "bfloat16"), (4, 1, 24, 128, None, "bfloat16"),
                 (2, 64, 8, 128, ("off", 8), "bfloat16")):
        assert must in cases
    assert any(dt == "float32" for *_, dt in cases) and any(hd // 2 % 4 for _, _, _, hd, *_ in
                                                            cases)
    assert {c.ROPE_CASES[i][1:5] for i in c.ROPE_TIMED} == {(2, 512, 24, 128), (2, 4096, 128, 64)}
    assert c.ROPE_THETA == TC.get("phi4-mini-3.8b").rope_theta
