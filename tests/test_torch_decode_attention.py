"""Decode attention (B3) on the CPU: its plain version against the JAX
package's ``_sdpa_deferred`` and the cache form of ``_sdpa``, the wrapper's
routing and checks, its launch plan, the library call through a fake
library, and the model paths that reach it.

The same numpy-seeded inputs go through both packages.  float32 within
1e-5 (summation order between two libraries); bf16 within atol 1e-2 +
rtol 1e-2 (both round the probabilities to bf16 before the product with
v and the output to bf16: one bf16 ulp is 2**-8 relative).  The CUDA
kernel itself runs only on the card (``chip_smoke.py`` phase 3b holds it
against this plain version there).
"""

import dataclasses
import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.models.layers as JL  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.layers as TL  # noqa: E402
from repro_torch.kernels import plain_watchers  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention,  # noqa: E402
                                                  decode_attention_ref, kernel)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
B, T, NKV = 3, 16, 2


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, G, S, hd, *, new, dtype="float32", q_scale=1.0):
    """q (B,S,NH,hd), the cache (B,T,NKV,hd), the new part (B,S,NKV,hd) or
    None, positions (B,S) and kv_valid (B,) as numpy: the deferred form's
    offsets are 0, T and 7 (every cache entry, none, some); the cache
    form's ``pos`` 0, T - S and 5, its kv_valid ``pos + S``."""
    rng = np.random.default_rng(seed)
    NH = NKV * G

    def randn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    q = randn(B, S, NH, hd) * np.float32(q_scale)
    kc, vc = randn(B, T, NKV, hd), randn(B, T, NKV, hd)
    kn = vn = None
    if new:
        kn, vn = randn(B, S, NKV, hd), randn(B, S, NKV, hd)
        start = np.array([0, T, 7], np.int64)
        kv_valid = start
    else:
        start = np.array([0, T - S, 5], np.int64)
        kv_valid = start + S
    positions = start[:, None] + np.arange(S, dtype=np.int64)[None, :]
    return q, kc, vc, kn, vn, positions, kv_valid


def _torch(arrs, dtype):
    dt = getattr(torch, dtype)
    q, kc, vc, kn, vn, positions, kv_valid = arrs
    f = [None if a is None else torch.from_numpy(a).to(dt) for a in (q, kc, vc, kn, vn)]
    return (*f, torch.from_numpy(positions), torch.from_numpy(kv_valid))


def _jax(arrs, dtype):
    dt = getattr(jnp, dtype)
    q, kc, vc, kn, vn, positions, kv_valid = arrs
    f = [None if a is None else jnp.asarray(a).astype(dt) for a in (q, kc, vc, kn, vn)]
    return (*f, jnp.asarray(positions, jnp.int32), jnp.asarray(kv_valid, jnp.int32))


def _jax_ref(arrs, dtype, *, scale, softcap, window):
    """The JAX package's function: ``_sdpa_deferred`` with a new part, else
    the cache form of ``_sdpa`` (kv_pos = arange(T), q_pos the positions)."""
    q, kc, vc, kn, vn, positions, kv_valid = _jax(arrs, dtype)
    if kn is not None:
        out = JL._sdpa_deferred(q, kc, vc, kn, vn, scale=scale, softcap_val=softcap,
                                positions=positions, window=window, kv_valid=kv_valid)
    else:
        out = JL._sdpa(q, kc, vc, scale=scale, softcap_val=softcap, q_pos=positions,
                       kv_pos=jnp.arange(kc.shape[1]), window=window, kv_valid=kv_valid)
    return np.asarray(out.astype(jnp.float32))


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


def _run(arrs, dtype, **kw):
    q, kc, vc, kn, vn, positions, kv_valid = _torch(arrs, dtype)
    return decode_attention(q, kc, vc, kn, vn, positions=positions, kv_valid=kv_valid, **kw)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 3, 7])
@pytest.mark.parametrize("new", [True, False], ids=["deferred", "cache"])
def test_plain_version_matches_jax(new, G, hd, S):
    arrs = _inputs(G * 100 + hd + S, G, S, hd, new=new)
    scale = 1.0 / np.sqrt(hd)
    got = _run(arrs, "float32", scale=scale)
    _close(got, _jax_ref(arrs, "float32", scale=scale, softcap=0.0, window=None), "float32")


@pytest.mark.parametrize("window,cap", [(5, 0.0), (None, 50.0), (4, 30.0)])
@pytest.mark.parametrize("new", [True, False], ids=["deferred", "cache"])
def test_window_and_softcap_match_jax(new, window, cap):
    # q scaled up so that scores reach the cap's bend
    arrs = _inputs(11, 3, 3, 64, new=new, q_scale=8.0 if cap else 1.0)
    kw = dict(scale=0.125, softcap=cap, window=window)
    _close(_run(arrs, "float32", **kw), _jax_ref(arrs, "float32", **kw), "float32")


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("new", [True, False], ids=["deferred", "cache"])
def test_bf16_matches_jax(new, hd):
    arrs = _inputs(12, 7, 1, hd, new=new)
    kw = dict(scale=1.0 / np.sqrt(hd), softcap=0.0, window=None)
    got = _run(arrs, "bfloat16", **kw)
    assert got.dtype == torch.bfloat16
    _close(got, _jax_ref(arrs, "bfloat16", **kw), "bfloat16")


@pytest.mark.parametrize("new", [True, False], ids=["deferred", "cache"])
def test_zero_d_kv_valid_is_the_offset_of_every_row(new):
    """The synchronized step's 0-d offset gives what JAX gives for it
    broadcast over the rows, and the bits of the same offset per row."""
    S = 1
    arrs = list(_inputs(13, 3, S, 32, new=new))
    off = 9
    arrs[6] = np.full((B,), off + (0 if new else S), np.int64)
    arrs[5] = np.full((B, S), off, np.int64)
    q, kc, vc, kn, vn, positions, kv_valid = _torch(arrs, "float32")
    kw = dict(scale=0.25)
    got = decode_attention(q, kc, vc, kn, vn, positions=positions,
                           kv_valid=torch.tensor(int(kv_valid[0])), **kw)
    per_row = decode_attention(q, kc, vc, kn, vn, positions=positions, kv_valid=kv_valid, **kw)
    assert torch.equal(got, per_row)
    _close(got, _jax_ref(arrs, "float32", scale=0.25, softcap=0.0, window=None), "float32")


def test_a_fully_masked_row_is_the_mean_of_v():
    """A row that sees no key: the plain version gives JAX's result, the
    softmax of equal ``NEG_INF`` scores, the mean of v over every cache
    position.  The kernel writes 0 there instead (``csrc/decode_attention.cu``;
    ``chip_smoke.py`` phase 3b checks it): a difference kept on purpose, since
    no decode path makes such a row (a step's token always sees itself)."""
    arrs = list(_inputs(14, 2, 1, 32, new=False))
    arrs[5] = arrs[5].copy()
    arrs[5][0] = -1                                   # row 0 before every position
    got = _run(arrs, "float32", scale=0.2)
    want = _jax_ref(arrs, "float32", scale=0.2, softcap=0.0, window=None)
    _close(got, want, "float32")
    mean_v = np.repeat(arrs[2][0].mean(axis=0), 2, axis=0)          # (NH, hd)
    np.testing.assert_allclose(got[0, 0].numpy(), mean_v, atol=1e-5)


def test_layers_paths_match_jax():
    """``layers._decode_attention`` (the served decode's attention) runs
    B3's plain version here, as JAX's ``_sdpa_deferred`` computes it."""
    arrs = _inputs(15, 3, 2, 64, new=True)
    q, kc, vc, kn, vn, positions, kv_valid = _torch(arrs, "float32")
    got = TL._decode_attention(q, kc, vc, kn, vn, scale=0.125, softcap_val=0.0,
                               positions=positions, window=None, kv_valid=kv_valid)
    _close(got, _jax_ref(arrs, "float32", scale=0.125, softcap=0.0, window=None), "float32")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _small(device="cpu", dtype=torch.float32, new=True):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 6, 32), generator=g, dtype=dtype).to(device)
    kc, vc = (torch.randn((2, 8, 2, 32), generator=g, dtype=dtype).to(device) for _ in range(2))
    kn = vn = None
    if new:
        kn, vn = (torch.randn((2, 1, 2, 32), generator=g, dtype=dtype).to(device)
                  for _ in range(2))
    kv = dict(positions=torch.tensor([[3], [5]], device=device),
              kv_valid=torch.tensor([3, 5], device=device))
    return q, kc, vc, kn, vn, kv


def test_cpu_and_meta_take_the_plain_version_through_run_plain():
    seen = []

    def watcher(fn, args, writes=()):
        seen.append(len(args))
        return fn(*args)

    before = kernel.launches
    plain_watchers.append(watcher)
    try:
        q, kc, vc, kn, vn, kv = _small()
        out = decode_attention(q, kc, vc, kn, vn, **kv)
        ref = decode_attention_ref(q, kc, vc, kn, vn, scale=1 / np.sqrt(32), **kv)
        mq, mkc, mvc, mkn, mvn, mkv = _small("meta")
        meta = decode_attention(mq, mkc, mvc, mkn, mvn, **mkv)
    finally:
        plain_watchers.remove(watcher)
    assert torch.equal(out, ref)
    assert meta.is_meta and meta.shape == mq.shape and meta.dtype == mq.dtype
    assert seen == [7, 7] and kernel.launches == before


def test_a_dtensor_raises_type_error():
    from repro_torch.launch import dryrun

    q, kc, vc, kn, vn, kv = _small("meta")
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        dq = DTensor.from_local(q, mesh, [Replicate(), Replicate()], run_check=False)
        with pytest.raises(TypeError, match="DTensor"):
            decode_attention(dq, kc, vc, kn, vn, **kv)


def test_an_input_that_needs_a_gradient_is_refused():
    q, kc, vc, kn, vn, kv = _small()
    with pytest.raises(ValueError, match="no gradient"):
        decode_attention(q.requires_grad_(), kc, vc, kn, vn, **kv)
    with torch.no_grad():
        assert decode_attention(q, kc, vc, kn, vn, **kv).shape == q.shape


@pytest.mark.parametrize("bad,match", [
    (dict(kv_valid=torch.tensor([[3], [5]])), "kv_valid"),
    (dict(positions=torch.tensor([3, 5, 6])), "positions"),
    (dict(kv_valid=torch.tensor([3.0, 5.0])), "kv_valid"),
    (dict(window=0), "window"),
    (dict(softcap=-1.0), "softcap"),
    (dict(causal=False), "causal"),
])
def test_the_wrapper_refuses_bad_arguments(bad, match):
    q, kc, vc, kn, vn, kv = _small()
    with pytest.raises(ValueError, match=match):
        decode_attention(q, kc, vc, kn, vn, **{**kv, **bad})


def test_the_wrapper_refuses_bad_shapes():
    q, kc, vc, kn, vn, kv = _small()
    with pytest.raises(ValueError, match="k_new"):
        decode_attention(q, kc, vc, kn, None, **kv)
    with pytest.raises(ValueError, match="NKV dividing NH"):
        decode_attention(q[:, :, :5], kc, vc, None, None, **kv)
    with pytest.raises(ValueError, match="dtype"):
        decode_attention(q.double(), kc, vc, kn, vn, **kv)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# (B, T, NKV, G·S, hd, dtype, new) of the paths chip_smoke.py phase 3b checks
PLANS = [(4, 1024, 8, 3, 128, "bfloat16", True), (8, 32768, 8, 3, 128, "bfloat16", True),
         (4, 1024, 8, 7, 128, "bfloat16", True), (4, 64, 16, 1, 64, "bfloat16", False),
         (4, 64, 32, 1, 80, "bfloat16", False), (4, 1024, 2, 3, 32, "float32", True),
         (4, 1024, 4, 12, 128, "bfloat16", True), (2, 512, 8, 21, 128, "float32", False)]


@pytest.mark.parametrize("plan", PLANS)
def test_choose_launch_covers_the_cache_and_sizes_the_scratch(plan):
    """One cluster per (batch row, kv head, row tile) whose ranks cover
    ``[0, T)`` once, in order, each with some of it; the step's own keys on
    exactly one rank, the last; a cluster of at most 8 CTAs, a ring of 3 or
    4 stages, shared memory within a CTA's 232448 bytes; and no scratch in
    device memory (the parts are combined in the cluster's shared memory)."""
    B_, T_, NKV_, GS, hd, dtype, new = plan
    launch = kernel.choose_launch(*plan)
    if dtype == "bfloat16":
        assert launch.rows == kernel.MMA_ROWS == 16
    else:
        assert launch.rows in kernel.ROWS and ((launch.rows >= GS) or launch.rows == 16)
    assert launch.rows * launch.row_tiles >= GS > launch.rows * (launch.row_tiles - 1)
    assert launch.chunk % kernel.TILE == 0
    ranges = [(min(r * launch.chunk, T_), min((r + 1) * launch.chunk, T_))
              for r in range(launch.cluster)]
    assert launch.span == T_ and ranges[0][0] == 0 and ranges[-1][1] == T_
    assert all(a < b for a, b in ranges)
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    holders = [r for r in range(launch.cluster) if r == launch.new_rank]
    assert holders == ([launch.cluster - 1] if new else [])
    assert 1 <= launch.cluster <= kernel.MAX_CLUSTER == 8
    assert launch.stages in (3, 4)
    assert launch.grid == (launch.cluster, B_ * NKV_, launch.row_tiles)
    esize = 2 if dtype == "bfloat16" else 4
    assert launch.smem_bytes == kernel.smem_bytes(launch.rows, hd, esize, launch.stages) <= 232448
    assert not hasattr(launch, "scratch") and not hasattr(kernel, "COMBINE_SMEM")
    assert kernel.check_launch(launch, B_, T_, NKV_, new) is launch


def test_decode_32k_fills_its_waves():
    """decode_32k's share: 64 (row, kv head) pairs, CTAs of 98432 bytes (a
    3-stage ring of 32768-byte K/V stages, the mbarriers), two to an SM.
    Clusters of 2 ranks of 16384 positions: 128 CTAs, one wave (the card's
    GPCs hold 132 such clusters), at most one CTA an SM, since a rank
    streams 256 tiles and the bytes bound it.  Three ranks would also fit
    one wave (86 clusters) but put two CTAs on some SMs; four would not fit
    (62 resident of 64).  phi4-mini's served slots over 1024 positions
    stream short chunks, bound by latency: as many ranks as one wave holds,
    6 of 3 tiles (8 would need 32 clusters, 30 resident)."""
    launch = kernel.choose_launch(8, 32768, 8, 3, 128, "bfloat16", True)
    assert (launch.smem_bytes, launch.stages, launch.cluster, launch.chunk) == (98432, 3, 2,
                                                                                16384)
    assert kernel.stage_bytes(128, 2) == 32768 and kernel.per_sm(launch.smem_bytes) == 2
    assert [kernel.resident_clusters(c, 2) for c in (2, 3, 4, 6, 8)] == [132, 86, 62, 40, 30]
    assert launch.grid == (2, 64, 1) and launch.new_rank == 1
    served = kernel.choose_launch(4, 1024, 8, 3, 128, "bfloat16", True)
    assert (served.cluster, served.chunk, served.grid) == (6, 192, (6, 32, 1))


def test_a_window_splits_its_reach():
    """gemma2's local layer (window 4096) over 8192 positions: the ranks
    split the window's reach from its start, 4096 + G·S positions, not the
    cache; without the window the same shapes split all 8192."""
    local = kernel.choose_launch(4, 8192, 16, 2, 128, "bfloat16", True, 4096)
    whole = kernel.choose_launch(4, 8192, 16, 2, 128, "bfloat16", True)
    assert (local.span, local.cluster, local.chunk) == (4098, 2, 2112)
    assert (whole.span, whole.cluster, whole.chunk) == (8192, 2, 4096)
    assert kernel.choose_launch(4, 1024, 16, 2, 128, "bfloat16", True, 4096).span == 1024


@pytest.mark.parametrize("hd,dtype", [(16, "float32"), (96, "bfloat16"), (256, "bfloat16"),
                                      (128, "float16"), (64, "float64")])
def test_choose_launch_refuses_what_the_library_lacks(hd, dtype):
    with pytest.raises(ValueError, match="decode_attention"):
        kernel.choose_launch(2, 64, 2, 3, hd, dtype, True)


def _phi4_launch():
    return kernel.choose_launch(4, 1024, 8, 3, 128, "bfloat16", True)


@pytest.mark.parametrize("change,match", [
    (lambda l: dict(cluster=9, grid=(9, 32, 1)), "cluster of 9"),
    (lambda l: dict(cluster=0, grid=(0, 32, 1)), "cluster of 0"),
    (lambda l: dict(grid=(2 * l.cluster, 32, 1)), "not one cluster"),
    (lambda l: dict(grid=(l.cluster, 31, 1)), "does not cover"),
    (lambda l: dict(chunk=l.chunk // 2), "do not each cover"),
    (lambda l: dict(chunk=2 * l.chunk), "do not each cover"),
    (lambda l: dict(stages=2), "stages"),
    (lambda l: dict(stages=5), "stages"),
    (lambda l: dict(smem_bytes=l.smem_bytes + 1), "shared memory"),
    (lambda l: dict(new_rank=0), "own keys"),
])
def test_check_launch_refuses_past_the_limits(change, match):
    """The launch limits are checked in plain Python before any launch:
    cluster size, one whole cluster along the grid's x, the grid's cover,
    ranks that each hold part of the cache, the ring's depth, shared memory
    as laid out, and the step's own keys on the last rank."""
    launch = _phi4_launch()
    with pytest.raises(ValueError, match=match):
        kernel.check_launch(dataclasses.replace(launch, **change(launch)), 4, 1024, 8, True)


def test_choose_launch_refuses_a_grid_or_shared_memory_past_the_card(monkeypatch):
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        kernel.choose_launch(70000, 64, 1, 1, 64, "bfloat16", False)
    kernel.choose_launch.cache_clear()
    monkeypatch.setattr(kernel, "MAX_SMEM", 90000)
    try:
        with pytest.raises(ValueError, match="shared memory"):
            kernel.choose_launch(4, 1024, 8, 3, 128, "bfloat16", True)
    finally:
        kernel.choose_launch.cache_clear()


class _FakeLibrary:
    """Stands in for the built library: records each call's arguments and
    returns ``rc``, as ``decode_attention`` returns a CUDA error."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def decode_attention(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrapper on CPU tensors up to the library call: the routing takes
    the card's branch, the stream is stubbed, the library is a fake."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel, "takes_plain", lambda t: False)
    monkeypatch.setattr(kernel, "_kernel", lambda device: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


# argument positions of the library call (csrc decode_attention)
ARG_STRIDES, ARG_KVV_B, ARG_PLAN = 8, 11, slice(19, 24)


def test_the_plan_is_a_function_of_shapes_alone(fake_launch):
    """Two calls that differ only in the offsets and the positions (and a
    0-d offset against one per row) pass the library the same plan: a
    captured graph stays valid as they advance, and the synchronized step
    runs the per-slot step's launch."""
    q, kc, vc, kn, vn, kv = _small()
    decode_attention(q, kc, vc, kn, vn, **kv)
    decode_attention(q, kc, vc, kn, vn, positions=torch.tensor([[0], [8]]),
                     kv_valid=torch.tensor([0, 8]))
    decode_attention(q, kc, vc, kn, vn, positions=torch.tensor([6]), kv_valid=torch.tensor(6))
    plans = [(args[ARG_PLAN], args[-2]) for args in fake_launch.calls]
    assert plans[0] == plans[1] == plans[2]
    assert [args[ARG_KVV_B] for args in fake_launch.calls] == [1, 1, 0]


def test_the_model_cache_is_read_in_place(fake_launch):
    """One layer of the (L, B, T, NKV, hd) cache goes to the library as it
    is, through its strides; a view whose rows are 4 bytes off 16 takes
    one counted copy."""
    q, _, _, kn, vn, kv = _small(dtype=torch.bfloat16)
    cache = torch.zeros((3, 2, 8, 2, 32), dtype=torch.bfloat16)
    before = kernel.layout_copies
    decode_attention(q, cache[1], cache[2], kn, vn, **kv)
    assert kernel.layout_copies == before
    args = fake_launch.calls[-1]
    assert args[1] == cache[1].data_ptr() and args[2] == cache[2].data_ptr()
    assert list(args[ARG_STRIDES][3:6]) == [8 * 2 * 32, 2 * 32, 32]
    store = torch.zeros(2 * 8 * 2 * 32 + 2, dtype=torch.bfloat16)
    off = store[2:].view(2, 8, 2, 32)                # 4 bytes past a 16-byte boundary
    decode_attention(q, off, off, kn, vn, **kv)
    assert kernel.layout_copies == before + 2


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version was called for a kernel launch")

    monkeypatch.setattr(kernel, "decode_attention_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    before = kernel.launches
    q, kc, vc, kn, vn, kv = _small()
    with pytest.raises(RuntimeError, match="decode_attention launch failed: error 700"):
        decode_attention(q, kc, vc, kn, vn, **kv)
    assert kernel.launches == before and len(fake_launch.calls) == 1


# ---------------------------------------------------------------------------
# the model paths and the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "llava-next-34b", "arctic-480b",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_every_decoder_reaches_the_wrapper_once_a_layer(arch, monkeypatch):
    """dense, vlm, MoE (GQA), hybrid and audio: ``decode_step`` calls B3's
    wrapper once per attention layer per step."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models import decode_step, init_cache

    cfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="float32")
    model = init_params(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 2, 8, memory_len=4, device="cpu")
    calls = []
    inner = TL.decode_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)

    monkeypatch.setattr(TL, "decode_attention", counting)
    tok = torch.tensor([[1], [2]])
    with torch.no_grad():
        for _ in range(2):
            logits, cache = decode_step(model, cache, tok, cfg)
    per_step = (cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid"
                else cfg.n_layers)
    assert len(calls) == 2 * per_step > 0
    assert bool(torch.isfinite(logits).all())


def test_the_dry_run_counts_the_plain_version_as_one_launch():
    """On meta tensors the plain version upcasts the cache and holds every
    score; on the card B3 reads q, the cache, the new part, the positions
    and the offsets once and writes the output: the counter sees that one
    launch (and still the plain version's FLOPs)."""
    from repro_torch.launch import dryrun

    q, kc, vc, kn, vn, kv = _small("meta", torch.bfloat16)
    with torch.no_grad():
        got = dryrun.count_step(lambda: decode_attention(q, kc, vc, kn, vn, **kv))
    ins = sum(t.numel() * t.element_size() for t in (q, kc, vc, kn, vn, *kv.values()))
    out = q.numel() * q.element_size()
    assert got["bytes_accessed"] == ins + out
    assert got["output_bytes"] == out and got["temp_bytes"] == 0
    with torch.no_grad(), FlopCounterMode(display=False) as plain:
        decode_attention_ref(q, kc, vc, kn, vn, scale=0.25, **kv)
    assert got["flops_per_device"] == plain.get_total_flops() >= 4 * 2 * 6 * 1 * 8 * 32
