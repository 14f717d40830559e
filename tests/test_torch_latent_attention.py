"""Latent attention (B6) on the CPU: its plain version against the JAX
package's absorbed MLA expression, the wrapper's routing and checks, its
launch plan at every shape ``chip_smoke.py`` phase 3c runs, the library call
through a fake library, and the model paths that reach it.

The same numpy-seeded inputs go through both packages: JAX's absorbed form
after the W_uk fold (``src/repro/models/mla.py:114-127``), evaluated with
jnp.  float32 within 1e-5 abs and rel (``test_torch_mla.py``'s tolerance:
summation order between two libraries); bf16 within atol 1e-2 + rtol 1e-2
(both round the probabilities to bf16 before the product with ckv and the
output to bf16: one bf16 ulp is 2**-8 relative).  The CUDA kernel itself
runs only on the card (phase 3c holds it against this plain version there).
"""

import dataclasses
import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.mla as TMLA  # noqa: E402
from repro_torch.kernels import KERNEL_MODULES, plain_watchers  # noqa: E402
from repro_torch.kernels.latent_attention import (kernel, latent_attention,  # noqa: E402
                                                  latent_attention_ref)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# (N, R, Rr): the deepseek-v2 smoke config's widths and a wider set with
# DeepSeek-V2's latent and rope widths
WIDTHS = {"smoke": (4, 32, 16), "wide": (8, 512, 64)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, widths, S, T, *, prompt=False):
    """q_lat (B,S,N,R), q_rope (B,S,N,Rr), ckv (B,T,R), krope (B,T,Rr),
    positions (B,S) and kv_len (B,) as numpy.  A decode step's slots sit at
    offsets 0, T - S (the cache full after the write) and 7, kv_len = pos +
    S; the prompt pass is one slot at positions 0..S-1 over its own S
    latents."""
    N, R, Rr = WIDTHS[widths]
    rng = np.random.default_rng(seed)
    B = 1 if prompt else 3

    def randn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    pos = np.array([0]) if prompt else np.array([0, T - S, 7])
    positions = pos[:, None] + np.arange(S)[None, :]
    kv_len = pos + S
    return [randn(B, S, N, R), randn(B, S, N, Rr), randn(B, T, R), randn(B, T, Rr),
            positions.astype(np.int64), kv_len.astype(np.int64)]


def _scale(widths):
    return 1.0 / np.sqrt(WIDTHS[widths][2] + 128)


def _torch(arrs, dtype):
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(dt) for a in arrs[:4]] + [torch.from_numpy(a)
                                                             for a in arrs[4:]]


def _jax_ref(arrs, dtype, scale):
    """JAX's absorbed attention after the W_uk fold, as ``src/repro/models/
    mla.py:114-127`` writes it (``idx + S`` is kv_len there)."""
    dt = getattr(jnp, dtype)
    q_lat, q_rope, ckv, krope = (jnp.asarray(a).astype(dt) for a in arrs[:4])
    positions = jnp.asarray(arrs[4], jnp.int32)
    kv_len = jnp.broadcast_to(jnp.asarray(arrs[5], jnp.int32), (q_lat.shape[0],))
    logits = (
        jnp.einsum("bsnr,btr->bnst", q_lat.astype(jnp.float32), ckv.astype(jnp.float32))
        + jnp.einsum("bsnh,bth->bnst", q_rope.astype(jnp.float32), krope.astype(jnp.float32))
    ) * scale
    t = jnp.arange(ckv.shape[1])
    positions = jnp.broadcast_to(positions, q_lat.shape[:2])
    mask = ((t[None, None, :] <= positions[..., None])
            & (t[None, None, :] < kv_len[:, None, None]))[:, None]
    logits = jnp.where(mask, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1).astype(dt)
    return np.asarray(jnp.einsum("bnst,btr->bsnr", probs, ckv).astype(jnp.float32))


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_plain_version_matches_jax_at_mixed_offsets(widths, S):
    arrs = _inputs(10 + S, widths, S, 96 if widths == "wide" else 32)
    got = latent_attention(*_torch(arrs, "float32"), scale=_scale(widths))
    assert got.shape == arrs[0].shape and got.dtype == torch.float32
    _close(got, _jax_ref(arrs, "float32", _scale(widths)), "float32")


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_prompt_pass_matches_jax(widths):
    """The engine's prompt pass: positions 0..S-1 over the prompt's own
    latents, causal."""
    arrs = _inputs(20, widths, 24, 24, prompt=True)
    got = latent_attention(*_torch(arrs, "float32"), scale=_scale(widths))
    _close(got, _jax_ref(arrs, "float32", _scale(widths)), "float32")


@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("prompt", [False, True], ids=["decode", "prompt"])
def test_bf16_matches_jax(widths, prompt):
    arrs = _inputs(30, widths, 16 if prompt else 1, 16 if prompt else 64, prompt=prompt)
    got = latent_attention(*_torch(arrs, "bfloat16"), scale=_scale(widths))
    assert got.dtype == torch.bfloat16
    _close(got, _jax_ref(arrs, "bfloat16", _scale(widths)), "bfloat16")


@pytest.mark.parametrize("S", [1, 3])
def test_zero_d_offset_is_the_offset_of_every_row(S):
    """The synchronized step's 0-d offset (and one row of positions) gives
    what JAX gives for it broadcast over the slots, and the bits of the same
    offset per slot."""
    arrs = _inputs(40, "wide", S, 64)
    off = 50
    arrs[4] = np.broadcast_to(off + np.arange(S), (3, S)).astype(np.int64)
    arrs[5] = np.full((3,), off + S, np.int64)
    q_lat, q_rope, ckv, krope, positions, kv_len = _torch(arrs, "float32")
    got = latent_attention(q_lat, q_rope, ckv, krope, positions[0], torch.tensor(off + S),
                           scale=0.1)
    per_row = latent_attention(q_lat, q_rope, ckv, krope, positions, kv_len, scale=0.1)
    assert torch.equal(got, per_row)
    _close(got, _jax_ref(arrs, "float32", 0.1), "float32")


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_a_fully_masked_row_is_the_mean_of_the_latents(widths):
    """A query before every position: the softmax of equal -1e30 logits,
    JAX's mean of the latents over every position (B6 computes the same on
    the card, phase 3c)."""
    arrs = _inputs(50, widths, 1, 40)
    arrs[4] = arrs[4].copy()
    arrs[4][1] = -1
    got = latent_attention(*_torch(arrs, "float32"), scale=_scale(widths))
    _close(got, _jax_ref(arrs, "float32", _scale(widths)), "float32")
    mean = np.broadcast_to(arrs[2][1].mean(axis=0), got[1, 0].shape)
    np.testing.assert_allclose(got[1, 0].numpy(), mean, atol=1e-5)


def test_the_absorbed_core_is_the_plain_version_between_the_folds():
    """``models/mla.py``'s absorbed core: W_uk folded into the query, B6,
    then W_uv, as before B6 (the plain version is that body, moved)."""
    rng = np.random.default_rng(60)
    B, S, T, N, nope, R, Rr, V = 2, 2, 12, 4, 8, 32, 16, 8
    q_nope = torch.from_numpy(rng.standard_normal((B, S, N, nope), dtype=np.float32))
    q_rope = torch.from_numpy(rng.standard_normal((B, S, N, Rr), dtype=np.float32))
    ckv = torch.from_numpy(rng.standard_normal((B, T, R), dtype=np.float32))
    krope = torch.from_numpy(rng.standard_normal((B, T, Rr), dtype=np.float32))
    w_uk = torch.from_numpy(rng.standard_normal((R, N, nope), dtype=np.float32))
    w_uv = torch.from_numpy(rng.standard_normal((R, N, V), dtype=np.float32))
    positions, kv_len = torch.tensor([[3, 4], [9, 10]]), torch.tensor([5, 11])
    got = TMLA._absorbed_core(q_nope, q_rope, ckv, krope, w_uk, w_uv, positions, kv_len,
                              scale=0.2)
    q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, w_uk)
    ctx = latent_attention_ref(q_lat, q_rope, ckv, krope, positions, kv_len, scale=0.2)
    assert torch.equal(got, torch.einsum("bsnr,rnh->bsnh", ctx, w_uv))


# ---------------------------------------------------------------------------
# routing and checks
# ---------------------------------------------------------------------------

def _small(device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=dtype).to(device)

    return (randn(2, 1, 4, 32), randn(2, 1, 4, 16), randn(2, 8, 32), randn(2, 8, 16),
            torch.tensor([[3], [5]], device=device), torch.tensor([4, 6], device=device))


def test_cpu_and_meta_take_the_plain_version_through_run_plain():
    seen = []

    def watcher(fn, args, writes=()):
        seen.append(len(args))
        return fn(*args)

    before = kernel.launches
    plain_watchers.append(watcher)
    try:
        args = _small()
        out = latent_attention(*args, scale=0.2)
        ref = latent_attention_ref(*args, scale=0.2)
        margs = _small("meta", torch.bfloat16)
        meta = latent_attention(*margs, scale=0.2)
    finally:
        plain_watchers.remove(watcher)
    assert torch.equal(out, ref)
    assert meta.is_meta and meta.shape == margs[0].shape and meta.dtype == torch.bfloat16
    assert seen == [6, 6] and kernel.launches == before
    assert KERNEL_MODULES["latent_attention"] == kernel.__name__


def test_a_dtensor_raises_type_error():
    from repro_torch.launch import dryrun

    args = list(_small("meta"))
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        args[0] = DTensor.from_local(args[0], mesh, [Replicate(), Replicate()], run_check=False)
        with pytest.raises(TypeError, match="DTensor"):
            latent_attention(*args, scale=0.2)


def test_an_input_that_needs_a_gradient_is_refused():
    args = list(_small())
    args[2] = args[2].requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        latent_attention(*args, scale=0.2)
    with torch.no_grad():
        assert latent_attention(*args, scale=0.2).shape == args[0].shape


@pytest.mark.parametrize("index,bad,match", [
    (5, torch.tensor([[4], [6]]), "kv_len"),
    (5, torch.tensor([4.0, 6.0]), "kv_len"),
    (4, torch.tensor([3, 5, 6]), "positions"),
    (3, torch.zeros(2, 8, 8), "krope"),
    (2, torch.zeros(2, 8, 16), "ckv"),
    (1, torch.zeros(2, 1, 3, 16), "q_rope"),
    (2, torch.zeros(2, 8, 32, dtype=torch.float64), "dtype"),
])
def test_the_wrapper_refuses_bad_arguments(index, bad, match):
    args = list(_small())
    args[index] = bad
    with pytest.raises(ValueError, match=match):
        latent_attention(*args, scale=0.2)
    with pytest.raises(ValueError, match="scale"):
        latent_attention(*_small(), scale=float("nan"))


@pytest.mark.parametrize("R,Rr,dtype", [(520, 64, "bfloat16"), (24, 16, "float32"),
                                        (512, 80, "bfloat16"), (512, 8, "bfloat16"),
                                        (512, 64, "float16"), (32, 16, "float64")])
def test_choose_launch_refuses_what_the_library_lacks(R, Rr, dtype):
    with pytest.raises(ValueError, match="latent_attention"):
        kernel.choose_launch(4, 1, 128, 1024, R, Rr, dtype)


def test_the_wrapper_refuses_unsupported_widths_on_cpu_tensors():
    """The kernel's limits are checked before the routing: a CPU call at a
    width the kernel lacks is refused too, not computed by the plain
    version."""
    g = torch.Generator().manual_seed(1)
    q_lat, ckv = torch.randn((1, 1, 2, 40), generator=g), torch.randn((1, 4, 40), generator=g)
    q_rope, krope = torch.randn((1, 1, 2, 16), generator=g), torch.randn((1, 4, 16), generator=g)
    with pytest.raises(ValueError, match="multiples of 16"):
        latent_attention(q_lat, q_rope, ckv, krope, torch.tensor([[2]]), torch.tensor([3]),
                         scale=0.2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        latent_attention(*(t.half() for t in _small()[:4]), *_small()[4:], scale=0.2)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# (B, S, N, T, R, Rr, dtype) of every case chip_smoke.py phase 3c runs, and
# (grid, split, chunk, kernels a call) of its plan
PLANS = [
    ((4, 1, 128, 1024, 512, 64, "bfloat16"), ((2, 8, 4), 8, 128, 2)),
    ((4, 3, 128, 1024, 512, 64, "bfloat16"), ((6, 4, 4), 4, 256, 2)),
    ((1, 64, 128, 64, 512, 64, "bfloat16"), ((128, 1, 1), 1, 64, 1)),
    ((1, 128, 128, 128, 512, 64, "bfloat16"), ((256, 1, 1), 1, 128, 1)),
    ((1, 256, 128, 256, 512, 64, "bfloat16"), ((512, 1, 1), 1, 256, 1)),
    ((1, 512, 128, 512, 512, 64, "bfloat16"), ((1024, 1, 1), 1, 512, 1)),
    ((8, 1, 128, 32768, 512, 64, "bfloat16"), ((2, 8, 8), 8, 4096, 2)),
    ((4, 1, 4, 256, 32, 16, "float32"), ((1, 1, 4), 1, 256, 1)),
    ((1, 16, 4, 16, 32, 16, "float32"), ((4, 1, 1), 1, 16, 1)),
    ((1, 128, 4, 128, 32, 16, "float32"), ((32, 1, 1), 1, 128, 1)),
    ((4, 1, 4, 256, 32, 16, "bfloat16"), ((1, 2, 4), 2, 128, 2)),
    ((2, 1, 128, 256, 512, 64, "bfloat16"), ((2, 2, 2), 2, 128, 2)),
    ((2, 1, 128, 320, 512, 64, "bfloat16"), ((2, 3, 2), 3, 128, 2)),
    ((4, 1, 128, 1000, 512, 64, "bfloat16"), ((2, 8, 4), 8, 128, 2)),
    ((4, 1, 128, 96, 512, 64, "bfloat16"), ((2, 1, 4), 1, 128, 1)),
    ((1, 192, 128, 192, 512, 64, "bfloat16"), ((384, 1, 1), 1, 192, 1)),
]


@pytest.mark.parametrize("shape,plan", PLANS, ids=[str(p[0]) for p in PLANS])
def test_choose_launch_at_every_shape_phase_3c_runs(shape, plan):
    """One CTA a (row tile, chunk, batch row): row tiles of 64 (bf16) or 16
    (float32) rows cover S·N; the chunks cover [0, T) once, each starting
    inside it, whole 64-position tiles for bf16 and whole pairs of them
    with a split; shared memory within a CTA's 232448 bytes; the combine's
    kernel exactly where there is a split (``Launch.kernels``)."""
    B, S, N, T, R, Rr, dtype = shape
    launch = kernel.choose_launch(*shape)
    grid = launch.grid(B, S, N)
    assert (grid, launch.split, launch.chunk, launch.kernels) == plan
    rows = 64 if dtype == "bfloat16" else 16
    assert launch.rows == rows and grid[0] * rows >= S * N > (grid[0] - 1) * rows
    starts = [k * launch.chunk for k in range(launch.split)]
    assert all(s < T for s in starts) and launch.split * launch.chunk >= T
    if dtype == "bfloat16":
        assert launch.chunk % (kernel.TILE * (2 if launch.split > 1 else 1)) == 0
        assert grid[0] * launch.split * B <= kernel.SMS or launch.split == 1
    assert launch.smem_bytes == kernel.smem_bytes(dtype, R, Rr) <= 232448
    assert kernel.check_launch(launch, B, S, N, T, R, Rr) is launch


def test_shared_memory_and_stages_follow_the_widths():
    """DeepSeek's widths fill a CTA: the 64 x 576 Q tile and the two 64 x
    576 tile buffers of bf16 (72 KB each; each tile's P takes its rope box),
    the six rows of 64 floats the warpgroups exchange, three mbarriers a
    buffer, the limit; every width takes two buffers, none a third."""
    assert kernel.smem_bytes("bfloat16", 512, 64) == 3 * 9 * 64 * 128 + 6 * 64 * 4 + 6 * 8 + 16
    assert kernel.smem_bytes("bfloat16", 512, 64) == 222784 <= kernel.MAX_SMEM
    assert kernel.smem_bytes("bfloat16", 384, 64) == 3 * 7 * 64 * 128 + 1600
    assert kernel.choose_launch(1, 1, 64, 64, 384, 64, "bfloat16").smem_bytes == 173632
    assert kernel.choose_launch(1, 1, 64, 64, 256, 64, "bfloat16").smem_bytes == 3 * 5 * 8192 + 1600
    assert kernel.BUFFERS == 2 and kernel.THREADS == 256
    assert kernel.padded(32) == kernel.padded(128) == 128 and kernel.padded(400) == 512
    assert kernel.smem_bytes("float32", 512, 64) == 4 * (16 * 576 + 32 * 577 + 512 + 16) + 16


def _chip_smoke():
    """The repo's chip_smoke.py as a module (its top level imports only the
    standard library)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_plans_cover_every_case_phase_3c_runs():
    """``PLANS`` holds the shape of every case of ``chip_smoke.LATENT_CASES``,
    the edges of the bf16 schedule among them (and the masked row's)."""
    cases = {(B, S, N, T, R, Rr, d) for _, B, S, T, N, R, Rr, d, _, _ in
             _chip_smoke().LATENT_CASES}
    assert cases <= {shape for shape, _ in PLANS}


@pytest.mark.parametrize("tiles,pairs", [
    (1, [(0, None)]),
    (2, [(0, 1)]),
    (3, [(0, 1), (2, None)]),
    (8, [(0, 1), (2, 3), (4, 5), (6, 7)]),
], ids=["one tile", "one pair", "odd count", "four pairs"])
def test_tile_pairs_give_warpgroup_0_the_even_tiles_and_a_lone_last_tile(tiles, pairs):
    """Warpgroup 0 scores the first tile of each pair, warpgroup 1 the
    second; a chunk of one tile, or the last of an odd count, leaves
    warpgroup 1 no scores.  Every tile is scored once, in order."""
    got = kernel.tile_pairs(tiles)
    assert got == pairs
    assert [t for pair in got for t in pair if t is not None] == list(range(tiles))


def _cta_tiles(S, N, T):
    """The tiles each bf16 CTA of a prompt pass reads, in launch order:
    its rows' largest visible end (the last row's position + 1) in whole
    tiles."""
    launch = kernel.choose_launch(1, S, N, T, 512, 64, "bfloat16")
    row_tiles = launch.grid(1, S, N)[0]
    out = []
    for x in range(row_tiles):
        rt = kernel.row_tile(x, row_tiles)
        last = min(rt * 64 + 63, S * N - 1) // N
        out.append(-(-(last + 1) // kernel.TILE))
    return out


@pytest.mark.parametrize("S", [64, 192, 512], ids=lambda S: f"prompt {S}")
def test_a_prompt_starts_its_heaviest_row_tiles_first(S):
    """blockIdx.x runs over the row tiles from the last: the prompt's last
    tokens, which read the most tiles, launch first, and the tiles each CTA
    reads never grow along the launch order."""
    tiles = _cta_tiles(S, 128, S)
    assert tiles[0] == max(tiles) == -(-S // 64)
    assert all(a >= b for a, b in zip(tiles, tiles[1:]))
    assert [kernel.row_tile(x, 4) for x in range(4)] == [3, 2, 1, 0]


@pytest.mark.parametrize("shape", [
    *[(1, b, 128, b, 512, 64) for b in (64, 128, 256, 512)],
    (8, 1, 128, 32768, 512, 64),
], ids=["bucket 64", "bucket 128", "bucket 256", "bucket 512", "decode_32k"])
def test_each_bucket_and_decode_32k_fit_a_cta(shape):
    """Every prompt bucket's plan and decode_32k's share take the pair of
    buffers within a CTA's 232448 bytes (one CTA an SM), a prompt in one
    split, decode_32k in chunks of whole pairs over the card's SMs."""
    launch = kernel.choose_launch(*shape, "bfloat16")
    assert launch.smem_bytes == 222784 <= kernel.MAX_SMEM == 232448
    B, S, N, T = shape[:4]
    if S > 1:
        assert launch.split == 1 and launch.chunk == T
    else:
        assert launch.chunk % (2 * kernel.TILE) == 0
        assert B * launch.grid(B, S, N)[0] * launch.split <= kernel.SMS


def _served():
    return kernel.choose_launch(4, 1, 128, 1024, 512, 64, "bfloat16")


@pytest.mark.parametrize("change,match", [
    (lambda l: dict(dtype="float32"), "split of 8"),
    (lambda l: dict(split=300), "split of 300"),
    (lambda l: dict(split=70000), "launch limits"),
    (lambda l: dict(chunk=64), "cover it"),
    (lambda l: dict(chunk=96), "cover it"),
    (lambda l: dict(chunk=1024), "cover it"),
    (lambda l: dict(split=0), "split of 0"),
    (lambda l: dict(smem_bytes=l.smem_bytes - 16), "shared memory"),
    (lambda l: dict(smem_bytes=l.smem_bytes + 1), "shared memory"),
    (lambda l: dict(split=5, chunk=192), "cover it"),
])
def test_check_launch_refuses_past_the_limits(change, match):
    launch = _served()
    with pytest.raises(ValueError, match=match):
        kernel.check_launch(dataclasses.replace(launch, **change(launch)), 4, 1, 128, 1024,
                            512, 64)


def test_float32_takes_no_split():
    launch = kernel.choose_launch(4, 1, 4, 256, 32, 16, "float32")
    with pytest.raises(ValueError, match="split of 2"):
        kernel.check_launch(dataclasses.replace(launch, split=2), 4, 1, 4, 256, 32, 16)


class _FakeLibrary:
    """Stands in for the built library: records each call's arguments and
    returns ``rc``, as ``latent_attention`` returns a CUDA error."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def latent_attention(self, *args):
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


# argument positions of the library call (csrc latent_attention)
ARG_PARTS, ARG_STRIDES, ARG_KVL_B, ARG_PLAN = slice(5, 7), 9, 12, slice(20, 24)


def test_the_plan_is_a_function_of_shapes_alone(fake_launch):
    """Calls that differ only in the offsets (and a 0-d offset against one
    per slot) pass the library the same plan: a captured graph stays valid
    as they advance, and the synchronized step runs the per-slot step's
    launch.  A split's partials are passed; one split passes none."""
    q_lat, q_rope, ckv, krope, positions, kv_len = _small(dtype=torch.bfloat16)
    latent_attention(q_lat, q_rope, ckv, krope, positions, kv_len, scale=0.2)
    latent_attention(q_lat, q_rope, ckv, krope, torch.tensor([[0], [7]]), torch.tensor([1, 8]),
                     scale=0.2)
    latent_attention(q_lat, q_rope, ckv, krope, torch.tensor([6]), torch.tensor(7), scale=0.2)
    plans = [args[ARG_PLAN] for args in fake_launch.calls]
    assert plans[0] == plans[1] == plans[2]
    assert [args[ARG_KVL_B] for args in fake_launch.calls] == [1, 1, 0]
    assert all(p is None for args in fake_launch.calls for p in args[ARG_PARTS])
    big = (torch.zeros((4, 1, 128, 512), dtype=torch.bfloat16),
           torch.zeros((4, 1, 128, 64), dtype=torch.bfloat16),
           torch.zeros((4, 1024, 512), dtype=torch.bfloat16),
           torch.zeros((4, 1024, 64), dtype=torch.bfloat16))
    out = latent_attention(*big, torch.zeros((4, 1), dtype=torch.long),
                           torch.ones(4, dtype=torch.long), scale=0.2)
    assert out.shape == big[0].shape and out.is_contiguous()
    args = fake_launch.calls[-1]
    assert all(p is not None for p in args[ARG_PARTS])
    assert args[ARG_PLAN] == (64, 8, 128, 222784)


def test_the_model_layouts_are_read_in_place(fake_launch):
    """One layer of the (L, B, T, R) latent cache, the einsum's permuted
    q_lat and a slice of the query for q_rope go to the library as they
    are, through their strides; a view whose rows are 4 bytes off 16 takes
    one counted copy."""
    cache = torch.zeros((3, 2, 8, 32), dtype=torch.bfloat16)
    rope = torch.zeros((3, 2, 8, 16), dtype=torch.bfloat16)
    q_lat = torch.zeros((4, 2, 1, 32), dtype=torch.bfloat16).permute(1, 2, 0, 3)
    q_rope = torch.zeros((2, 1, 4, 48), dtype=torch.bfloat16)[..., 32:]
    kw = dict(positions=torch.tensor([[3], [5]]), kv_len=torch.tensor([4, 6]), scale=0.2)
    before = kernel.layout_copies
    latent_attention(q_lat, q_rope, cache[1], rope[2], **kw)
    assert kernel.layout_copies == before
    args = fake_launch.calls[-1]
    assert args[0] == q_lat.data_ptr() and args[1] == q_rope.data_ptr()
    assert args[2] == cache[1].data_ptr() and args[3] == rope[2].data_ptr()
    assert list(args[ARG_STRIDES][:10]) == [32, 32, 2 * 32, 4 * 48, 4 * 48, 48, 8 * 32, 32,
                                            8 * 16, 16]
    store = torch.zeros(2 * 8 * 32 + 2, dtype=torch.bfloat16)
    off = store[2:].view(2, 8, 32)                   # 4 bytes past a 16-byte boundary
    latent_attention(q_lat, q_rope, off, rope[2], **kw)
    assert kernel.layout_copies == before + 1


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version was called for a kernel launch")

    monkeypatch.setattr(kernel, "latent_attention_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    before = kernel.launches
    with pytest.raises(RuntimeError, match="latent_attention launch failed: error 700"):
        latent_attention(*_small(), scale=0.2)
    assert kernel.launches == before and len(fake_launch.calls) == 1


# ---------------------------------------------------------------------------
# the model paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("synced", [False, True], ids=["per_slot", "synchronized"])
def test_every_served_step_reaches_the_wrapper_once_a_layer(synced, monkeypatch):
    """deepseek-v2 smoke: the prompt pass and each decode step (per slot,
    or synchronized on a 0-d offset, which the step broadcasts) call B6's
    wrapper once per layer, with the layer's view of the latent cache."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models import decode_step, init_cache, prefill

    cfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    model = init_params(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 2, 16, per_slot=not synced, device="cpu")
    calls = []
    inner = TMLA.latent_attention

    def counting(q_lat, q_rope, ckv, krope, positions, kv_len, **kw):
        calls.append((tuple(q_lat.shape), tuple(ckv.shape), ckv.untyped_storage().data_ptr()))
        return inner(q_lat, q_rope, ckv, krope, positions, kv_len, **kw)

    monkeypatch.setattr(TMLA, "latent_attention", counting)
    with torch.no_grad():
        prefill(model, torch.tensor([[1, 2, 3, 4, 5]]), cfg)
        assert [c[:2] for c in calls] == [((1, 5, 4, 32), (1, 5, 32))] * cfg.n_layers
        calls.clear()
        for _ in range(2):
            logits, cache = decode_step(model, cache, torch.tensor([[1], [2]]), cfg)
    assert len(calls) == 2 * cfg.n_layers
    assert {c[:2] for c in calls} == {((2, 1, 4, 32), (2, 16, 32))}
    assert {c[2] for c in calls} == {cache["ckv"].untyped_storage().data_ptr()}
    assert bool(torch.isfinite(logits).all())
