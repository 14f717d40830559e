"""The port's flash attention against the JAX package's, on the CPU.

The port's plain version (what ``mha_flash`` runs on CPU tensors) is held
against the Pallas kernel in interpret mode and against the JAX oracle,
mirroring ``test_kernels.py``; the CUDA kernel itself is checked on the
card by ``chip_smoke.py``.  Tolerances as in ``test_kernels.py``: float32
2e-5 (summation order), bfloat16 3e-2 (bf16 rounding of the output).
What surrounds the kernel is plain Python and is checked here: the launch
chooser (tile, grid, shared memory, TMA boxes) on every shape of phase 3
of ``chip_smoke.py`` and every prefill bucket, the strides ``mha_flash``
passes for the layouts the model makes, which layouts take a counted
copy, and the wrapper's refusals.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    kernel,
    mha_flash,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The same values as JAX arrays and as CPU torch tensors of ``dtype``."""
    return ([jnp.asarray(a, dtype=dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check(seed, shapes, dtype="float32", jax_kernel=True, **kw):
    (jq, jk, jv), (tq, tk, tv) = _pair(_data(seed, *shapes), dtype)
    got = flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jax_flash_ref(jq, jk, jv, **kw), TOL[dtype])
    if jax_kernel:
        want = jax_flash(jq, jk, jv, interpret=True, block_q=64, block_kv=64, **kw)
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("seq", [64, 128])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_shapes(seq, hd, dtype):
    _check(0, [(4, seq, hd)] * 3, dtype)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_gqa_groups(group):
    _check(1, [(2 * group, 128, 32), (2, 128, 32), (2, 128, 32)], group=group)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_sliding_window(window):
    _check(2, [(2, 256, 32)] * 3, window=window)


@pytest.mark.parametrize("cap", [20.0, 50.0])
def test_softcap(cap):
    _check(3, [(2, 128, 32)] * 3, softcap=cap)


def test_bidirectional():
    _check(4, [(2, 128, 32)] * 3, causal=False)


def test_cross_lengths():
    _check(5, [(2, 64, 32), (2, 256, 32), (2, 256, 32)], causal=False)


@pytest.mark.parametrize("kw", [dict(), dict(window=16, softcap=50.0, group=2)])
def test_ragged_length(kw):
    """200 divides no TPU block; the port takes any length (the JAX oracle
    is the reference, the Pallas kernel refuses it)."""
    g = kw.get("group", 1)
    _check(6, [(2 * g, 200, 64), (2, 200, 64), (2, 200, 64)], jax_kernel=False, **kw)


def test_fully_masked_row_is_zero_like_the_kernel():
    """Row 100 sees no key (window 16 ends at 84 > Skv 64): the TPU kernel
    gives 0, the JAX oracle the mean of v.  The port follows the kernel."""
    kw = dict(causal=False, window=16)
    (jq, jk, jv), (tq, tk, tv) = _pair(_data(7, (2, 128, 32), (2, 64, 32), (2, 64, 32)),
                                       "float32")
    got = flash_attention_ref(tq, tk, tv, **kw)
    want = jax_flash(jq, jk, jv, interpret=True, block_q=64, block_kv=64, **kw)
    _close(got, want, TOL["float32"])
    assert float(got[:, 100].abs().max()) == 0.0
    assert float(jnp.abs(jax_flash_ref(jq, jk, jv, **kw)[:, 100]).max()) > 0.1


def test_mha_flash_matches_model_attention():
    """The model-layout wrapper against the port's plain attention in the
    model layout (decode attention's cache form over the S tokens, all
    valid) and JAX's ``_sdpa``."""
    from repro.models.layers import _sdpa as jax_sdpa
    from repro_torch.kernels.decode_attention import decode_attention_ref

    B, S, NH, NKV, hd = 2, 64, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _pair(
        _data(8, (B, S, NH, hd), (B, S, NKV, hd), (B, S, NKV, hd)), "float32")
    kw = dict(scale=1.0 / np.sqrt(hd), softcap_val=50.0, window=16, kv_valid=None)
    got = mha_flash(tq, tk, tv, softcap=50.0, window=16)
    plain = decode_attention_ref(tq, tk, tv, positions=torch.arange(S), kv_valid=torch.tensor(S),
                                 scale=kw["scale"], softcap=50.0, window=16)
    _close(got, plain, 3e-5)
    _close(got, jax_sdpa(jq, jk, jv, q_pos=jnp.arange(S), kv_pos=jnp.arange(S), **kw), 3e-5)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and never counts
    a launch; the kernel's own wrapper refuses CPU tensors."""
    q, k, v = (torch.randn(1, 16, 4, 32) for _ in range(3))
    before = kernel.launches
    mha_flash(q, k, v)
    assert kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*(torch.randn(2, 16, 32) for _ in range(3)))


def test_build_command_targets_hopper():
    out = build.library_path(kernel.SOURCE)
    argv = build.nvcc_argv("nvcc", kernel.SOURCE, out)
    assert "arch=compute_90a,code=sm_90a" in argv
    assert "-shared" in argv and "-O3" in argv
    assert out.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    gitignore = (build.BUILD_DIR.parents[1] / ".gitignore").read_text().split()
    assert "build/" in gitignore


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load(kernel.SOURCE)
    assert not (tmp_path / "build").exists()


def _chip_smoke():
    """The repo's chip_smoke.py as a module (its top level imports only the
    standard library)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
# (B, NH, Sq, Skv, hd, dtype) -> rows, keys, consumer warpgroups, threads,
# grid, shared memory, TMA boxes (columns, rows) of q and k/v: phi4-mini's
# prefill buckets and S=2048 (phase 3's timed shapes), other head dims, and
# the float32 kernel
CHOOSER_TABLE = {
    (1, 24, 64, 64, 128, "bfloat16"): (64, 64, 1, 160, (24, 1), 114768, (64, 64), (64, 64)),
    (1, 24, 128, 128, 128, "bfloat16"): (64, 64, 2, 288, (24, 2), 149584, (64, 64), (64, 64)),
    (1, 24, 256, 256, 128, "bfloat16"): (64, 64, 2, 288, (24, 4), 149584, (64, 64), (64, 64)),
    (1, 24, 512, 512, 128, "bfloat16"): (64, 64, 1, 160, (24, 8), 114768, (64, 64), (64, 64)),
    (1, 24, 2048, 2048, 128, "bfloat16"): (64, 64, 1, 160, (24, 32), 114768, (64, 64), (64, 64)),
    (1, 24, 2048, 2048, 32, "bfloat16"): (64, 64, 1, 160, (24, 32), 28752, (32, 64), (32, 64)),
    (2, 4, 200, 200, 64, "bfloat16"): (64, 64, 2, 288, (8, 4), 75856, (64, 64), (64, 64)),
    (1, 24, 512, 512, 128, "float32"): (64, 64, 0, 256, (24, 8), 115712, None, None),
}
# an H100's limits: shared memory of an SM (228 KB, 1 KB of it reserved per
# CTA) and of one CTA, and the rows or columns of one TMA box
SM_SMEM, MAX_SMEM, TMA_MAX_BOX = 233472, 232448, 256


@pytest.mark.parametrize("shape", sorted(CHOOSER_TABLE, key=str), ids=str)
def test_chooser_table(shape):
    launch = kernel.choose_launch(*shape)
    want = CHOOSER_TABLE[shape]
    assert (launch.rows, launch.keys, launch.warpgroups, launch.threads, launch.grid,
            launch.smem_bytes, launch.q_box, launch.kv_box) == want
    assert launch.instance in kernel.INSTANCES


def _check_launch(launch, B, NH, Sq):
    assert launch.instance in kernel.INSTANCES
    assert launch.grid == (B * NH, -(-Sq // launch.rows))
    assert launch.smem_bytes <= MAX_SMEM
    if launch.dtype == "bfloat16":
        # a 64-row query tile, one or two consumer warpgroups and a producer
        # warp, each box within the TMA's limits and one swizzle row (128
        # bytes; 64 for hd 32) wide
        assert launch.rows == 64 and launch.threads == 128 * launch.warpgroups + 32
        for cols, rows in (launch.q_box, launch.kv_box):
            assert rows <= TMA_MAX_BOX and 2 * cols in (64, 128)
            assert cols == min(launch.head_dim, 64)
        assert launch.q_box[1] == launch.rows and launch.kv_box[1] == launch.keys
        if launch.warpgroups == 1:       # two CTAs to an SM
            assert 2 * (launch.smem_bytes + 1024) <= SM_SMEM
    assert launch.smem_bytes == (
        kernel.smem_bytes(launch.head_dim, launch.warpgroups, launch.keys)
        if launch.dtype == "bfloat16" else kernel.f32_smem_bytes(launch.head_dim))


@pytest.mark.parametrize("S", SMOKE.TIMED_LENGTHS)
def test_chooser_on_prefill_shapes(S):
    """phi4-mini's prefill attention (24 q heads, hd 128, bf16): buckets 128
    and 256 fit the card in one wave and split each CTA's K/V tiles over two
    warpgroups; bucket 64 has one K/V tile, 512 and 2048 fill the card."""
    launch = kernel.choose_launch(1, 24, S, S, 128, "bfloat16")
    _check_launch(launch, 1, 24, S)
    assert launch.warpgroups == (2 if S in (128, 256) else 1)


def test_phase3_launches_every_kernel():
    """Phase 3 of chip_smoke.py fails unless every kernel of the library
    ran; its cases must reach each of kernel.INSTANCES."""
    reached = {}
    for dname, hd, kv_heads, group, Sq, Skv, window, cap, causal in SMOKE.flash_cases():
        launch = kernel.choose_launch(1, kv_heads * group, Sq, Skv, hd, dname)
        _check_launch(launch, 1, kv_heads * group, Sq)
        reached[launch.instance] = reached.get(launch.instance, 0) + 1
    assert set(reached) == set(kernel.INSTANCES)
    assert len(SMOKE.flash_cases()) == 180          # 172 of 2 kv heads, eight of 24 heads


@pytest.mark.parametrize("case", SMOKE.family_cases() + SMOKE.long_prompt_cases(), ids=str)
def test_phase3_covers_the_families_shapes(case):
    """Phase 3 also holds B1 at the shapes of the family paths (phases
    11-14), at their own batch: llava's prefill buckets and S = 2944 at GQA
    7, seamless's bidirectional encoder, cross attention with Sq != Skv and
    Sq = 1, zamba2's hd 80; and at phase 20's prefill_32k (phi4, S =
    32768, bf16); each takes a kernel of the library within the card's
    limits."""
    dname, B, hd, kv_heads, group, Sq, Skv, causal = case
    launch = kernel.choose_launch(B, kv_heads * group, Sq, Skv, hd, dname)
    _check_launch(launch, B, kv_heads * group, Sq)


def test_family_cases_take_the_paths_tiles():
    """At the paths' batch of 4, seamless's decoder prompt (16 heads, S 512)
    fills the card and takes the single-warpgroup tile, where at batch 1 it
    would split: phase 3 must check the tile the path runs."""
    cases = {(B, Sq, Skv, hd): kernel.choose_tile(B, kv * group, Sq, Skv)
             for d, B, hd, kv, group, Sq, Skv, causal in SMOKE.family_cases()}
    assert cases[(4, 512, 512, 64)] == kernel.TILES[0]
    assert kernel.choose_tile(1, 16, 512, 512) == kernel.TILES[1]
    assert {(1, 128, 128, 128), (1, 512, 512, 128), (1, 2944, 2944, 128),
            (4, 128, 128, 64), (4, 512, 128, 64), (4, 1, 128, 64),
            (4, 512, 512, 80)} <= set(cases)


def _drive_family_path(arch, B, S, prompt, buckets):
    """The entry-point calls of chip_smoke.py's phase for ``arch`` (11-14),
    on the smoke config at float32 on the CPU: llava served on one request
    per bucket, then a forward of its vision embeddings and ``prompt``
    tokens; the others ``encode_memory`` (audio), a forward of B x S tokens
    and two batch-decode steps."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, encode_memory, forward, init_cache
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(C.get(arch, smoke=True), dtype="float32")
    params = serve.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        if cfg.family == "vlm":
            engine = ServingEngine(cfg, params, max_slots=2, max_len=4 * max(buckets),
                                   bucketing=tuple(buckets), device="cpu")
            reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, b - 1).astype(np.int64),
                            max_new_tokens=2) for i, b in enumerate(buckets)]
            serve.serve(engine, reqs)
            assert engine.stats.prefill_compiles == len(buckets)
            forward(params, {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, prompt))),
                             "vision_embeds": torch.from_numpy(rng.standard_normal(
                                 (1, cfg.vision_tokens, cfg.vision_dim), dtype=np.float32))}, cfg)
            return cfg
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
        T = S // cfg.audio_frames_ratio if cfg.family == "audio" else 0
        if T:
            batch["frames"] = torch.from_numpy(
                rng.standard_normal((B, T, cfg.audio_dim), dtype=np.float32))
            memory = encode_memory(params, batch["frames"], cfg)
        forward(params, batch, cfg)
        cache = init_cache(cfg, B, 8, memory_len=T, device="cpu")
        if T:
            cache["memory"].copy_(memory)
        tok = batch["tokens"][:, :1]
        for _ in range(2):
            decode_step(params, cache, tok, cfg)
    return cfg


@pytest.mark.parametrize("arch", SMOKE.FAMILY_ARCHS + ("xlstm-125m", SMOKE.LONG_ARCH))
def test_path_attention_shapes_are_the_paths(arch, monkeypatch):
    """chip_smoke.path_attention_shapes, from which phase 3 takes the
    family cases and the long prompt, lists exactly the flash attention
    calls the path makes: each call of ``mha_flash`` is recorded while the
    smoke config runs the phase's entry points on the CPU (phases 11-14
    and 20 check the same on the card, with the full configs, against
    phase 3's cases)."""
    from repro_torch.models import layers

    seen, inner = set(), layers.mha_flash

    def recording(q, k, v, **kw):
        seen.add((q.shape[0], q.shape[2], k.shape[2], q.shape[1], k.shape[1], q.shape[3],
                  kw["causal"]))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(layers, "mha_flash", recording)
    B, S, prompt, buckets = 2, 16, 4, (16, 32)
    cfg = _drive_family_path(arch, B, S, prompt, buckets)
    want = {shape[1:] for shape in SMOKE.path_attention_shapes(cfg, B, S, prompt, buckets)}
    assert seen == want


def test_head_dim_80_runs_the_padded_tile():
    """hd 80's bf16 tiles are 128 wide (shared memory as hd 128), loaded in
    two 64-column boxes; the TMA fills columns 80-127 with zeros."""
    for S in (64, 512, 2048):
        l80 = kernel.choose_launch(4, 32, S, S, 80, "bfloat16")
        l128 = kernel.choose_launch(4, 32, S, S, 128, "bfloat16")
        assert (l80.smem_bytes, l80.warpgroups, l80.q_box) == \
            (l128.smem_bytes, l128.warpgroups, l128.q_box)
        assert l80.q_box == (64, 64) and l80.instance[1] == 80
    assert kernel.padded_head_dim(80) == 128 and kernel.padded_head_dim(64) == 64
    assert kernel.f32_smem_bytes(80) == 4 * (64 * 81 + 2 * 64 * 81 + 64 * 65)


def _layer_inputs(monkeypatch, dtype, B=2, S=24):
    """The q, k, v that the port's ``layers.attention`` hands to
    ``mha_flash`` (phi4-mini smoke config)."""
    import dataclasses

    import repro_torch.configs as TC
    import repro_torch.models.layers as TL
    import repro_torch.models.transformer as TT

    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype=dtype)
    model = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return mha_flash(q, k, v, **kw)

    monkeypatch.setattr(TL, "mha_flash", spy)
    with torch.no_grad():
        TT.prefill(model, torch.zeros((B, S), dtype=torch.long), cfg)
    assert len(seen) == cfg.n_layers
    return cfg, seen


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_layouts_take_no_copy(monkeypatch, dtype):
    """The layouts ``layers.attention`` produces are read in place, with the
    (batch, sequence, head) strides of a contiguous (B, S, H, hd)."""
    cfg, seen = _layer_inputs(monkeypatch, dtype)
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    for q, k, v in seen:
        o = torch.empty(q.shape, dtype=q.dtype)
        assert all(kernel.readable(t) for t in (q, k, v))
        before = kernel.layout_copies
        assert all(a is b for a, b in zip(kernel.prepare(q, k, v), (q, k, v)))
        assert kernel.layout_copies == before
        S = q.shape[1]
        assert kernel.stride_args(q, k, v, o) == [
            S * nh * hd, nh * hd, hd, S * nkv * hd, nkv * hd, hd,
            S * nkv * hd, nkv * hd, hd, S * nh * hd, nh * hd, hd]


def _views(t, kind):
    """Views of ``t``'s values (B, S, H, hd) in other storage layouts."""
    B, S, H, hd = t.shape
    if kind == "contiguous":
        return t
    if kind == "head_slice":             # heads 4..4+H of a wider tensor
        return torch.cat([t[:, :, :4], t, t[:, :, :4]], dim=2)[:, :, 4:4 + H]
    if kind == "bhsd_storage":           # (B, H, S, hd) storage, transposed view
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    row = H * hd + 4                     # sequence stride 4 elements past packed
    store = torch.zeros(B * S * row, dtype=t.dtype)
    view = store.as_strided(t.shape, (S * row, row, hd, 1))
    view.copy_(t)
    return view


@pytest.mark.parametrize("kind,copies", [("contiguous", 0), ("head_slice", 0),
                                         ("bhsd_storage", 0), ("misaligned_rows", 1)])
def test_layout_copies_are_counted(kind, copies):
    """A bf16 sequence stride 8 bytes off 16 bytes cannot go into a tensor
    map: exactly one counted copy, into a fresh contiguous tensor; the
    float32 kernel reads element-wise and copies nothing."""
    (q,) = (torch.from_numpy(a) for a in _data(9, (2, 16, 6, 64)))
    for dtype, want in ((torch.bfloat16, copies), (torch.float32, 0)):
        t = _views(q.to(dtype), kind)
        before = kernel.layout_copies
        (got,) = kernel.prepare(t)
        assert kernel.layout_copies - before == want
        assert torch.equal(got, t) and (got is t) == (want == 0)
        if want:
            assert got.is_contiguous() and kernel.readable(got)
    # a base pointer one bf16 element off 16 bytes: one copy as well
    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    before = kernel.layout_copies
    kernel.prepare(off)
    assert kernel.layout_copies - before == 1


def test_size_one_dims_get_a_legal_stride():
    """A dimension of length 1 is never stepped along; its stride goes to
    the library as hd whatever the view says.  The flat (BH, S, hd) layout
    is B = 1 with BH heads."""
    t = torch.zeros(1, 8, 3, 32).as_strided((1, 8, 3, 32), (7, 96, 32, 1))
    assert kernel.stride_args(t) == [32, 96, 32]
    assert kernel.readable(t.bfloat16())
    flat = torch.zeros(6, 10, 64)
    assert kernel.stride_args(flat) == [64, 64, 640]
    assert kernel.launch_for(flat, flat[:2], flat[:2]).grid == (6, 1)


def _qkv4(dtype=torch.bfloat16, hd=64, group=2):
    return [torch.zeros(s, dtype=dtype) for s in ((1, 8, 2 * group, hd), (1, 8, 2, hd),
                                                  (1, 8, 2, hd))]


@pytest.mark.parametrize("case,match", [
    ("float16", "float32 or all bfloat16"), ("mixed", "float32 or all bfloat16"),
    ("hd96", "head_dim 96"), ("group", "kv heads"), ("kv_shape", "differ"),
    ("batch", "batch"), ("dims", "4-d"), ("cpu", "CUDA"), ("empty", "empty"),
])
def test_wrapper_refuses(case, match):
    q, k, v = _qkv4()
    group = 2
    if case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed":
        k = k.float()
    elif case == "hd96":
        q, k, v = (t.new_zeros(t.shape[:-1] + (96,)) for t in (q, k, v))
    elif case == "group":
        group = 3
    elif case == "kv_shape":
        v = v[:, :4]
    elif case == "batch":
        k, v = (torch.cat([t, t]) for t in (k, v))
    elif case == "dims":
        q = q[0]
    elif case == "empty":
        q, k, v = (t[:, :0] for t in (q, k, v))
    with pytest.raises(ValueError, match=match):
        kernel.attention(q, k, v, group=group)


@pytest.mark.parametrize("args,match", [
    ((1, 24, 512, 512, 96, "bfloat16"), "head_dim"),
    ((1, 24, 512, 512, 128, "float16"), "float16"),
    ((1, 24, 64 * 65536 + 1, 64, 128, "float32"), "launch grid"),
])
def test_chooser_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        kernel.choose_launch(*args)


@pytest.mark.parametrize("kind", ["contiguous", "head_slice", "bhsd_storage",
                                  "misaligned_rows"])
def test_mha_flash_on_strided_views(kind):
    """``mha_flash`` on views of other storage layouts against the JAX
    package's ``_sdpa`` (float32, 3e-5: summation order)."""
    from repro.models.layers import _sdpa as jax_sdpa

    B, S, NH, NKV, hd = 2, 48, 6, 2, 32
    arrays = _data(10, (B, S, NH, hd), (B, S, NKV, hd), (B, S, NKV, hd))
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, "float32")
    got = mha_flash(_views(tq, kind), _views(tk, kind), _views(tv, kind), window=20)
    kw = dict(scale=1.0 / np.sqrt(hd), softcap_val=0.0, window=20, kv_valid=None)
    _close(got, jax_sdpa(jq, jk, jv, q_pos=jnp.arange(S), kv_pos=jnp.arange(S), **kw), 3e-5)
