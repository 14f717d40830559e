"""Flash attention's gradient in the port against the JAX package's, on
the CPU.

The JAX package has no backward kernel: its training differentiates the
plain attention (``layers._sdpa``) through XLA.  So ``jax.vjp`` of
``_sdpa`` is the oracle of the port's plain backward,
``flash_attention_bwd_ref``, which runs the equations of the CUDA backward
kernel from (q, k, v, o, LSE, dO): causal, window, soft-cap, GQA 1/3/7,
``Sq != Skv`` bidirectional, head dims 32/64/80/128, float32, within 1e-5
(summation order).  ``FlashAttention``, the autograd Function that
``mha_flash`` takes when an input needs a gradient, is held against
``torch.autograd`` through the plain forward (a fully masked row has zero
gradients, as its output is 0).  The kernel itself runs on the card, in
``chip_smoke.py`` phase 19; what surrounds it is checked here: the launch
chooser at the training shapes of every family, the refusals, and that a
wrapper never detaches silently.  B2's gradient, ``StreamPack``, is held
against ``jax.grad`` of the JAX package's plain stream_pack.
"""

import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro.kernels.stream_pack import stream_pack_matmul_ref as jax_pack_ref  # noqa: E402
from repro.models.layers import _sdpa as jax_sdpa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    backward,
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    kernel,
    mha_flash,
)
from repro_torch.kernels.stream_pack import kernel as pack  # noqa: E402
from repro_torch.kernels.stream_pack import stream_pack  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(t):
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd)


def _model(t, like):
    B, S, H, hd = like.shape
    return t.reshape(B, H, S, hd).transpose(1, 2)


def _inputs(seed, B, Sq, Skv, NH, NKV, hd, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, NH, hd), dtype=np.float32) * q_scale
    k, v = (rng.standard_normal((B, Skv, NKV, hd), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((B, Sq, NH, hd), dtype=np.float32)
    return q, k, v, do


CASES = {
    "causal_hd32": dict(hd=32), "causal_hd64": dict(hd=64), "causal_hd80": dict(hd=80),
    "causal_hd128": dict(hd=128),
    "gqa3_window": dict(group=3, window=9), "gqa7": dict(group=7, NKV=1),
    "softcap": dict(softcap=10.0, q_scale=4.0), "softcap_window_gqa3": dict(
        group=3, softcap=10.0, q_scale=4.0, window=12),
    "bidirectional_sq_lt_skv": dict(causal=False, Sq=24, Skv=40),
    "bidirectional_sq_gt_skv_gqa3": dict(causal=False, Sq=40, Skv=17, group=3),
    "causal_sq_lt_skv": dict(Sq=24, Skv=40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case):
    kw = dict(hd=64, group=1, window=0, softcap=0.0, causal=True, Sq=33, Skv=33, NKV=2,
              q_scale=1.0)
    kw.update(CASES[case])
    hd, group, NKV, Sq, Skv = kw["hd"], kw["group"], kw["NKV"], kw["Sq"], kw["Skv"]
    q, k, v, do = _inputs(1, 2, Sq, Skv, NKV * group, NKV, hd, kw["q_scale"])
    scale = 1.0 / np.sqrt(hd)

    def f(q, k, v):
        return jax_sdpa(q, k, v, scale=scale, softcap_val=kw["softcap"],
                        q_pos=jnp.arange(Sq), kv_pos=jnp.arange(Skv),
                        window=kw["window"] or None, kv_valid=None, causal=kw["causal"])

    out, vjp = jax.vjp(f, q, k, v)
    want = vjp(jnp.asarray(do))
    fkw = dict(group=group, scale=scale, softcap=kw["softcap"], causal=kw["causal"],
               window=kw["window"])
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_lse_ref(_flat(tq), _flat(tk), _flat(tv), **fkw)
    np.testing.assert_allclose(_model(o, tq).numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    got = flash_attention_bwd_ref(_flat(tq), _flat(tk), _flat(tv), o, lse, _flat(tdo), **fkw)
    for g, w, like in zip(got, want, (tq, tk, tv)):
        np.testing.assert_allclose(_model(g, like).numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_lse_matches_jax_logsumexp():
    """The LSE is natural-log, of the scaled (and capped) unmasked scores."""
    q, k, v, _ = _inputs(2, 1, 20, 20, 2, 2, 32, q_scale=4.0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = flash_attention_lse_ref(_flat(tq), _flat(tk), _flat(tv), softcap=10.0, window=5)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32)
    s = jnp.tanh(s / 10.0) * 10.0
    i, j = jnp.arange(20)[:, None], jnp.arange(20)[None, :]
    s = jnp.where((j <= i) & (j > i - 5), s, -jnp.inf)
    want = jax.nn.logsumexp(s, axis=-1).reshape(2, 20)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [dict(), dict(softcap=20.0, window=6), dict(causal=False)])
@pytest.mark.parametrize("group", [1, 3])
def test_function_matches_autograd_of_the_plain_forward(kw, group):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 2, 30, 30, 2 * group, 2, 32, 4.0))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad(mha_flash(q, k, v, **kw), (q, k, v), do)
    plain = _model(flash_attention_ref(_flat(q), _flat(k), _flat(v), group=group, **kw), q)
    want = torch.autograd.grad(plain, (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


def test_function_on_the_flat_layout():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 1, 20, 20, 6, 2, 32))
    fq, fk, fv, fdo = (_flat(t).requires_grad_(True) for t in (q, k, v, do))
    o, lse = FlashAttention.apply(fq, fk, fv, 3, None, 0.0, True, 0)
    assert lse.shape == (6, 20) and not lse.requires_grad
    got = torch.autograd.grad(o, (fq, fk, fv), fdo)
    want = torch.autograd.grad(flash_attention_ref(fq, fk, fv, group=3), (fq, fk, fv), fdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


def test_fully_masked_rows_have_zero_gradients():
    """Window 8 over 16 keys for 40 queries, bidirectional: rows 23 on see
    no key; their output and their dq are 0, and they add nothing to dk,
    dv."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 1, 40, 16, 2, 2, 32))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = mha_flash(q, k, v, causal=False, window=8)
    assert float(out[:, 23:].abs().max()) == 0.0
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    assert float(dq[:, 23:].abs().max()) == 0.0
    do2 = do.clone()
    do2[:, 23:] = 0.0
    _, dk2, dv2 = torch.autograd.grad(mha_flash(q, k, v, causal=False, window=8), (q, k, v), do2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _, lse = flash_attention_lse_ref(_flat(q.detach()), _flat(k.detach()), _flat(v.detach()),
                                     causal=False, window=8)
    assert torch.isinf(lse[:, 23:]).all() and torch.isfinite(lse[:, :23]).all()


def test_cpu_gradient_counts_no_launch_and_serving_keeps_its_path():
    q, k, v = (torch.randn(1, 16, 4, 32) for _ in range(3))
    before = (kernel.launches, backward.launches)
    out = mha_flash(q, k, v)                       # no grad needed: no graph
    assert out.grad_fn is None
    q.requires_grad_(True)
    out = mha_flash(q, k, v)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    with torch.no_grad():
        assert mha_flash(q, k, v).grad_fn is None
    torch.autograd.grad(out.sum(), q)
    assert (kernel.launches, backward.launches) == before


def _family_shapes():
    """(arch, B, NH, NKV, Sq, Skv, hd) at which a 2 x 512 training step
    calls B1, per family with flash attention (seamless: its bidirectional
    encoder over 512 frames, its cross attention over them)."""
    out = []
    for arch in C.all_archs():
        cfg = C.get(arch)
        if cfg.family not in ("dense", "moe", "vlm", "hybrid", "audio") or cfg.mla is not None:
            continue
        S = 512 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
        out.append((arch, 2, cfg.n_heads, cfg.n_kv_heads, S, S, cfg.resolved_head_dim))
    return out


# bytes of one CTA's shared memory as the csrc lays it out, by (dtype, hd):
# bf16 dK/dV: K and V tiles, 3 stages of Q and dO tiles (64 rows at the
# padded width, 2 bytes), the stages' 64 LSE and 64 D floats, 7 mbarriers;
# bf16 dQ: Q and dO tiles, 2 stages of K and V tiles, 5 mbarriers; float32:
# four 64 x (hd + 1) tiles, the P/dS tiles (64 x 65) and LSE and D
def _tile(hd):
    return 2 * 64 * (128 if hd == 80 else hd)


SMEM_TABLE = {("bfloat16", hd): (8 * _tile(hd) + 3 * 2 * 64 * 4 + 8 * 7,
                                 6 * _tile(hd) + 8 * 5) for hd in kernel.HEAD_DIMS}
SMEM_TABLE.update({("float32", hd): (4 * (4 * 64 * (hd + 1) + 2 * 64 * 65 + 2 * 64),
                                     4 * (4 * 64 * (hd + 1) + 64 * 65 + 2 * 64))
                   for hd in kernel.HEAD_DIMS})


def test_backward_chooser_at_phi4_training_shape():
    launch = backward.choose_launch(2, 24, 8, 512, 512, 128, "bfloat16")
    assert launch.dot_grid == 2 * 24 * 512 // 32     # 32 rows per CTA, 8 lanes each
    assert launch.dkdv_grid == (16, 8) and launch.dq_grid == (48, 8)
    assert launch.threads == 160                    # one consumer warpgroup + a producer warp
    assert (launch.dkdv_smem, launch.dq_smem) == (132664, 98344)
    assert launch.instance == ("bfloat16", 128)
    f32 = backward.choose_launch(2, 24, 8, 512, 512, 128, "float32")
    assert f32.threads == 256 and (f32.dkdv_smem, f32.dq_smem) == (165888, 149248)
    assert f32.dot_grid == 2 * 24 * 512 // 8         # a warp per row


@pytest.mark.parametrize("shape", _family_shapes(), ids=lambda s: s[0])
def test_backward_chooser_at_each_family_shape(shape):
    _, B, NH, NKV, Sq, Skv, hd = shape
    for dtype in ("bfloat16", "float32"):
        launch = backward.choose_launch(B, NH, NKV, Sq, Skv, hd, dtype)
        assert max(launch.dkdv_smem, launch.dq_smem) <= backward.MAX_SMEM
        assert (launch.dkdv_smem, launch.dq_smem) == SMEM_TABLE[dtype, hd]
        assert launch.threads == (160 if dtype == "bfloat16" else 256)
        assert launch.dkdv_grid == (B * NKV, -(-Skv // 64))
        assert launch.dq_grid == (B * NH, -(-Sq // 64))
        assert launch.instance in backward.INSTANCES


def test_bf16_dq_ctas_fit_twice_on_an_sm():
    """The bf16 dQ kernel is built for two CTAs to an SM: its shared memory
    (plus the 1 KB an SM reserves per CTA) fits twice in an H100 SM's
    228 KB at every head dim."""
    for hd in kernel.HEAD_DIMS:
        assert 2 * (backward.dq_smem_bytes(hd, "bfloat16") + 1024) <= 233472


def test_backward_covers_every_forward_head_dim():
    assert {hd for _, hd in backward.INSTANCES} == set(kernel.HEAD_DIMS)
    assert {dt for dt, _ in backward.INSTANCES} == {"float32", "bfloat16"}


@pytest.mark.parametrize("args,match", [
    ((1, 24, 8, 512, 512, 96, "bfloat16"), "head_dim"),
    ((1, 24, 8, 512, 512, 128, "float16"), "float16"),
    ((1, 24, 8, 512, 64 * 70000, 128, "float32"), "launch grid"),
])
def test_backward_chooser_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        backward.choose_launch(*args)


@pytest.mark.parametrize("case,match", [("cpu", "CUDA"), ("do_shape", "do must match"),
                                        ("lse_dtype", "lse must be"), ("o_dtype", "o must")])
def test_backward_wrapper_refuses(case, match):
    q, k, v = (torch.zeros(1, 8, 2, 32) for _ in range(3))
    o, do, lse = q.clone(), q.clone(), torch.zeros(1, 2, 8)
    if case == "do_shape":
        do = do[:, :4]
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "o_dtype":
        o = o.bfloat16()
    with pytest.raises(ValueError, match=match):
        backward.attention_bwd(q, k, v, o, lse, do)


class _FakeLibrary:
    """Stands in for the built library: records each call's arguments and
    returns ``rc``, as ``flash_attention_bwd`` returns a CUDA error."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_launch(monkeypatch):
    """attention_bwd on CPU tensors up to the library call: the device
    check and the stream are stubbed, the library is a _FakeLibrary."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel, "_check", lambda *a: None)
    monkeypatch.setattr(backward, "_kernel", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _bwd_args(dtype, misaligned=False):
    """Model-layout q, k, v, o, lse, do (B 2, S 16, 6 q heads over 2, hd
    64); with ``misaligned``, q's sequence stride 4 elements (8 bytes) past
    packed, which no tensor map takes."""
    B, S, NH, NKV, hd = 2, 16, 6, 2, 64
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(7, B, S, S, NH, NKV, hd))
    if misaligned:
        row = NH * hd + 4
        store = torch.zeros(B * S * row, dtype=dtype)
        view = store.as_strided(q.shape, (S * row, row, hd, 1))
        view.copy_(q)
        q = view
    o = torch.zeros_like(do)
    return q, k, v, o, torch.zeros(B, NH, S), do


@pytest.mark.parametrize("misaligned", [False, True])
def test_backward_routes_bf16_views_through_prepare(fake_launch, misaligned):
    """The bf16 kernels read q, k, v and dO by TMA: attention_bwd passes
    its inputs through ``kernel.prepare``, so a bf16 view whose sequence
    stride is 8 bytes off 16 takes exactly one counted copy, and the
    library gets 16-byte aligned pointers and strides; aligned model-layout
    inputs go as they are."""
    q, k, v, o, lse, do = _bwd_args(torch.bfloat16, misaligned)
    assert kernel.readable(q) is not misaligned
    before = kernel.layout_copies
    dq, dk, dv = backward.attention_bwd(q, k, v, o, lse, do, group=3)
    assert kernel.layout_copies - before == int(misaligned)
    (args,) = fake_launch.calls
    q_ptr, strides = args[0], list(args[17][:24])
    assert (q_ptr == q.data_ptr()) is not misaligned and q_ptr % kernel.TMA_ALIGN == 0
    assert all(2 * st % kernel.TMA_ALIGN == 0 for st in strides)
    assert strides[:3] == [16 * 6 * 64, 6 * 64, 64]      # q as a contiguous copy would be
    assert args[1:5] == (k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr())
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == torch.bfloat16 and args[10] == 1


def test_backward_float32_views_take_no_copy(fake_launch):
    """float32 runs the FMA kernels, which read element-wise: the same
    misaligned view goes in place."""
    q, k, v, o, lse, do = _bwd_args(torch.float32, misaligned=True)
    before = kernel.layout_copies
    backward.attention_bwd(q, k, v, o, lse, do, group=3)
    assert kernel.layout_copies == before
    assert fake_launch.calls[0][0] == q.data_ptr() and fake_launch.calls[0][10] == 0


def test_backward_launch_failure_raises_and_never_falls_back(fake_launch, monkeypatch):
    """A launch the library refuses raises, counts no launch, and never
    reaches the plain version."""
    import repro_torch.kernels.flash_attention as package
    from repro_torch.kernels.flash_attention import ops, ref

    def plain(*a, **kw):
        raise AssertionError("the plain backward was called for a kernel launch")

    for module in (package, ops, ref):
        monkeypatch.setattr(module, "flash_attention_bwd_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    before = backward.launches
    with pytest.raises(RuntimeError, match="flash_attention_bwd launch failed: CUDA error 700"):
        backward.attention_bwd(*_bwd_args(torch.bfloat16), group=3)
    assert backward.launches == before and len(fake_launch.calls) == 1


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """Both B1 sources and B2's include csrc/hopper.cuh: editing the header
    (and only a header the source includes) gives another library name, so
    a stale library is never loaded."""
    from repro_torch.kernels import build
    from repro_torch.kernels.adamw import kernel as adamw

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    csrc = backward.SOURCE.parent
    for source in (backward.SOURCE, kernel.SOURCE, pack.SOURCE):
        files = [p.resolve() for p in build.source_files(source)]
        assert (csrc / "hopper.cuh").resolve() in files
        # the copy includes the header by the source's own relative path
        include = next(n for n in build._INCLUDE.findall(source.read_text())
                       if n.endswith("hopper.cuh"))
        copy = tmp_path / source.stem / "csrc" / source.name
        copy.parent.mkdir(parents=True, exist_ok=True)
        header = copy.parent / include
        header.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(source.read_text())
        header.write_text((csrc / "hopper.cuh").read_text())
        (copy.parent / "unrelated.cuh").write_text("// not included\n")
        first = build.library_path(copy)
        assert first == build.library_path(copy)
        (copy.parent / "unrelated.cuh").write_text("// edited\n")
        assert build.library_path(copy) == first
        header.write_text(header.read_text() + "\n// edited\n")
        assert build.library_path(copy) != first
        assert build.library_path(copy).name.startswith(f"lib{source.stem}_")
    # a source with no local include keeps the hash of its own bytes
    assert build.source_files(adamw.SOURCE) == [adamw.SOURCE]


@pytest.mark.parametrize("shared", [False, True])
def test_stream_pack_gradient_matches_jax_grad(shared, monkeypatch):
    """dx and dw through ``StreamPack`` against ``jax.grad`` of the JAX
    package's plain stream_pack (float32 within TOL: summation order), for
    a per-lane or shared x and a dy that lies contiguous or transposed.
    First on the CPU (the plain version); then through the kernel's path,
    the kernel standing in as the plain version behind its own operand
    checks: the backward hands wᵀ and xᵀ over as they lie (dx = dy · wᵀ
    reads w transposed, dw = xᵀ · dy reads x transposed, of a shared x
    too) and no copy of x or w is made (``layout_copies`` 0)."""
    from repro_torch.kernels.stream_pack import ops, stream_pack_matmul_ref

    rng = np.random.default_rng(6)
    lanes, M, K, N = 4, 8, 16, 12
    x = rng.standard_normal((M, K) if shared else (lanes, M, K), dtype=np.float32)
    w = rng.standard_normal((lanes, K, N), dtype=np.float32)
    dy = rng.standard_normal((lanes, M, N), dtype=np.float32)

    def f(x, w):
        xx = jnp.broadcast_to(x, (lanes, M, K)) if shared else x
        return jnp.sum(jax_pack_ref(xx, w) * dy)

    want = jax.grad(f, argnums=(0, 1))(x, w)
    seen = []

    def on_card(xk, wk, **blocks):       # the kernel's operand checks, then its plain version
        seen.append(pack.launch_for(xk, wk).layout)
        return stream_pack_matmul_ref(xk, wk)

    copies = pack.layout_copies
    for path in ("plain", "kernel"):
        if path == "kernel":
            monkeypatch.setattr(ops, "takes_plain", lambda t: False)
            monkeypatch.setattr(pack, "stream_pack_matmul", on_card)
        for dy_t in (False, True):
            tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
            tdy = (torch.from_numpy(dy.transpose(0, 2, 1).copy()).transpose(1, 2) if dy_t
                   else torch.from_numpy(dy))
            before = pack.launches
            y = stream_pack(tx, tw)
            assert type(y.grad_fn).__name__.startswith("StreamPack")
            got = torch.autograd.grad(y, (tx, tw), tdy)
            assert pack.launches == before
            for g, w_ in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL)
    # each kernel pass: the forward (x row-major), dx (wᵀ), dw (xᵀ)
    assert seen == ["nn", "nt", "tn"] * 2
    assert pack.layout_copies == copies


def test_stream_pack_kernel_wrapper_refuses_to_detach():
    x = torch.zeros(2, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        pack.stream_pack_matmul(x, torch.zeros(2, 8, 4))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        pack.stream_pack_matmul(x, torch.zeros(2, 8, 4))
