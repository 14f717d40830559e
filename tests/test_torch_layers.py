"""Each function of the port's ``models/layers.py`` against its JAX
counterpart, on the CPU at float32 (tolerance 1e-5: float32 summation
order between two libraries)."""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.models.layers as JL  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.layers as TL  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **over):
    """The same smoke config from both packages (float32)."""
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(JC.get(arch, smoke=True), **over),
            dataclasses.replace(TC.get(arch, smoke=True), **over))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """A dict of numpy arrays as a JAX dict and a torch dict."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "stablelm-1.6b"])
def test_apply_norm(arch):
    """RMSNorm scales by (1 + scale); LayerNorm uses the population
    variance; both compute in float32."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    p = {"scale": _rand(rng, jcfg.d_model)}
    if jcfg.norm == "layernorm":
        p["bias"] = _rand(rng, jcfg.d_model)
    x = _rand(rng, 2, 5, jcfg.d_model, scale=3.0)
    jp, tp = _both(p)
    _close(TL.apply_norm(tp, torch.from_numpy(x), tcfg), JL.apply_norm(jp, jnp.asarray(x), jcfg))


def test_rope_per_slot_positions():
    """Split-half rotation over the full head_dim, per-slot offsets."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 4, 2, 32)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [500, 501, 502, 503]], np.int64)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10000.0))
    _close(TL.rope_freqs(64, 100000.0), JL.rope_freqs(64, 100000.0))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b"])   # silu, gelu-tanh
def test_apply_ffn(arch):
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    d, f = jcfg.d_model, jcfg.d_ff
    p = {"w_gate": _rand(rng, d, f, scale=d**-0.5), "w_up": _rand(rng, d, f, scale=d**-0.5),
         "w_down": _rand(rng, f, d, scale=f**-0.5)}
    x = _rand(rng, 2, 3, d)
    jp, tp = _both(p)
    _close(TL.apply_ffn(tp, torch.from_numpy(x), tcfg), JL.apply_ffn(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b"])    # untied, tied
def test_embed_and_unembed(arch):
    """gemma2 scales embeddings by sqrt(d) and soft-caps the final logits;
    tied models unembed through the token table.  Logits span the padded
    vocab."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    V, d = jcfg.padded_vocab, jcfg.d_model
    p = {"tok": _rand(rng, V, d)}
    if not jcfg.tie_embeddings:
        p["unembed"] = _rand(rng, d, V, scale=d**-0.5)
    jp, tp = _both(p)
    toks = rng.integers(0, jcfg.vocab, (2, 7))
    _close(TL.embed_tokens(tp, torch.from_numpy(toks), tcfg),
           JL.embed_tokens(jp, jnp.asarray(toks), jcfg))
    x = _rand(rng, 2, 7, d)
    got = TL.unembed(tp, torch.from_numpy(x), tcfg)
    assert got.shape == (2, 7, V) and got.dtype == torch.float32
    _close(got, JL.unembed(jp, jnp.asarray(x), jcfg), 2e-5 if jcfg.final_softcap else TOL)


def test_gemma2_embedding_scale_rounds_like_jax_in_bf16():
    jcfg, tcfg = _cfgs("gemma2-27b", dtype="bfloat16")
    rng = np.random.default_rng(4)
    tok = _rand(rng, 16, jcfg.d_model)
    toks = np.arange(16).reshape(2, 8)
    got = TL.embed_tokens({"tok": torch.from_numpy(tok).bfloat16()}, torch.from_numpy(toks), tcfg)
    want = JL.embed_tokens({"tok": jnp.asarray(tok, jnp.bfloat16)}, jnp.asarray(toks), jcfg)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_softcap_and_rms():
    rng = np.random.default_rng(5)
    x = _rand(rng, 4, 33, scale=40.0)
    _close(TL.softcap(torch.from_numpy(x), 30.0), JL.softcap(jnp.asarray(x), 30.0))
    t = torch.from_numpy(x)
    assert TL.softcap(t, 0.0) is t
    # the port's _rms(x) * scale is B8 at offset 0 (tests/test_torch_rms_norm.py); scale 1
    _close(TL._rms_scaled(torch.from_numpy(x), torch.ones(33)), JL._rms(jnp.asarray(x)))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa(window, causal):
    """The cache form of decode attention over a cache whose S positions
    are all valid (0-d ``kv_valid``) is JAX's ``_sdpa`` over those tokens."""
    rng = np.random.default_rng(6)
    B, S, NH, NKV, H = 2, 12, 6, 2, 16
    q, k, v = _rand(rng, B, S, NH, H), _rand(rng, B, S, NKV, H), _rand(rng, B, S, NKV, H)
    kw = dict(scale=0.25, softcap_val=20.0, window=window, causal=causal)
    pos = np.arange(S)
    got = TL._decode_attention(*map(torch.from_numpy, (q, k, v)), None, None,
                               positions=torch.from_numpy(pos), kv_valid=torch.tensor(S), **kw)
    want = JL._sdpa(*map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
                    kv_pos=jnp.asarray(pos), kv_valid=None, **kw)
    _close(got, want)


def test_sdpa_per_slot_cache_mask():
    """Per-slot query positions against a cache with per-slot valid lengths
    (decode attention's cache form against JAX's ``_sdpa``)."""
    rng = np.random.default_rng(7)
    B, S, T, NH, NKV, H = 3, 1, 20, 4, 2, 16
    q, k, v = _rand(rng, B, S, NH, H), _rand(rng, B, T, NKV, H), _rand(rng, B, T, NKV, H)
    qpos = np.array([[4], [11], [19]])
    valid = np.array([5, 12, 20])
    kw = dict(scale=0.25, softcap_val=0.0, window=None)
    got = TL._decode_attention(*map(torch.from_numpy, (q, k, v)), None, None,
                               positions=torch.from_numpy(qpos),
                               kv_valid=torch.from_numpy(valid), **kw)
    want = JL._sdpa(*map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(qpos),
                    kv_pos=jnp.arange(T), kv_valid=jnp.asarray(valid), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("S", [1, 3])
def test_sdpa_deferred_mixed_slots(window, S):
    """Deferred two-part attention with mixed per-slot ``kv_valid``,
    including an empty slot (0) and a full one."""
    rng = np.random.default_rng(8)
    B, T, NH, NKV, H = 4, 16, 6, 2, 16
    kv_valid = np.array([0, 5, 11, 13])
    positions = kv_valid[:, None] + np.arange(S)[None, :]
    arrs = (_rand(rng, B, S, NH, H), _rand(rng, B, T, NKV, H), _rand(rng, B, T, NKV, H),
            _rand(rng, B, S, NKV, H), _rand(rng, B, S, NKV, H))
    kw = dict(scale=0.3, softcap_val=50.0, window=window)
    got = TL._decode_attention(*map(torch.from_numpy, arrs),
                               positions=torch.from_numpy(positions),
                               kv_valid=torch.from_numpy(kv_valid), **kw)
    want = JL._sdpa_deferred(*map(jnp.asarray, arrs), positions=jnp.asarray(positions, jnp.int32),
                             kv_valid=jnp.asarray(kv_valid, jnp.int32), **kw)
    _close(got, want)


def test_append_kv_in_place_with_clamp():
    """Per-slot writes for all layers at once, in place; an offset past the
    end is clamped as ``dynamic_update_slice`` clamps it."""
    rng = np.random.default_rng(9)
    L, B, T, NKV, H, S = 2, 3, 10, 2, 4, 2
    ck, cv = _rand(rng, L, B, T, NKV, H), _rand(rng, L, B, T, NKV, H)
    nk, nv = _rand(rng, L, B, S, NKV, H), _rand(rng, L, B, S, NKV, H)
    pos = np.array([0, 4, 9])
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out_k, out_v = TL.append_kv(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv),
                                torch.from_numpy(pos))
    assert out_k is tk and out_v is tv
    wk, wv = JL.append_kv(*map(jnp.asarray, (ck, cv, nk, nv)), jnp.asarray(pos, jnp.int32))
    _close(tk, wk, 0.0)
    _close(tv, wv, 0.0)


def _attn_params(rng, cfg):
    d, h, nh, nkv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    return {"wq": _rand(rng, d, nh, h, scale=d**-0.5), "wk": _rand(rng, d, nkv, h, scale=d**-0.5),
            "wv": _rand(rng, d, nkv, h, scale=d**-0.5), "wo": _rand(rng, nh, h, d, scale=nh**-0.5)}


@pytest.mark.parametrize("arch,window", [("phi4-mini-3.8b", None), ("gemma2-27b", 16)])
def test_attention_without_cache_goes_through_flash(arch, window, monkeypatch):
    """No cache: the port's attention is ``mha_flash`` and matches the JAX
    ``attention`` (which runs ``_sdpa``) over 24 tokens."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(10)
    jp, tp = _both(_attn_params(rng, jcfg))
    x = _rand(rng, 2, 24, jcfg.d_model)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    calls = []
    real = TL.mha_flash
    monkeypatch.setattr(TL, "mha_flash", lambda *a, **k: calls.append(k) or real(*a, **k))
    got, (k, v) = TL.attention(tp, torch.from_numpy(x), tcfg,
                               positions=torch.from_numpy(pos.copy()), layer_window=window)
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                           layer_window=window)
    _close(got, want, 2e-5)
    assert len(calls) == 1 and calls[0]["window"] == (window or 0)
    assert k.shape == (2, 24, jcfg.n_kv_heads, jcfg.resolved_head_dim)


def test_attention_with_cache_is_deferred():
    jcfg, tcfg = _cfgs("gemma2-27b")
    rng = np.random.default_rng(11)
    jp, tp = _both(_attn_params(rng, jcfg))
    B, T = 3, 32
    h, nkv = jcfg.resolved_head_dim, jcfg.n_kv_heads
    ck, cv = _rand(rng, B, T, nkv, h), _rand(rng, B, T, nkv, h)
    pos = np.array([3, 20, 0])
    x = _rand(rng, B, 1, jcfg.d_model)
    positions = pos[:, None]
    got, (k, v) = TL.attention(
        tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(positions), layer_window=16,
        cache={"k": torch.from_numpy(ck), "v": torch.from_numpy(cv), "pos": torch.from_numpy(pos)},
        update_cache=False)
    want, (wk, wv) = JL.attention(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions, jnp.int32), layer_window=16,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(pos, jnp.int32)},
        update_cache=False)
    _close(got, want)
    _close(k, wk)
    _close(v, wv)


def test_mha_flash_hands_the_kernel_contiguous_rows(monkeypatch):
    """A tensor that takes no plain version (a CUDA tensor; here a meta
    tensor, with the device test patched, since a meta tensor itself takes
    the plain version) goes to the kernel's wrapper as it comes, in the
    model layout: the kernel reads the strides, and each row of head_dim is
    contiguous, so no layout copy is made (``kernel.prepare`` copies only
    what its tensor maps cannot describe)."""
    seen = []

    def fake_kernel(q, k, v, **kw):
        seen.append((q, k, v, kw["group"]))
        return torch.empty_like(q)

    monkeypatch.setattr(ops.kernel, "attention", fake_kernel)
    monkeypatch.setattr(ops, "takes_plain", lambda t: False)
    q = torch.empty(1, 40, 24, 128, device="meta")
    kv = torch.empty(1, 40, 8, 128, device="meta")
    out = ops.mha_flash(q, kv, kv)
    assert out.shape == q.shape
    assert len(seen) == 1 and seen[0][0] is q and seen[0][1] is kv and seen[0][2] is kv
    assert seen[0][3] == 3 and all(t.stride(-1) == 1 for t in seen[0][:3])
