"""The port's audio family (seamless: encoder, decoder with cross
attention) and the in-layer KV-cache update against the JAX package's, on
the CPU.

``cross_attention`` (one query row, and more queries than keys),
``encode_memory`` and the in-layer KV update of ``layers.attention``
(mixed per-slot offsets, one clamped at the cache's end, written in place)
within 1e-5; ``forward`` logits within 1e-4; teacher-forced ``decode_step``
with the memory in the cache equal to ``forward`` within 1e-4;
``decode_step`` against JAX's over several steps; bf16 logits within
``BF16_LOGITS_TOL``.  Weights come from JAX through
``bridge.params_from_jax`` and inputs from a numpy seed.  Tolerances are
float32 summation order.
"""

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
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.layers as TL  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = 1e-4
BLOCK_TOL = 1e-5
# bf16 logits (atol, rtol): both packages round activations and layer
# outputs to bf16; JAX's attention rounds the probabilities to bf16 before
# the PV product, where the port's plain version keeps them float32.
# Measured over seeds 0, 1, 7: at most 0.031 at |logits| <= 4.2 (atol 0.028
# needed at rtol 0.02).
BF16_LOGITS_TOL = (5e-2, 2e-2)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _model(dtype="float32"):
    if dtype not in _MODELS:
        jcfg = dataclasses.replace(JC.get(ARCH, smoke=True), dtype=dtype)
        tcfg = dataclasses.replace(TC.get(ARCH, smoke=True), dtype=dtype)
        params, _ = JT.init_model(jax.random.key(0), jcfg)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        _MODELS[dtype] = (jcfg, params, tcfg, params_from_jax(np_tree, tcfg, device="cpu"))
    return _MODELS[dtype]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)),
            "frames": rng.standard_normal((B, S // cfg.audio_frames_ratio, cfg.audio_dim),
                                          dtype=np.float32)}


@pytest.mark.parametrize("S,T", [(1, 4), (5, 4), (3, 12)])
def test_cross_attention_matches_jax(S, T):
    jcfg, params, tcfg, model = _model()
    jp = jax.tree_util.tree_map(lambda a: a[1], params["decoder"]["cross_attn"])
    rng = np.random.default_rng(S * T)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    mem = rng.standard_normal((2, T, jcfg.d_model), dtype=np.float32)
    want = JL.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    with torch.no_grad():
        got = TL.cross_attention(model.decoder[1]["cross_attn"], torch.from_numpy(x),
                                 torch.from_numpy(mem), tcfg)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("T", [4, 12])
def test_encode_memory_matches_jax(T):
    jcfg, params, tcfg, model = _model()
    frames = np.random.default_rng(T).standard_normal((2, T, jcfg.audio_dim), dtype=np.float32)
    want = JT.encode_memory(params, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        got = TT.encode_memory(model, torch.from_numpy(frames), tcfg)
    assert got.shape == (2, T, tcfg.d_model)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("S_new", [1, 3])
def test_in_layer_kv_update_matches_jax(S_new):
    """``layers.attention`` with a cache and ``update_cache=True``: each
    slot's new keys/values land at its own offset (slot 3's clamped to the
    cache's end, as ``dynamic_update_slice`` clamps), in the given tensors,
    and the tokens attend over the updated cache with kv_valid = pos + S."""
    jcfg, params, tcfg, model = _model()
    jp = jax.tree_util.tree_map(lambda a: a[0], params["decoder"]["self_attn"])
    rng = np.random.default_rng(S_new)
    B, T = 4, 12
    shape = (B, T, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.array([0, 5, 2, T - 1])
    x = rng.standard_normal((B, S_new, jcfg.d_model), dtype=np.float32)
    positions = pos[:, None] + np.arange(S_new)[None, :]
    want, wcache = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
                                cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                                       "pos": jnp.asarray(pos, jnp.int32)})
    k_store, v_store = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tcache = {"k": k_store, "v": v_store, "pos": torch.from_numpy(pos.copy())}
    with torch.no_grad():
        got, (k_new, _) = TL.attention(model.decoder[0]["self_attn"], torch.from_numpy(x), tcfg,
                                       positions=torch.from_numpy(positions), cache=tcache)
    assert tcache["k"] is k_store and tcache["v"] is v_store
    assert k_new.shape == (B, S_new, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    _close(got, want, BLOCK_TOL)
    _close(k_store, wcache["k"], BLOCK_TOL)
    _close(v_store, wcache["v"], BLOCK_TOL)
    assert tcache["pos"].tolist() == pos.tolist()      # the caller advances pos


@pytest.mark.parametrize("S", [8, 16])
def test_forward_logits(S):
    jcfg, params, tcfg, model = _model()
    batch = _batch(jcfg, 2, S, seed=S)
    want, _ = jax.jit(JT.forward, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got, aux = TT.forward(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert got.shape == (2, S, jcfg.padded_vocab) and float(aux["aux_loss"]) == 0.0
    _close(got, want)


def _cache_with_memory(tcfg, model, frames, B, max_len):
    cache = TT.init_cache(tcfg, B, max_len, memory_len=frames.shape[1], device="cpu")
    assert list(cache) == ["k", "v", "memory", "pos"]
    cache["memory"].copy_(TT.encode_memory(model, torch.from_numpy(frames), tcfg))
    return cache


def test_decode_matches_forward_teacher_forced():
    jcfg, params, tcfg, model = _model()
    B, s = 2, 8
    batch = _batch(jcfg, B, s, seed=0)
    with torch.no_grad():
        ref, _ = TT.forward(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
        cache = _cache_with_memory(tcfg, model, batch["frames"], B, s)
        for t in range(s):
            tok = torch.from_numpy(batch["tokens"][:, t: t + 1])
            logits, cache = TT.decode_step(model, cache, tok, tcfg)
            _close(logits[:, 0], ref[:, t].numpy())
    assert cache["pos"].tolist() == [s] * B


def test_decode_step_matches_jax_over_steps():
    """Five greedy steps of three slots from the encoded memory, the cache
    held to JAX's new cache and updated in place."""
    jcfg, params, tcfg, model = _model()
    B, T = 3, 16
    frames = np.random.default_rng(4).standard_normal((B, 4, jcfg.audio_dim), dtype=np.float32)
    jcache = JT.init_cache(jcfg, B, T, memory_len=4)
    jcache["memory"] = JT.encode_memory(params, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        tcache = _cache_with_memory(tcfg, model, frames, B, T)
    stores = {k: tcache[k] for k in ("k", "v", "memory")}
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (B, 1))
    step = jax.jit(JT.decode_step, static_argnums=3)
    for _ in range(5):
        want, jcache = step(params, jcache, jnp.asarray(toks), jcfg)
        with torch.no_grad():
            got, out = TT.decode_step(model, tcache, torch.from_numpy(toks), tcfg)
        assert out is tcache
        _close(got, want)
        for k, store in stores.items():
            assert tcache[k] is store
            _close(tcache[k], jcache[k])
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        toks = np.array(jnp.argmax(want[:, :, : jcfg.vocab], axis=-1))


def test_bf16_logits_match_jax():
    jcfg, params, tcfg, model = _model("bfloat16")
    batch = _batch(jcfg, 2, 16, seed=7)
    want, _ = jax.jit(JT.forward, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got, _ = TT.forward(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert model.frontend_proj["w"].dtype == torch.bfloat16
    atol, rtol = BF16_LOGITS_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)
