"""The port's transformer against the JAX package's, on the CPU.

For the stablelm, phi4 and gemma2 smoke configs at float32 (LayerNorm+MHA,
RMSNorm+GQA, window+softcap+tied+post-norm) and the MoE family's arctic
(experts beside a dense branch) and deepseek-v2 (MLA, shared experts)
smoke configs, with the JAX weights carried over through
``repro_torch.bridge``: ``forward`` (and the router's aux loss),
``decode_step`` at mixed per-slot positions, teacher-forced decode against
``forward``, and the port's empty-cache ``prefill`` against JAX
``decode_step`` on a ``pos = 0`` sub-cache.  Prompts of 24 tokens exceed
gemma2-smoke's window of 16; MoE prompts of 80 tokens take the capacity
factor.  Tolerance 1e-4 abs and rel (float32 summation order).
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
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

ARCHS = ["stablelm-1.6b", "phi4-mini-3.8b", "gemma2-27b"]
TOL = 1e-4
PROMPT = 24


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _model(arch):
    """(JAX cfg, JAX params, port cfg, port model) with one set of weights."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="float32")
        tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="float32")
        params, _ = JT.init_model(jax.random.key(0), jcfg)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        _MODELS[arch] = (jcfg, params, tcfg, params_from_jax(np_tree, tcfg, device="cpu"))
    return _MODELS[arch]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS + ["starcoder2-15b"])
def test_forward_logits(arch):
    jcfg, params, tcfg, model = _model(arch)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, PROMPT))
    want, _ = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, aux = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
        assert torch.equal(model(torch.from_numpy(toks)), got)
    assert got.shape == (2, PROMPT, jcfg.padded_vocab)
    _close(got, want)
    assert float(aux["aux_loss"]) == 0.0


@pytest.mark.parametrize("S_new", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_mixed_slots(arch, S_new):
    """Per-slot offsets (one slot empty, one past gemma2's window); the
    port updates the cache in place and must end where JAX's new cache
    is."""
    jcfg, params, tcfg, model = _model(arch)
    rng = np.random.default_rng(1)
    B, T = 4, 32
    shape = (jcfg.n_layers, B, T, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([3, 20, 0, 9])
    toks = rng.integers(0, jcfg.vocab, (B, S_new))
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(pos, jnp.int32)}
    want, wcache = jax.jit(JT.decode_step, static_argnums=3)(params, jcache, jnp.asarray(toks), jcfg)
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
              "pos": torch.from_numpy(pos.copy())}
    k_store = tcache["k"]
    with torch.no_grad():
        got, out_cache = TT.decode_step(model, tcache, torch.from_numpy(toks), tcfg)
    assert out_cache is tcache and tcache["k"] is k_store          # in place
    _close(got, want)
    _close(tcache["k"], wcache["k"])
    _close(tcache["v"], wcache["v"])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(wcache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_step_on_empty_cache(arch):
    """The engine's prompt pass: JAX runs ``decode_step`` on a one-slot
    sub-cache at ``pos = 0``; the port runs ``prefill`` (flash attention,
    no cache) and gets the same logits and new keys/values."""
    jcfg, params, tcfg, model = _model(arch)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (1, PROMPT))
    sub = JT.init_cache(jcfg, 1, 32)
    sub["pos"] = jnp.zeros((1,), jnp.int32)
    want, wcache = jax.jit(JT.decode_step, static_argnums=3)(params, sub, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, (k, v) = TT.prefill(model, torch.from_numpy(toks), tcfg)
    _close(got, want)
    assert k.shape == (jcfg.n_layers, 1, PROMPT, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    _close(k, np.asarray(wcache["k"])[:, :, :PROMPT])
    _close(v, np.asarray(wcache["v"])[:, :, :PROMPT])


# bf16 logits (atol, rtol).  Both packages round every activation and every
# layer output to bf16 (one ulp is 2**-8 relative, 2**-6 at |logit| 4); on
# top of that JAX's attention (``_sdpa`` and ``_sdpa_deferred``) rounds the
# probabilities to bf16 before the PV product, where the port's plain
# version keeps them in float32 (its CUDA kernel rounds P per tile, before
# normalising).  Measured: at most 0.031 at |logits| <= 4.2 (two ulps).
BF16_LOGITS_TOL = (5e-2, 2e-2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("entry", ["prefill", "forward"])
def test_bf16_logits_match_jax(entry, seed):
    """phi4-mini smoke at bf16 on JAX's bf16 weights: the port's ``prefill``
    against JAX ``decode_step`` on an empty sub-cache (the engine's prompt
    pass), and ``forward`` against JAX ``forward``."""
    arch = "phi4-mini-3.8b"
    jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="bfloat16")
    params, _ = JT.init_model(jax.random.key(0), jcfg)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, bf), tcfg, device="cpu")
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (1, PROMPT))
    if entry == "prefill":
        sub = JT.init_cache(jcfg, 1, 32)
        sub["pos"] = jnp.zeros((1,), jnp.int32)
        want, _ = jax.jit(JT.decode_step, static_argnums=3)(bf, sub, jnp.asarray(toks), jcfg)
        with torch.no_grad():
            got, _ = TT.prefill(model, torch.from_numpy(toks), tcfg)
    else:
        want, _ = jax.jit(JT.forward, static_argnums=2)(bf, {"tokens": jnp.asarray(toks)}, jcfg)
        with torch.no_grad():
            got, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (1, PROMPT, jcfg.padded_vocab) and model.embed["tok"].dtype == torch.bfloat16
    atol, rtol = BF16_LOGITS_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_window_schedule_matches_jax():
    for arch in ARCHS:
        jcfg, _, tcfg, _ = _model(arch)
        want = JT._window_schedule(jcfg)
        got = TT._window_schedule(tcfg)
        assert (got is None) == (want is None)
        if want is not None:
            assert got == [int(w) for w in np.asarray(want)]


def test_init_cache_layout():
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype="float32")
    cache = TT.init_cache(cfg, 3, 40, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 3, 40, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert cache["v"].dtype == torch.float32 and cache["pos"].tolist() == [0, 0, 0]


def test_init_model_distributions():
    """The port's own initialiser draws with the JAX initialiser's
    distributions (not its numbers): norms start at their identity,
    embeddings at std 0.02, dense weights at 1/sqrt(fan-in)."""
    cfg = dataclasses.replace(TC.get("stablelm-1.6b", smoke=True), dtype="float32")
    model = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    lp = model.layers[0]
    assert torch.equal(lp["ln1"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(lp["ln1"]["bias"], torch.zeros(cfg.d_model))
    assert abs(float(model.embed["tok"].std()) - 0.02) < 2e-3
    assert abs(float(lp["attn"]["wq"].std()) - cfg.d_model ** -0.5) < 0.01
    assert all(not p.requires_grad for p in model.parameters())
    rms = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype="float32")
    rmodel = TT.init_model(torch.Generator().manual_seed(0), rms, device="cpu")
    assert torch.equal(rmodel.final_norm["scale"], torch.zeros(rms.d_model))
    with torch.no_grad():
        logits = rmodel(torch.zeros((1, 5), dtype=torch.long))
    assert torch.isfinite(logits).all()


def test_bridge_refuses_a_foreign_tree_and_keeps_bf16_bits():
    jcfg, params, tcfg, _ = _model("phi4-mini-3.8b")
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    broken = dict(np_tree, embed={"tok": np_tree["embed"]["tok"]})   # unembed missing
    with pytest.raises(ValueError, match="unembed"):
        params_from_jax(broken, tcfg, device="cpu")
    bf = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    model = params_from_jax(bf, dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    assert model.embed["tok"].dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed["tok"].float().numpy(),
                                  np.asarray(bf["embed"]["tok"], np.float32))


def test_unported_families_are_refused():
    """Every family of the JAX registry is ported: ``all_archs()`` lists the
    same ten architectures as JAX's and ``get`` serves each of them; a
    family neither package knows is refused."""
    assert TC.all_archs() == JC.all_archs()
    for arch in TC.all_archs():
        assert TC.get(arch, smoke=True).family == JC.get(arch, smoke=True).family
    unknown = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        TT.Transformer(unknown, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        TT.init_cache(unknown, 1, 8, device="cpu")


# -- the MoE family ------------------------------------------------------------

MOE_ARCHS = ["arctic-480b", "deepseek-v2-236b"]


def _cache_pair(jcfg, tcfg, B, T, pos, rng):
    """The same random cache (k/v, or MLA's ckv/krope) for JAX and the port."""
    names = TT.cache_names(tcfg)
    shapes = {k: tuple(v.shape[1:]) for k, v in JT.init_cache(jcfg, B, T).items() if k != "pos"}
    assert tuple(shapes) == names
    arrays = {k: rng.standard_normal((jcfg.n_layers,) + shapes[k]).astype(np.float32)
              for k in names}
    jcache = {k: jnp.asarray(a) for k, a in arrays.items()}
    jcache["pos"] = jnp.asarray(pos, jnp.int32)
    tcache = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
    tcache["pos"] = torch.from_numpy(pos.copy())
    return jcache, tcache


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_and_aux(arch):
    """Logits and the router's aux loss summed over the layers."""
    jcfg, params, tcfg, model = _model(arch)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, PROMPT))
    want, waux = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, aux = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, PROMPT, jcfg.padded_vocab)
    _close(got, want)
    assert float(aux["aux_loss"]) > 0
    np.testing.assert_allclose(float(aux["aux_loss"]), float(waux["aux_loss"]), rtol=TOL)


@pytest.mark.parametrize("S_new", [1, 3])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_mixed_slots(arch, S_new):
    """Per-slot offsets, one slot empty; Arctic appends k/v after the layer
    loop, DeepSeek writes its latents inside each layer.  Both in place,
    ending where JAX's new cache is."""
    jcfg, params, tcfg, model = _model(arch)
    rng = np.random.default_rng(1)
    B, T = 4, 32
    pos = np.array([3, 20, 0, 9])
    jcache, tcache = _cache_pair(jcfg, tcfg, B, T, pos, rng)
    toks = rng.integers(0, jcfg.vocab, (B, S_new))
    want, wcache = jax.jit(JT.decode_step, static_argnums=3)(params, jcache, jnp.asarray(toks), jcfg)
    stores = {k: tcache[k] for k in TT.cache_names(tcfg)}
    with torch.no_grad():
        got, out_cache = TT.decode_step(model, tcache, torch.from_numpy(toks), tcfg)
    assert out_cache is tcache
    _close(got, want)
    for k, store in stores.items():
        assert tcache[k] is store                                # in place
        _close(tcache[k], wcache[k])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(wcache["pos"]))


@pytest.mark.parametrize("P", [PROMPT, 80])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_decode_step_on_empty_cache(arch, P):
    """The engine's prompt pass at a dropless length and at one past 64,
    where the prompt's length sets the experts' capacity."""
    jcfg, params, tcfg, model = _model(arch)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (1, P))
    sub = JT.init_cache(jcfg, 1, 96)
    sub["pos"] = jnp.zeros((1,), jnp.int32)
    want, wcache = jax.jit(JT.decode_step, static_argnums=3)(params, sub, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, new = TT.prefill(model, torch.from_numpy(toks), tcfg)
    _close(got, want)
    for name, t in zip(TT.cache_names(tcfg), new):
        assert t.shape[:3] == (jcfg.n_layers, 1, P)
        _close(t, np.asarray(wcache[name])[:, :, :P])


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_decode_matches_forward_teacher_forced(arch):
    """Step-by-step decode of the tokens equals the full-sequence forward
    (the port's mirror of ``test_arch_smoke.py::test_decode_matches_forward``:
    KV caching, MLA's latent absorption, the MoE dispatch at N = B)."""
    jcfg, params, tcfg, model = _model(arch)
    B, s = 2, 8
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, s))
    with torch.no_grad():
        ref, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
        cache = TT.init_cache(tcfg, B, s, device="cpu")
        for t in range(s):
            logits, cache = TT.decode_step(model, cache, torch.from_numpy(toks[:, t: t + 1]), tcfg)
            np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, t].numpy(), rtol=TOL, atol=TOL)
    assert cache["pos"].tolist() == [s] * B


# MoE bf16 logits (atol, rtol): as BF16_LOGITS_TOL, and XLA also keeps the
# MoE's fused elementwise work (activation, gate product and weighting,
# combine) in float32 where the port rounds each step to bf16.  Measured:
# at most 0.0703 at |logits| <= 4.6 (4.5 bf16 ulps at 4).
MOE_BF16_LOGITS_TOL = (1e-1, 2e-2)


@pytest.mark.parametrize("entry", ["prefill", "forward"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_logits_match_jax(arch, entry):
    """The smoke configs at bf16 on JAX's weights (bf16, router and norms
    float32): ``prefill`` against JAX ``decode_step`` on an empty sub-cache,
    ``forward`` against JAX ``forward``."""
    jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="bfloat16")
    params, _ = JT.init_model(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, PROMPT))
    if entry == "prefill":
        sub = JT.init_cache(jcfg, 1, 32)
        sub["pos"] = jnp.zeros((1,), jnp.int32)
        want, _ = jax.jit(JT.decode_step, static_argnums=3)(params, sub, jnp.asarray(toks), jcfg)
        with torch.no_grad():
            got, _ = TT.prefill(model, torch.from_numpy(toks), tcfg)
    else:
        want, _ = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
        with torch.no_grad():
            got, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (1, PROMPT, jcfg.padded_vocab)
    assert model.layers[0]["moe"]["w_gate"].dtype == torch.bfloat16
    atol, rtol = MOE_BF16_LOGITS_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_moe_cache_layout():
    cfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    cache = TT.init_cache(cfg, 3, 40, device="cpu")
    assert list(cache) == ["ckv", "krope", "pos"]
    assert cache["ckv"].shape == (cfg.n_layers, 3, 40, cfg.mla.kv_lora_rank)
    assert cache["krope"].shape == (cfg.n_layers, 3, 40, cfg.mla.qk_rope_head_dim)
    arctic = dataclasses.replace(TC.get("arctic-480b", smoke=True), dtype="float32")
    assert list(TT.init_cache(arctic, 1, 8, device="cpu")) == ["k", "v", "pos"]
