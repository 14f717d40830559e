"""The port's hybrid family (zamba2: Mamba2 layers and a shared attention
block) against the JAX package's, on the CPU.

``mamba2_block`` chunked (several chunk lengths, ragged ones halved as in
JAX) and recurrent (one token against a cache, written in place) within
1e-5; ``forward`` logits within 1e-4; teacher-forced ``decode_step``
equal to ``forward`` within 1e-4; ``decode_step`` against JAX's over
several steps, logits and every cache leaf within 1e-4; bf16 logits
within ``BF16_LOGITS_TOL``.  The port refuses a cached ``mamba2_block``
call of more than one token, where JAX reads token 0 and drops the rest
(ROADMAP Queue 3).  Weights come from JAX through ``bridge.params_from_jax``
and inputs from a numpy seed.  Tolerances are float32 summation order.
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
import repro.models.ssm as JS  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.ssm as TS  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = 1e-4
BLOCK_TOL = 1e-5
# bf16 logits (atol, rtol): both packages round activations and layer
# outputs to bf16, but XLA fuses the Mamba2 block's bf16 elementwise chains
# (the conv's products and sums, silu, the gate product) and rounds once
# where the port rounds each step, and JAX's attention rounds the
# probabilities to bf16 before the PV product (the port's plain version
# keeps them float32).  Measured over seeds 0, 1, 7: at most 0.141 at
# |logits| <= 4.6 (atol 0.116 needed at rtol 0.02).
BF16_LOGITS_TOL = (1.5e-1, 2e-2)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _cfgs(dtype="float32", chunk=None):
    jcfg = dataclasses.replace(JC.get(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(TC.get(ARCH, smoke=True), dtype=dtype)
    if chunk:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=chunk))
    return jcfg, tcfg


def _model(dtype="float32"):
    if dtype not in _MODELS:
        jcfg, tcfg = _cfgs(dtype)
        params, _ = JT.init_model(jax.random.key(0), jcfg)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        _MODELS[dtype] = (jcfg, params, tcfg, params_from_jax(np_tree, tcfg, device="cpu"))
    return _MODELS[dtype]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _mamba(layer=0):
    jcfg, params, tcfg, model = _model()
    jp = jax.tree_util.tree_map(lambda a: a[layer], params["layers"]["mamba"])
    return jp, model.layers[layer]["mamba"]


@pytest.mark.parametrize("S,chunk", [(16, 256), (24, 8), (20, 8), (2, 256)])
def test_mamba2_chunked_matches_jax(S, chunk):
    """S = 20 with chunk 8 halves the chunk to 4, as JAX does."""
    jcfg, tcfg = _cfgs(chunk=chunk)
    jp, tp = _mamba()
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    want, wcache = JS.mamba2_block(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, cache = TS.mamba2_block(tp, torch.from_numpy(x), tcfg)
    assert cache is None and wcache is None
    _close(got, want, BLOCK_TOL)


def test_mamba2_recurrent_step_matches_jax_in_place():
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba()
    rng = np.random.default_rng(3)
    d_inner, H, conv_ch = TS.ssm_dims(tcfg)
    s = tcfg.ssm
    h = rng.standard_normal((2, H, s.head_dim, s.state_dim), dtype=np.float32)
    conv = rng.standard_normal((2, s.conv_width - 1, conv_ch), dtype=np.float32)
    x = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
    want, wcache = JS.mamba2_block(jp, jnp.asarray(x), jcfg,
                                   cache={"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    tcache = {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(conv.copy())}
    stores = dict(tcache)
    with torch.no_grad():
        got, out = TS.mamba2_block(tp, torch.from_numpy(x), tcfg, cache=tcache)
    assert out is tcache and all(tcache[k] is stores[k] for k in stores)   # in place
    _close(got, want, BLOCK_TOL)
    _close(tcache["h"], wcache["h"], BLOCK_TOL)
    _close(tcache["conv"], wcache["conv"], BLOCK_TOL)
    # one token without a cache starts from zeros and returns a new state
    with torch.no_grad():
        _, fresh = TS.mamba2_block(tp, torch.from_numpy(x), tcfg)
    _, wfresh = JS.mamba2_block(jp, jnp.asarray(x), jcfg)
    _close(fresh["h"], wfresh["h"], BLOCK_TOL)


def test_mamba2_refuses_several_tokens_with_a_cache():
    """JAX's recurrent branch reads token 0 and silently drops the rest
    (its output for two tokens repeats the first token's state update);
    the port raises instead."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba()
    _, H, conv_ch = TS.ssm_dims(tcfg)
    s = tcfg.ssm
    x = np.random.default_rng(4).standard_normal((1, 2, tcfg.d_model), dtype=np.float32)
    jcache = {"h": jnp.zeros((1, H, s.head_dim, s.state_dim)),
              "conv": jnp.zeros((1, s.conv_width - 1, conv_ch))}
    _, two = JS.mamba2_block(jp, jnp.asarray(x), jcfg, cache=jcache)
    _, one = JS.mamba2_block(jp, jnp.asarray(x[:, :1]), jcfg, cache=jcache)
    np.testing.assert_allclose(np.asarray(two["h"]), np.asarray(one["h"]), rtol=1e-5, atol=1e-6)
    tcache = {"h": torch.zeros((1, H, s.head_dim, s.state_dim)),
              "conv": torch.zeros((1, s.conv_width - 1, conv_ch))}
    with pytest.raises(ValueError, match="one token"):
        TS.mamba2_block(tp, torch.from_numpy(x), tcfg, cache=tcache)
    with pytest.raises(ValueError, match="one token"):
        TT.decode_step(_model()[3], TT.init_cache(tcfg, 1, 8, device="cpu"),
                       torch.zeros((1, 2), dtype=torch.long), tcfg)


def test_causal_conv_with_state_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba()
    _, _, conv_ch = TS.ssm_dims(tcfg)
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 5, conv_ch), dtype=np.float32)
    state = rng.standard_normal((2, tcfg.ssm.conv_width - 1, conv_ch), dtype=np.float32)
    for st in (None, state):
        want, wstate = JS._causal_conv(jnp.asarray(xbc), jp, jcfg,
                                       None if st is None else jnp.asarray(st))
        got, gstate = TS._causal_conv(torch.from_numpy(xbc), tp,
                                      None if st is None else torch.from_numpy(st))
        _close(got, want, BLOCK_TOL)
        _close(gstate, wstate, BLOCK_TOL)


@pytest.mark.parametrize("S", [16, 24])
def test_forward_logits(S):
    jcfg, params, tcfg, model = _model()
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S))
    want, _ = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, aux = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, S, jcfg.padded_vocab) and float(aux["aux_loss"]) == 0.0
    _close(got, want)


def test_decode_matches_forward_teacher_forced():
    jcfg, params, tcfg, model = _model()
    B, s = 2, 8
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, s))
    with torch.no_grad():
        ref, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
        cache = TT.init_cache(tcfg, B, s, device="cpu")
        for t in range(s):
            logits, cache = TT.decode_step(model, cache, torch.from_numpy(toks[:, t: t + 1]), tcfg)
            _close(logits[:, 0], ref[:, t].numpy())
    assert cache["pos"].tolist() == [s] * B


def test_decode_step_matches_jax_over_steps():
    """Five greedy steps from slots at mixed offsets (a random state and
    KV cache), every leaf of the cache held to JAX's new one and updated
    in place."""
    jcfg, params, tcfg, model = _model()
    rng = np.random.default_rng(6)
    B, T = 3, 16
    jcache = JT.init_cache(jcfg, B, T)
    arrays = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jcache.items() if k != "pos"}
    pos = np.array([0, 5, 9])
    jcache = {**{k: jnp.asarray(a) for k, a in arrays.items()}, "pos": jnp.asarray(pos, jnp.int32)}
    tcache = TT.init_cache(tcfg, B, T, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    stores = {}
    for k, a in arrays.items():
        tcache[k].copy_(torch.from_numpy(a))
        stores[k] = tcache[k]
    tcache["pos"].copy_(torch.from_numpy(pos))
    toks = rng.integers(0, jcfg.vocab, (B, 1))
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
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 16))
    want, _ = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert model.layers[0]["mamba"]["w_in"].dtype == torch.bfloat16
    assert model.layers[0]["mamba"]["A_log"].dtype == torch.float32
    atol, rtol = BF16_LOGITS_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_init_model_distributions():
    """The port's own initialiser: A_log, dt_bias and conv_b at 0, D at 1,
    dense weights at 1/sqrt(fan-in)."""
    _, tcfg = _cfgs()
    model = TT.init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    mp = model.layers[0]["mamba"]
    for name in ("A_log", "dt_bias", "conv_b"):
        assert torch.equal(mp[name], torch.zeros_like(mp[name]))
    assert torch.equal(mp["D"], torch.ones_like(mp["D"]))
    assert abs(float(mp["w_in"].std()) - tcfg.d_model ** -0.5) < 0.01
    assert "shared_attn" in dict(model.named_children())
