"""The port's multi-head latent attention against the JAX package's, on the
CPU.

``mla_attention`` on the deepseek-v2 smoke config (low-rank queries) and
a variant with full-rank queries (``q_lora_rank = 0``, the ``w_q`` path),
float32, JAX weights carried over through ``repro_torch.bridge``:

* the expanded form (no cache) against JAX's;
* the absorbed form against a latent cache at mixed per-slot offsets, one
  of them at the cache's end (the write start clamps, as
  ``dynamic_update_slice`` clamps it), for 1 and 3 new tokens: the output,
  and the cache the port wrote in place against JAX's new cache;
* the engine's prompt pass (the absorbed form against the prompt's own
  latents) against JAX's absorbed form on an empty cache.

Tolerance 1e-5 abs and rel (float32 summation order).
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
import repro.models.mla as JMLA  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.mla as TMLA  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

TOL = 1e-5
VARIANTS = ["q_lora", "full_rank_q"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _cfgs(variant):
    jcfg = dataclasses.replace(JC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    tcfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    if variant == "full_rank_q":
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    return jcfg, tcfg


def _attn(variant):
    """(JAX cfg, JAX layer-0 attention params, port cfg, port layer-0 attn)."""
    if variant not in _MODELS:
        jcfg, tcfg = _cfgs(variant)
        params, _ = JT.init_model(jax.random.key(1), jcfg)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
        _MODELS[variant] = (jcfg, jp, tcfg, model.layers[0]["attn"])
    return _MODELS[variant]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_expanded_form_matches_jax(variant):
    jcfg, jp, tcfg, tp = _attn(variant)
    B, S = 2, 12
    x = np.random.default_rng(0).standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    positions = np.broadcast_to(np.arange(S), (B, S))
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions))
    with torch.no_grad():
        got, (c_kv, k_rope) = TMLA.mla_attention(
            tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(positions.copy()))
    _close(got, want)
    assert c_kv.shape == (B, S, jcfg.mla.kv_lora_rank)
    assert k_rope.shape == (B, S, jcfg.mla.qk_rope_head_dim)


@pytest.mark.parametrize("S_new", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
def test_absorbed_form_against_the_latent_cache(variant, S_new):
    """Slots at offsets 3, 20, 0 and 31 of a 32-entry cache (the last one's
    write clamps to the cache's end, and its validity bound passes it)."""
    jcfg, jp, tcfg, tp = _attn(variant)
    rng = np.random.default_rng(S_new)
    B, T = 4, 32
    m = jcfg.mla
    ckv = rng.standard_normal((B, T, m.kv_lora_rank), dtype=np.float32)
    krope = rng.standard_normal((B, T, m.qk_rope_head_dim), dtype=np.float32)
    pos = np.array([3, 20, 0, 31])
    x = rng.standard_normal((B, S_new, jcfg.d_model), dtype=np.float32)
    positions = pos[:, None] + np.arange(S_new)[None, :]
    jcache = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope),
              "pos": jnp.asarray(pos, jnp.int32)}
    want, wcache = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                      positions=jnp.asarray(positions, jnp.int32), cache=jcache)
    tcache = {"ckv": torch.from_numpy(ckv.copy()), "krope": torch.from_numpy(krope.copy()),
              "pos": torch.from_numpy(pos.copy())}
    store = tcache["ckv"]
    with torch.no_grad():
        got, _ = TMLA.mla_attention(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(positions), cache=tcache)
    _close(got, want)
    assert tcache["ckv"] is store                               # written in place
    _close(tcache["ckv"], wcache["ckv"])
    _close(tcache["krope"], wcache["krope"])
    assert tcache["pos"].tolist() == pos.tolist()               # the caller advances it


@pytest.mark.parametrize("variant", VARIANTS)
def test_prompt_pass_is_the_absorbed_form_on_an_empty_cache(variant):
    """What the engine's prefill computes: JAX's absorbed form against a
    one-slot cache at ``pos = 0`` (whose stale entries past the prompt are
    masked) equals the port's absorbed form against the prompt's own
    latents."""
    jcfg, jp, tcfg, tp = _attn(variant)
    rng = np.random.default_rng(5)
    S, T = 10, 24
    x = rng.standard_normal((1, S, jcfg.d_model), dtype=np.float32)
    positions = np.arange(S)[None, :]
    stale = {"ckv": jnp.asarray(rng.standard_normal((1, T, jcfg.mla.kv_lora_rank),
                                                    dtype=np.float32)),
             "krope": jnp.asarray(rng.standard_normal((1, T, jcfg.mla.qk_rope_head_dim),
                                                      dtype=np.float32)),
             "pos": jnp.zeros((1,), jnp.int32)}
    want, wcache = JMLA.mla_attention(jp, jnp.asarray(x), jcfg,
                                      positions=jnp.asarray(positions, jnp.int32), cache=stale)
    with torch.no_grad():
        got, (c_kv, k_rope) = TMLA.mla_prefill(tp, torch.from_numpy(x), tcfg,
                                               positions=torch.from_numpy(positions))
    _close(got, want)
    _close(c_kv, np.asarray(wcache["ckv"])[:, :S])
    _close(k_rope, np.asarray(wcache["krope"])[:, :S])


def test_leaf_shapes_match_jax():
    for variant in VARIANTS:
        jcfg, jp, tcfg, tp = _attn(variant)
        shapes = TMLA.mla_shapes(tcfg)
        assert set(shapes) == set(jp)
        for name, shape in shapes.items():
            assert tuple(jp[name].shape) == shape == tuple(tp[name].shape)
        assert tp["kv_norm_scale"].dtype == torch.float32
