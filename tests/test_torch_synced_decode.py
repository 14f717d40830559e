"""The synchronized batch decode of the port against the JAX package's, on
the CPU.

``init_cache(per_slot=False)`` (one 0-d write offset for the whole batch)
and ``cache_axes`` equal JAX's for the six families, leaf by leaf.  Then,
for a smoke config of each family at float32 (dense phi4-mini and
gemma2, MoE arctic and deepseek-v2's MLA, vlm, hybrid, ssm, audio) with
the JAX weights carried over through ``bridge.params_from_jax``,
``decode_step`` on a ``per_slot=False`` cache filled from a numpy seed
matches JAX's ``decode_step`` over four steps: logits and every cache leaf
within 1e-5 (float32 summation order), the port's cache updated in place.
JAX's ssm step returns ``pos`` broadcast to ``(B,)`` (``pos + 1`` of the
broadcast offsets), the port's stays 0-d: they are compared broadcast.
Last, the synchronized step gives the per-slot step's logits and cache,
bit for bit, with every slot at the same offset.
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

FAMILY_ARCHS = {"dense": "phi4-mini-3.8b", "moe": "deepseek-v2-236b", "vlm": "llava-next-34b",
                "hybrid": "zamba2-2.7b", "ssm": "xlstm-125m", "audio": "seamless-m4t-medium"}
DECODE_ARCHS = ["phi4-mini-3.8b", "gemma2-27b", "arctic-480b", "deepseek-v2-236b",
                "llava-next-34b", "zamba2-2.7b", "xlstm-125m", "seamless-m4t-medium"]
TOL = 1e-5
B, T, MEM, START, STEPS = 3, 16, 5, 4, 4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return (dataclasses.replace(JC.get(arch, smoke=True), dtype="float32"),
            dataclasses.replace(TC.get(arch, smoke=True), dtype="float32"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _memory(jcfg):
    return MEM if jcfg.family == "audio" else 0


@pytest.mark.parametrize("family", FAMILY_ARCHS)
def test_init_cache_and_axes_equal_jax(family):
    jcfg, tcfg = _cfgs(FAMILY_ARCHS[family])
    for per_slot in (False, True):
        want = dict(_leaves(JT.init_cache(jcfg, B, T, memory_len=_memory(jcfg),
                                          per_slot=per_slot)))
        got = dict(_leaves(TT.init_cache(tcfg, B, T, memory_len=_memory(jcfg),
                                         per_slot=per_slot, device="cpu")))
        assert list(got) == list(want)
        for name, a in want.items():
            t = got[name]
            assert tuple(t.shape) == tuple(a.shape), name
            want_dtype = torch.int64 if a.dtype == jnp.int32 else getattr(torch, str(a.dtype))
            assert t.dtype == want_dtype, name
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        assert got["pos"].dim() == (1 if per_slot else 0)
        assert dict(_leaves(TT.cache_axes(tcfg, per_slot=per_slot))) == \
            dict(_leaves(JT.cache_axes(jcfg, per_slot=per_slot)))


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        params, _ = JT.init_model(jax.random.key(0), jcfg)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        _MODELS[arch] = (jcfg, params, tcfg, model)
    return _MODELS[arch]


def _filled_caches(jcfg, tcfg, seed):
    """The same random state in a JAX ``per_slot=False`` cache and the
    port's, ``pos`` at START."""
    rng = np.random.default_rng(seed)
    jcache = JT.init_cache(jcfg, B, T, memory_len=_memory(jcfg), per_slot=False)
    tcache = TT.init_cache(tcfg, B, T, memory_len=_memory(jcfg), per_slot=False, device="cpu")
    jleaves, treedef = jax.tree_util.tree_flatten(jcache)
    # JAX flattens dicts by sorted key, as _leaves does
    tleaves = [t for _, t in _leaves(tcache)]
    filled = []
    for a, t in zip(jleaves, tleaves, strict=True):
        v = np.full(a.shape, START) if a.ndim == 0 else \
            (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        filled.append(jnp.asarray(v, a.dtype))
        t.copy_(torch.from_numpy(np.asarray(v)).to(t.dtype))
    return jax.tree_util.tree_unflatten(treedef, filled), tcache


def _close(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    np.testing.assert_allclose(np.broadcast_to(got, want.shape), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_synced_decode_matches_jax(arch):
    jcfg, params, tcfg, model = _model(arch)
    jcache, tcache = _filled_caches(jcfg, tcfg, seed=1)
    ptrs = {name: t.data_ptr() for name, t in _leaves(tcache)}
    rng = np.random.default_rng(2)
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab, (B, 1))
        jlogits, jcache = JT.decode_step(params, jcache, jnp.asarray(tok, jnp.int32), jcfg)
        with torch.no_grad():
            tlogits, out = TT.decode_step(model, tcache, torch.from_numpy(tok), tcfg)
        assert out is tcache
        _close(tlogits, jlogits)
        want = dict(_leaves(jcache))
        for name, t in _leaves(tcache):
            _close(t, want[name])
    assert tcache["pos"].dim() == 0 and int(tcache["pos"]) == START + STEPS
    assert {name: t.data_ptr() for name, t in _leaves(tcache)} == ptrs      # in place


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-236b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_synced_step_equals_per_slot_step(arch):
    jcfg, _, tcfg, model = _model(arch)
    _, synced = _filled_caches(jcfg, tcfg, seed=3)
    per_slot = {k: v for k, v in TT.init_cache(tcfg, B, T, memory_len=_memory(jcfg),
                                               device="cpu").items()}
    for (_, dst), (_, src) in zip(_leaves(per_slot), _leaves(synced), strict=True):
        dst.copy_(src.expand(dst.shape))
    rng = np.random.default_rng(4)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, jcfg.vocab, (B, 1)))
        with torch.no_grad():
            a, _ = TT.decode_step(model, synced, tok, tcfg)
            b, _ = TT.decode_step(model, per_slot, tok, tcfg)
        assert torch.equal(a, b)
        for (name, x), (_, y) in zip(_leaves(synced), _leaves(per_slot), strict=True):
            assert torch.equal(x.expand(y.shape), y), name
