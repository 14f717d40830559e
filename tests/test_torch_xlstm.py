"""The port's ssm family (xLSTM: mLSTM and sLSTM cells) against the JAX
package's, on the CPU.

``mlstm_block`` chunked-parallel (several chunk lengths, with and without
an incoming state) and recurrent, and ``slstm_block`` (with and without a
state), each within 1e-5 and writing a given state in place; ``forward``
logits within 1e-4; teacher-forced ``decode_step`` equal to ``forward``
within 1e-4; ``decode_step`` against JAX's over several steps, with every
leaf of the per-layer list cache; the cache's layout; bf16 logits within
``BF16_LOGITS_TOL``; the mLSTM's running max (``_RunningMax``, whose
gradient is summed per run, deterministically) against ``torch.cummax``.  Weights come from JAX through
``bridge.params_from_jax`` (xLSTM's layers are a Python list there) and
inputs from a numpy seed.  Tolerances are float32 summation order.
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
import repro.models.xlstm as JX  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
import repro_torch.models.xlstm as TX  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

ARCH = "xlstm-125m"
TOL = 1e-4
BLOCK_TOL = 1e-5
# bf16 logits (atol, rtol): both packages round activations and layer
# outputs to bf16; XLA fuses the cells' elementwise chains and rounds once
# where the port rounds each step.  Measured over seeds 0, 1, 7: at most
# 0.047 at |logits| <= 4.4 (atol 0.032 needed at rtol 0.02).
BF16_LOGITS_TOL = (5e-2, 2e-2)


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
        jcfg = dataclasses.replace(jcfg, xlstm=dataclasses.replace(jcfg.xlstm, mlstm_chunk=chunk))
        tcfg = dataclasses.replace(tcfg, xlstm=dataclasses.replace(tcfg.xlstm, mlstm_chunk=chunk))
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


def _cell(kind):
    """The JAX and port parameters of the smoke config's first cell of
    ``kind`` (sLSTM sits at layer 1)."""
    jcfg, params, tcfg, model = _model()
    i = next(i for i in range(tcfg.n_layers) if TT._xlstm_kind(tcfg, i) == kind)
    return params["layers"][i]["cell"], model.layers[i]["cell"]


def _state(kind, B, rng, tcfg):
    """A random incoming state of ``kind`` (numpy), m kept moderate."""
    H, d = tcfg.n_heads, tcfg.d_model
    if kind == "slstm":
        shapes = {"c": (B, d), "n": (B, d), "m": (B, d), "h": (B, d)}
    else:
        hd = int(d * tcfg.xlstm.proj_factor) // H
        shapes = {"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}
    st = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    st["n"] = np.abs(st["n"]) + 1.0
    return st


def _run_pair(kind, S, chunk=None, with_state=False, seed=0):
    jcfg, tcfg = _cfgs(chunk=chunk)
    jp, tp = _cell(kind)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, tcfg.d_model), dtype=np.float32)
    jblock, tblock = (JX.slstm_block, TX.slstm_block) if kind == "slstm" else \
        (JX.mlstm_block, TX.mlstm_block)
    st = _state(kind, 2, rng, tcfg) if with_state else None
    want, wstate = jblock(jp, jnp.asarray(x), jcfg,
                          cache=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    tcache = None if st is None else {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    stores = dict(tcache or {})
    with torch.no_grad():
        got, tstate = tblock(tp, torch.from_numpy(x), tcfg, cache=tcache)
    _close(got, want, BLOCK_TOL)
    assert set(tstate) == set(wstate)
    for k in wstate:
        _close(tstate[k], wstate[k], BLOCK_TOL)
    if tcache is not None:
        assert tstate is tcache and all(tcache[k] is stores[k] for k in stores)   # in place


@pytest.mark.parametrize("S,chunk", [(16, 64), (24, 8), (20, 8), (1, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_block_matches_jax(S, chunk, with_state):
    """Chunked-parallel for S > 1 (chunk 8 halved to 4 at S = 20, as in
    JAX), the recurrence for one token."""
    _run_pair("mlstm", S, chunk=chunk, with_state=with_state, seed=S)


@pytest.mark.parametrize("S", [1, 12])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_matches_jax(S, with_state):
    _run_pair("slstm", S, with_state=with_state, seed=S + 1)


@pytest.mark.parametrize("S", [16, 24])
def test_forward_logits(S):
    jcfg, params, tcfg, model = _model()
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S))
    want, _ = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, S, jcfg.padded_vocab)
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


def test_init_cache_layout_matches_jax():
    jcfg, _, tcfg, _ = _model()
    want = JT.init_cache(jcfg, 3, 8)
    got = TT.init_cache(tcfg, 3, 8, device="cpu")
    assert len(got["layers"]) == len(want["layers"]) == tcfg.n_layers
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape
            np.testing.assert_array_equal(g[k].float().numpy(), np.asarray(w[k], np.float32))


def test_decode_step_matches_jax_over_steps():
    """Five greedy steps from a random state: logits and every leaf of the
    per-layer cache held to JAX's new cache, updated in place."""
    jcfg, params, tcfg, model = _model()
    rng = np.random.default_rng(6)
    B = 3
    states = [_state(TT._xlstm_kind(tcfg, i), B, rng, tcfg) for i in range(tcfg.n_layers)]
    jcache = {"layers": [{k: jnp.asarray(v) for k, v in st.items()} for st in states],
              "pos": jnp.asarray([0, 4, 7], jnp.int32)}
    tcache = TT.init_cache(tcfg, B, 8, device="cpu")
    for layer, st in zip(tcache["layers"], states):
        for k, v in st.items():
            layer[k].copy_(torch.from_numpy(v))
    tcache["pos"].copy_(torch.tensor([0, 4, 7]))
    stores = [dict(layer) for layer in tcache["layers"]]
    toks = rng.integers(0, jcfg.vocab, (B, 1))
    for _ in range(5):
        want, jcache = JT.decode_step(params, jcache, jnp.asarray(toks), jcfg)
        with torch.no_grad():
            got, out = TT.decode_step(model, tcache, torch.from_numpy(toks), tcfg)
        assert out is tcache
        _close(got, want)
        for layer, wl, st in zip(tcache["layers"], jcache["layers"], stores):
            for k in wl:
                assert layer[k] is st[k]
                _close(layer[k], wl[k])
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        toks = np.array(jnp.argmax(want[:, :, : jcfg.vocab], axis=-1))


def test_bf16_logits_match_jax():
    jcfg, params, tcfg, model = _model("bfloat16")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 16))
    want, _ = jax.jit(JT.forward, static_argnums=2)(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, _ = TT.forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    cell = model.layers[0]["cell"]
    assert cell["w_up"].dtype == torch.bfloat16 and cell["w_if"].dtype == torch.float32
    atol, rtol = BF16_LOGITS_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_init_model_gate_biases():
    """The port's own initialiser: mLSTM forget-gate biases at 3, input at
    0; sLSTM's f block at 3, the rest 0; as ``init_mlstm``/``init_slstm``."""
    _, tcfg = _cfgs()
    model = TT.init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    H, d = tcfg.n_heads, tcfg.d_model
    m = model.layers[0]["cell"]["b_if"]
    assert torch.equal(m, torch.cat([torch.zeros(H), torch.full((H,), 3.0)]))
    s = model.layers[1]["cell"]["b_gates"]
    assert torch.equal(s, torch.cat([torch.zeros(d), torch.full((d,), 3.0), torch.zeros(2 * d)]))


@pytest.mark.parametrize("S", [37, 4096])
def test_running_max_gradient_is_cummaxs(S):
    """The mLSTM's running max (``_RunningMax``) gives ``torch.cummax``'s
    values and its gradient, summed per run in float64 where cummax's
    backward adds float32 atomics (``scatter_add``): within float32's
    rounding of cummax's gradient taken in float64; runs of equal values
    (ties) included.  Each call gives the same bits."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((2, S, 3)).astype(np.float32))
    g[:, 5:9] = g[:, 4:5]                                  # a tie of five
    w = torch.from_numpy(rng.standard_normal((2, S, 3)).astype(np.float32))
    want_g, got_g = g.double().requires_grad_(), g.clone().requires_grad_()
    want = torch.cummax(want_g, dim=1).values
    got = TX._RunningMax.apply(got_g)
    assert torch.equal(got, want.float())
    (want * w.double()).sum().backward()
    (got * w).sum().backward()
    np.testing.assert_allclose(got_g.grad.numpy(), want_g.grad.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want_g.grad.abs().max()))
    again = g.clone().requires_grad_()
    (TX._RunningMax.apply(again) * w).sum().backward()
    assert torch.equal(again.grad, got_g.grad)
