"""The port's MoE FFN against the JAX package's, on the CPU.

``apply_moe`` on the arctic and deepseek-v2 smoke configs (Arctic: 4
experts top-2 beside a dense branch; DeepSeek-V2: 4 experts top-2 and one
shared expert), with the JAX weights carried over through
``repro_torch.bridge`` and numpy-seeded inputs: dropless (N <= 64), with
tokens dropped (N > 64), and at N = 68, whose capacity 42.5 rounds half to
even.  Output and aux loss within atol = rtol = 1e-5 of JAX at float32,
except three cases (``CANCELLING``) where a few entries are sums of terms
up to |719| that cancel, and the two packages sum in another order: there
atol is 1e-6 of max |ref|.  Measured on the CPU: arctic N = 200 worst
|diff| 5.2e-4 (46 of 25600 entries over 1e-5 + 1e-5·|ref|, the worst at
|ref| 1.26, max |ref| 719), deepseek N = 64 3.4e-5 (2 of 8192, the worst
at |ref| 0.073, max |ref| 105), deepseek N = 200 5.2e-4 (65 of 25600, the
worst at |ref| 4.98, max |ref| 647).  In every case both packages are
also held within rtol 1e-5, atol 1e-6 of max |ref| of a float64
evaluation (``_f64_moe``): JAX's own float32 output is up to 5.8e-4 from
it.  bf16 within a stated tolerance.  The expert GEMMs go through
``stream_pack``, whose CPU path is B2's plain version.
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
import repro.models.moe as JM  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.moe as TM  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

ARCHS = ["arctic-480b", "deepseek-v2-236b"]
TOL = 1e-5
# (arch, N) whose float32 outputs differ from JAX's by more than 1e-5 in
# entries that cancel (see the module docstring)
CANCELLING = {("arctic-480b", 200), ("deepseek-v2-236b", 64), ("deepseek-v2-236b", 200)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _model(arch, dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port model) with one set of weights
    (JAX's, cast to ``dtype``)."""
    if (arch, dtype) not in _MODELS:
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype=dtype)
        tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype=dtype)
        params, _ = JT.init_model(jax.random.key(0), jcfg)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        _MODELS[arch, dtype] = (jcfg, params, tcfg, params_from_jax(np_tree, tcfg, device="cpu"))
    return _MODELS[arch, dtype]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _f64_moe(p, x, cfg):
    """The MoE FFN in float64 numpy, token by token: the same routing,
    capacity and keep order as ``moe.py``, with nothing batched."""
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), p)
    m, xf = cfg.moe, x.reshape(-1, cfg.d_model).astype(np.float64)
    N, E, K = xf.shape[0], m.num_experts, m.top_k
    logits = xf @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    gates = np.take_along_axis(probs, ids, -1)
    gates /= np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    silu = lambda z: z / (1 + np.exp(-z))  # noqa: E731
    out, filled, cap = np.zeros_like(xf), np.zeros(E, int), TM.capacity(N, cfg)
    for i, e in enumerate(ids.reshape(-1)):          # token-major, as the stable sort
        if filled[e] < cap:
            t = i // K
            h = silu(xf[t] @ p["w_gate"][e]) * (xf[t] @ p["w_up"][e])
            out[t] += gates[t, i % K] * (h @ p["w_down"][e])
        filled[e] += 1
    if "shared" in p:
        sh = p["shared"]
        out += (silu(xf @ sh["w_gate"]) * (xf @ sh["w_up"])) @ sh["w_down"]
    return out.reshape(x.shape)


def _layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"])


def _routed_counts(model, x, cfg):
    """Tokens routed to each expert (the port's router on ``x``)."""
    probs = torch.softmax(x.reshape(-1, cfg.d_model).float() @ model.layers[0]["moe"]["router"], -1)
    ids = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    return torch.bincount(ids.reshape(-1), minlength=cfg.moe.num_experts)


@pytest.mark.parametrize("N", [8, 64, 68, 200])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, N):
    """N = 8 and 64 run dropless (capacity N); N = 68 and 200 take the
    capacity factor and overflow an expert (at 200 the tokens share a
    common direction, so the router sends most to the same experts):
    dropped tokens keep only their other experts' share."""
    jcfg, params, tcfg, model = _model(arch)
    rng = np.random.default_rng(N)
    x = rng.standard_normal((1, N, jcfg.d_model), dtype=np.float32)
    if N == 200:
        x += 3 * rng.standard_normal(jcfg.d_model, dtype=np.float32)
    want, waux = jax.jit(JM.apply_moe, static_argnums=2)(_layer0(params)["moe"], jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = TM.apply_moe(model.layers[0]["moe"], torch.from_numpy(x), tcfg)
    assert got.shape == (1, N, jcfg.d_model) and got.dtype == torch.float32
    got, want = got.numpy(), np.asarray(want)
    rounding = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=rounding if (arch, N) in CANCELLING else TOL)
    exact = _f64_moe(_layer0(params)["moe"], x, jcfg)
    for out in (got, want):        # both packages round, by as much
        np.testing.assert_allclose(out, exact, rtol=TOL, atol=rounding)
    _close(float(aux), float(waux))
    cap = TM.capacity(N, tcfg)
    assert cap == (N if N <= 64 else {68: 42, 200: 125}[N])
    if N > 64:
        assert int(_routed_counts(model, torch.from_numpy(x), tcfg).max()) > cap


def test_capacity_rounds_half_to_even():
    """The capacities the served path gives B2 (M of the expert GEMMs):
    4 decode slots and the prefill buckets 64..512 at full width, and
    arctic-smoke at N = 68 (42.5 rounds to 42)."""
    arctic, deepseek = TC.get("arctic-480b"), TC.get("deepseek-v2-236b")
    assert [TM.capacity(n, arctic) for n in (4, 64, 128, 256, 512)] == [4, 64, 2, 5, 10]
    assert [TM.capacity(n, deepseek) for n in (4, 64, 128, 256, 512)] == [4, 64, 6, 12, 24]
    assert TM.capacity(68, TC.get("arctic-480b", smoke=True)) == 42
    assert TM.capacity(65, arctic) == 2          # max(K, round(1.27))


def test_expert_operand_is_a_view_of_the_buffer(monkeypatch):
    """B2's x operand is the first E·cap rows of the (E·cap + 1, D) buffer
    viewed as (E, cap, D): contiguous with lane stride cap·D, so
    ``ops.stream_pack`` hands it to the kernel without a copy."""
    jcfg, params, tcfg, model = _model("arctic-480b")
    seen = []

    def spy(x, w):
        seen.append((tuple(x.shape), x.stride(), x.is_contiguous(), x._base is not None))
        return torch.matmul(x, w)

    monkeypatch.setattr(TM, "stream_pack", spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 100, 128), dtype=np.float32))
    TM.apply_moe(model.layers[0]["moe"], x, tcfg)
    E, cap, D = 4, TM.capacity(100, tcfg), 128
    assert len(seen) == 3
    assert seen[0] == ((E, cap, D), (cap * D, D, 1), True, True)      # gate: buffer view
    assert seen[1] == seen[0]                                           # up: the same
    assert seen[2][0] == (E, cap, tcfg.moe.d_ff_expert) and seen[2][2]


# bf16: atol as a share of the output's largest magnitude, and rtol.  Both
# packages multiply bf16 operands with float32 sums, but XLA fuses the
# elementwise work (activation, gate product, gate weighting, combine) and
# keeps it in float32, where the port rounds each step to bf16; an output
# that is the sum of terms near the largest magnitude then differs by a few
# bf16 ulps of that magnitude (one ulp is 2**-8 relative).  Measured: at
# most 0.25 at max |ref| 33 (0.0076 of it).
BF16_TOL = (2**-6, 2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_bf16(arch):
    jcfg, params, tcfg, model = _model(arch, "bfloat16")
    x = np.random.default_rng(3).standard_normal((2, 40, jcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, _ = jax.jit(JM.apply_moe, static_argnums=2)(_layer0(params)["moe"], jx, jcfg)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got, _ = TM.apply_moe(model.layers[0]["moe"], tx, tcfg)
    assert got.dtype == torch.bfloat16
    share, rtol = BF16_TOL
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=share * float(np.abs(want).max()))


def test_bf16_combine_is_repeatable():
    """The combine sums each token's K contributions in order (no atomics):
    two calls give the same bits."""
    _, _, tcfg, model = _model("deepseek-v2-236b", "bfloat16")
    x = torch.randn((1, 90, 128), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    with torch.no_grad():
        a, _ = TM.apply_moe(model.layers[0]["moe"], x, tcfg)
        b, _ = TM.apply_moe(model.layers[0]["moe"], x, tcfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_module_layout_matches_jax_tree(arch):
    """The module's MoE leaves carry the JAX names, shapes and dtypes:
    router float32, experts in the model dtype, DeepSeek's ``shared``
    nested, Arctic's dense ``ffn`` beside ``moe``."""
    jcfg, params, tcfg, model = _model(arch)
    lp = model.layers[0]
    jl = _layer0(params)
    for name, shape in TM.moe_shapes(tcfg).items():
        leaf = jl["moe"]
        for part in name.split("."):
            leaf = leaf[part]
        assert tuple(leaf.shape) == shape
    assert lp["moe"]["router"].dtype == torch.float32
    assert ("shared" in lp["moe"]) == (arch == "deepseek-v2-236b")
    assert ("ffn" in lp) == (arch == "arctic-480b")


@pytest.mark.parametrize("leaf", ["moe.w_up", "moe.shared.w_down"])
def test_bridge_refuses_a_missing_or_misshaped_moe_leaf(leaf):
    jcfg, params, tcfg, _ = _model("deepseek-v2-236b")
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    layers = jax.tree_util.tree_map(lambda a: a, np_tree["layers"])
    *path, name = leaf.split(".")
    node = layers
    for part in path:
        node[part] = dict(node[part])
        node = node[part]
    kept = node.pop(name)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(dict(np_tree, layers=layers), tcfg, device="cpu")
    node[name] = kept[..., :-1]                       # one column short
    with pytest.raises(ValueError, match="JAX shape"):
        params_from_jax(dict(np_tree, layers=layers), tcfg, device="cpu")


def test_init_model_draws_moe_in_chunks(monkeypatch):
    """The port's initialiser at the JAX initialiser's distributions:
    router and experts at 1/sqrt(fan-in) (axis 0, ``w_down``'s axis 1, as
    ``dense_init(in_axis=1)``), ``kv_norm_scale`` at 1, drawn in chunks of
    the leading axis when a tensor passes INIT_CHUNK elements."""
    monkeypatch.setattr(TT, "INIT_CHUNK", 5000)          # several chunks per tensor
    cfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    model = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    moe, attn = model.layers[0]["moe"], model.layers[0]["attn"]
    E, D, F = moe["w_gate"].shape
    assert abs(float(moe["w_gate"].std()) - E ** -0.5) < 0.02
    assert abs(float(moe["w_down"].std()) - F ** -0.5) < 0.01
    assert abs(float(moe["router"].std()) - D ** -0.5) < 0.01
    assert torch.equal(attn["kv_norm_scale"], torch.ones(cfg.mla.kv_lora_rank))
    # chunks are independent draws, not one chunk repeated
    w = moe["w_gate"].reshape(E, -1)
    assert not torch.equal(w[0], w[1])
    with torch.no_grad():
        logits = model(torch.zeros((1, 5), dtype=torch.long))
    assert torch.isfinite(logits).all()
