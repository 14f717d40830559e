"""Expanded attention (B7): the plain versions against the JAX package's
expanded MLA, and the routing, on the CPU.

* ``repro.models.mla.mla_attention`` with no cache (the expanded form) on
  the deepseek-v2 smoke config, both query variants, JAX weights carried
  over through ``repro_torch.bridge``, the same numpy inputs: the port's
  layer (whose attention now goes through B7's wrapper) at float32 within
  1e-5 and at bf16 within ``BF16_TOL``; a q_pos that is not arange (rows
  whose every key is masked among them);
* the LSE B7's forward writes against ``logsumexp`` of JAX's masked logits;
* the gradients of x and of every MLA parameter through
  :class:`ExpandedAttention` against ``jax.grad``, each divided by its
  largest magnitude, within rtol 1e-4 and atol 1e-5;
* the five plain gradients against autograd through the plain arithmetic
  the expanded core ran before B7;
* the routing: CPU and meta tensors through ``run_plain`` (forward and
  backward each one launch), a ``DTensor`` refused, widths out of the
  contract refused on the CPU, the plans and shared memory against their
  formulas, the model's layouts read in place and an unreadable one copied
  once and counted, a failed launch that raises and never falls back;
* the dry run's meta train step of deepseek-v2 smoke on a fake (2, 2)
  mesh: B7 once forward and once backward a layer, and no (B, N, S, S)
  storage;
* phase 3d's case list in ``chip_smoke.py``.
"""

import dataclasses
import math
import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.models.mla as JMLA  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.mla as TMLA  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels import KERNEL_MODULES, plain_watchers, readable  # noqa: E402
from repro_torch.kernels.expanded_attention import (  # noqa: E402
    ExpandedAttention, backward, expanded_attention, expanded_attention_bwd_ref,
    expanded_attention_ref, kernel, ops)

TOL = 1e-5
# bf16 layer against JAX's bf16 layer: both round q, k, v, the probabilities
# and the output to bf16 at the same points, but their products sum in other
# orders and round at other places (XLA fuses), so an element may differ by
# a few bf16 ulps of the layer's output: 2**-6 of the output's largest
# magnitude plus 2**-6 relative (one ulp is 2**-8 relative)
BF16_TOL = (2.0 ** -6, 2.0 ** -6)
VARIANTS = ["q_lora", "full_rank_q"]
SMOKE = (32, 16, 32)          # deepseek-v2 smoke's nope, rope and v widths
DEEPSEEK = (128, 64, 128)     # deepseek-v2-236b's


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _attn(variant, dtype="float32"):
    """(JAX cfg, JAX layer-0 attention params, port cfg, port layer-0 attn)."""
    key = (variant, dtype)
    if key not in _MODELS:
        jcfg = dataclasses.replace(JC.get("deepseek-v2-236b", smoke=True), dtype=dtype)
        tcfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype=dtype)
        if variant == "full_rank_q":
            jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
            tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
        params, _ = JT.init_model(jax.random.key(1), jcfg)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
        _MODELS[key] = (jcfg, jp, tcfg, model.layers[0]["attn"])
    return _MODELS[key]


def _x(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model), dtype=np.float32)


def _positions(kind, B, S):
    if kind == "arange":
        pos = np.arange(S)
    else:                     # a permutation with repeats, negatives (rows that see no key), past S
        pos = np.array([3, -1, 0, 5, 11, 2, 2, 7, -3, 20, 9, 1][:S])
    return np.ascontiguousarray(np.broadcast_to(pos, (B, S)))


def _to_np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["arange", "mixed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_expanded_layer_matches_jax_at_float32(variant, kind):
    jcfg, jp, tcfg, tp = _attn(variant)
    x, positions = _x(jcfg), _positions(kind, 2, 12)
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions))
    with torch.no_grad():
        got, _ = TMLA.mla_attention(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(positions))
    np.testing.assert_allclose(_to_np(got), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_expanded_layer_matches_jax_at_bf16(variant):
    jcfg, jp, tcfg, tp = _attn(variant, "bfloat16")
    x, positions = _x(jcfg), _positions("arange", 2, 12)
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                 positions=jnp.asarray(positions))
    with torch.no_grad():
        got, _ = TMLA.mla_attention(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg,
                                    positions=torch.from_numpy(positions))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    atol, rtol = BF16_TOL
    np.testing.assert_allclose(_to_np(got), want, rtol=rtol, atol=atol * np.abs(want).max())


def _jax_projections(jp, jcfg, x, positions):
    """JAX's q_nope, q_rope, k_nope, k_rope, v and q_pos of the expanded form."""
    q_nope, q_rope, c_kv, k_rope = JMLA._project_latents(jp, jnp.asarray(x), jcfg,
                                                         jnp.asarray(positions))
    k_nope = jnp.einsum("btr,rnh->btnh", c_kv, jp["w_uk"])
    v = jnp.einsum("btr,rnh->btnh", c_kv, jp["w_uv"])
    return q_nope, q_rope, k_nope, k_rope, v, jnp.asarray(positions[0])


@pytest.mark.parametrize("kind", ["arange", "mixed"])
def test_the_lse_is_logsumexp_of_jax_masked_logits(kind):
    """B7's forward writes each row's log-sum-exp for its backward; the
    plain version's (which the CPU runs in its place) is JAX's logits'
    ``logsumexp`` over the masked keys (a row that sees no key: -1e30 +
    log T, which rounds to -1e30)."""
    jcfg, jp, tcfg, _ = _attn("q_lora")
    x, positions = _x(jcfg), _positions(kind, 2, 12)
    qn, qr, kn, kr, v, q_pos = _jax_projections(jp, jcfg, x, positions)
    scale = 1.0 / math.sqrt(jcfg.mla.qk_nope_head_dim + jcfg.mla.qk_rope_head_dim)
    logits = (jnp.einsum("bsnh,btnh->bnst", qn, kn) + jnp.einsum("bsnh,bth->bnst", qr, kr)) * scale
    mask = q_pos[:, None] >= jnp.arange(kn.shape[1])[None, :]
    want = jax.nn.logsumexp(jnp.where(mask[None, None], logits, -1e30), axis=-1)
    ten = [torch.from_numpy(np.array(a)) for a in (qn, qr, kn, kr, v, q_pos)]
    _, lse = ExpandedAttention.apply(*ten, scale)
    assert lse.shape == (2, jcfg.n_heads, 12) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _mla_params(tp):
    return dict(tp.named_parameters())


@pytest.mark.parametrize("kind", ["arange", "mixed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_gradients_match_jax_grad(variant, kind):
    """d x and d of every MLA parameter of ``sum(y * g)`` through the port's
    layer (its attention through :class:`ExpandedAttention`, whose backward
    is the plain backward on the CPU) against ``jax.grad``, each divided by
    its largest magnitude."""
    jcfg, jp, tcfg, tp = _attn(variant)
    x, positions = _x(jcfg, seed=1), _positions(kind, 2, 12)
    g = np.random.default_rng(2).standard_normal((2, 12, jcfg.d_model), dtype=np.float32)

    def loss(p, xx):
        y, _ = JMLA.mla_attention(p, xx, jcfg, positions=jnp.asarray(positions))
        return jnp.sum(y * g)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    params = _mla_params(tp)
    was = {name: p.requires_grad for name, p in params.items()}
    for p in params.values():
        p.grad = None
        p.requires_grad_(True)
    seen = []
    inner = ops.ExpandedAttention.backward

    def counting(ctx, *grads):
        seen.append(1)
        return inner(ctx, *grads)

    y, _ = TMLA.mla_attention(tp, xt, tcfg, positions=torch.from_numpy(positions))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops.ExpandedAttention, "backward", staticmethod(counting))
            (y * torch.from_numpy(g)).sum().backward()
    finally:
        for name, p in params.items():
            p.requires_grad_(was[name])
    assert seen == [1]

    def close(got, want, name):
        want = np.asarray(want, np.float32)
        top = np.abs(want).max()
        assert top > 0, name
        np.testing.assert_allclose(_to_np(got) / top, want / top, rtol=1e-4, atol=1e-5,
                                   err_msg=name)

    close(xt.grad, want_x, "x")
    assert sorted(params) == sorted(want_p)
    for name, p in params.items():
        close(p.grad, want_p[name], name)


def _old_expanded_core(q_nope, q_rope, k_nope, k_rope, v, q_pos, *, scale):
    """The expanded core's arithmetic before B7 (``models/mla.py``)."""
    logits = (
        torch.einsum("bsnh,btnh->bnst", q_nope.float(), k_nope.float())
        + torch.einsum("bsnh,bth->bnst", q_rope.float(), k_rope.float())
    ) * scale
    mask = q_pos[:, None] >= torch.arange(q_nope.shape[1], device=q_pos.device)[None, :]
    probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    return torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype), v)


def _inputs(widths, B=2, S=70, N=3, kind="arange", seed=0, dtype=torch.float32):
    """q_nope and q_rope as the split views of one query, k_rope the [:, :, 0]
    view of (B, S, 1, rope), k_nope, v, q_pos and the scale, from numpy."""
    nope, rope, dv = widths
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    q_nope, q_rope = randn(B, S, N, nope + rope).split([nope, rope], dim=-1)
    k_nope, k_rope, v = randn(B, S, N, nope), randn(B, S, 1, rope)[:, :, 0], randn(B, S, N, dv)
    if kind == "arange":
        q_pos = torch.arange(S)
    else:
        q_pos = torch.from_numpy(rng.integers(-3, S + 4, S))
        q_pos[:3] = torch.tensor([-1, S + 2, 0])
    return [q_nope, q_rope, k_nope, k_rope, v, q_pos], 1.0 / math.sqrt(nope + rope)


@pytest.mark.parametrize("kind", ["arange", "mixed"])
@pytest.mark.parametrize("widths", [SMOKE, DEEPSEEK], ids=["smoke", "deepseek"])
def test_plain_gradients_match_autograd_of_the_old_arithmetic(widths, kind):
    ten, scale = _inputs(widths, kind=kind)
    leaves = [t.clone().requires_grad_(True) for t in ten[:5]]
    o = _old_expanded_core(*leaves, ten[5], scale=scale)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(o.shape, dtype=np.float32))
    want = torch.autograd.grad(o, leaves, do)
    ro, lse = expanded_attention_ref(*ten, scale=scale)
    torch.testing.assert_close(ro, o.detach(), rtol=TOL, atol=TOL)
    got = expanded_attention_bwd_ref(*ten[:5], ro, lse, do, ten[5], scale=scale)
    for name, a, b in zip(("dq_nope", "dq_rope", "dk_nope", "dk_rope", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


def test_a_fully_masked_row_is_the_mean_of_v_and_passes_no_gradient_to_q():
    ten, scale = _inputs(SMOKE, S=10, kind="arange")
    ten[5] = ten[5].clone()
    ten[5][4] = -1                                    # query 4 sees no key
    o, _ = expanded_attention_ref(*ten, scale=scale)
    torch.testing.assert_close(o[:, 4], ten[4].mean(1), rtol=TOL, atol=TOL)
    do = torch.zeros_like(o)
    do[:, 4] = 1.0
    dq_nope, dq_rope, dk_nope, dk_rope, dv = expanded_attention_bwd_ref(
        *ten[:5], o, None, do, ten[5], scale=scale)
    assert not dq_nope.abs().any() and not dq_rope.abs().any()
    assert not dk_nope.abs().any() and not dk_rope.abs().any()
    torch.testing.assert_close(dv, torch.full_like(dv, 1.0 / 10), rtol=TOL, atol=TOL)


def test_bf16_plain_version_rounds_the_probabilities_as_the_old_arithmetic():
    ten, scale = _inputs(DEEPSEEK, S=40, dtype=torch.bfloat16)
    got, _ = expanded_attention_ref(*ten, scale=scale)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _old_expanded_core(*ten, scale=scale))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_cpu_and_meta_take_the_plain_versions_through_run_plain():
    seen = []

    def watcher(fn, args, writes=()):
        seen.append((fn.func.__name__, len(args)))
        return fn(*args)

    before = (kernel.launches, backward.launches)
    plain_watchers.append(watcher)
    try:
        ten, scale = _inputs(SMOKE, S=9)
        out = expanded_attention(*ten, scale=scale)
        leaves = [t.clone().requires_grad_(True) for t in ten[:5]]
        graded = expanded_attention(*leaves, ten[5], scale=scale)
        graded.sum().backward()
        meta = [t.to("meta") for t in ten]
        mout = expanded_attention(*meta, scale=scale)
        mleaves = [t.requires_grad_(True) for t in meta[:5]]
        expanded_attention(*mleaves, meta[5], scale=scale).sum().backward()
    finally:
        plain_watchers.remove(watcher)
    assert torch.equal(out, expanded_attention_ref(*ten, scale=scale)[0])
    torch.testing.assert_close(graded.detach(), out, rtol=0, atol=0)
    assert all(leaf.grad is not None for leaf in leaves)
    assert mout.is_meta and mout.shape == (2, 9, 3, 32)
    assert all(leaf.grad is not None and leaf.grad.is_meta for leaf in mleaves)
    assert seen == [("_plain_out", 6), ("expanded_attention_ref", 6),
                    ("expanded_attention_bwd_ref", 9)] * 2
    assert (kernel.launches, backward.launches) == before
    assert KERNEL_MODULES["expanded_attention"] == kernel.__name__
    assert KERNEL_MODULES["expanded_attention_bwd"] == backward.__name__


def test_a_dtensor_raises_type_error():
    from repro_torch.launch import dryrun

    ten, scale = _inputs(SMOKE, S=9)
    ten = [t.to("meta") for t in ten]
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        ten[2] = DTensor.from_local(ten[2], mesh, [Replicate(), Replicate()], run_check=False)
        with pytest.raises(TypeError, match="DTensor"):
            expanded_attention(*ten, scale=scale)


@pytest.mark.parametrize("widths,dtype", [
    ((144, 64, 128), torch.float32), ((128, 80, 128), torch.float32),
    ((128, 64, 8), torch.float32), ((24, 16, 32), torch.float32),
    ((128, 64, 144), torch.bfloat16), ((32, 16, 32), torch.float16),
    ((32, 16, 32), torch.float64),
], ids=["nope 144", "rope 80", "v 8", "nope 24", "v 144", "float16", "float64"])
def test_widths_and_dtypes_outside_the_contract_are_refused_on_cpu(widths, dtype):
    ten, scale = _inputs(widths, S=5, dtype=dtype)
    with pytest.raises(ValueError, match="expanded_attention"):
        expanded_attention(*ten, scale=scale)
    with pytest.raises(ValueError, match="expanded_attention"):
        expanded_attention(*[t.requires_grad_(True) if t.is_floating_point() else t
                             for t in ten], scale=scale)


@pytest.mark.parametrize("index,bad,match", [
    (5, torch.arange(4), "q_pos"),
    (5, torch.arange(5.0), "q_pos"),
    (3, torch.zeros(2, 5, 3, 16), "k_rope"),
    (3, torch.zeros(2, 6, 16), "k_rope"),
    (2, torch.zeros(2, 5, 2, 32), "k_nope"),
    (4, torch.zeros(2, 6, 3, 32), "k_nope"),
    (1, torch.zeros(2, 5, 4, 16), "q_rope"),
    (4, torch.zeros(2, 5, 3, 32, dtype=torch.bfloat16), "dtype"),
])
def test_the_wrapper_refuses_bad_arguments(index, bad, match):
    ten, scale = _inputs(SMOKE, S=5)
    ten[index] = bad
    with pytest.raises(ValueError, match=match):
        expanded_attention(*ten, scale=scale)


def test_the_wrapper_refuses_a_bad_scale():
    ten, _ = _inputs(SMOKE, S=5)
    for scale in (float("nan"), 0.0, -1.0):
        with pytest.raises(ValueError, match="scale"):
            expanded_attention(*ten, scale=scale)


def test_shared_memory_follows_the_formulas():
    """The library's layouts (csrc ``bf16_smem_bytes``, ``f32_smem_bytes``,
    ``dkdv_bf16_smem``, ``dq_bf16_smem``, ``dkdv_f32_smem``,
    ``dq_f32_smem``), every one within a CTA's 227 KB: the forward's bf16
    CTA (two warpgroups' Q tiles, four stages of 64-key K and V tiles)
    takes an SM alone; the dK/dV CTA's ring carries a 16 KB P^T buffer a
    stage; the bf16 dQ CTA holds two query tiles' Q and dO and three
    stages of K and V."""
    assert kernel.smem_bytes("bfloat16") == 2 * 24576 + 4 * 40960 + 136 + 16 == 213144
    assert kernel.smem_bytes("float32") == 4 * (64 * 193 * 2 + 64 * 129 + 64 * 65) + 16
    assert (backward.dkdv_smem_bytes("bfloat16", 64)
            == 4 * 40960 + 3 * 16384 + 2304 + 56 + 8 + 256 == 215616)
    assert backward.dq_smem_bytes("bfloat16") == 5 * 40960 + 32 + 12 == 204844
    assert backward.dkdv_smem_bytes("float32", 64) == 198912
    assert backward.dq_smem_bytes("float32") == 182272
    assert kernel.smem_bytes("bfloat16") + 1024 <= 233472 < 2 * kernel.smem_bytes("bfloat16")
    for n in (1, 64, 512, 4272):
        assert backward.dkdv_smem_bytes("bfloat16", n) <= kernel.MAX_SMEM
    assert backward.dkdv_smem_bytes("bfloat16", 4273) > kernel.MAX_SMEM


# (B, S, N, widths, dtype) -> forward grid, backward grids, part elements;
# a bf16 forward or dQ CTA takes 128 query rows, a dK/dV CTA 64 keys, a
# float32 CTA 64 rows or keys
PLANS = [
    ((2, 4096, 128, DEEPSEEK, "bfloat16"), (256, 32), (256, 64), (256, 32), 2 * 128 * 4096 * 64),
    ((16, 4096, 8, DEEPSEEK, "bfloat16"), (128, 32), (128, 64), (128, 32), 16 * 8 * 4096 * 64),
    ((2, 1000, 8, DEEPSEEK, "bfloat16"), (16, 8), (16, 16), (16, 8), 2 * 8 * 1000 * 64),
    ((2, 64, 4, SMOKE, "float32"), (8, 1), (8, 1), (8, 1), 2 * 4 * 64 * 16),
    ((2, 1, 8, DEEPSEEK, "bfloat16"), (16, 1), (16, 1), (16, 1), 2 * 8 * 1 * 64),
    ((2, 129, 8, DEEPSEEK, "bfloat16"), (16, 2), (16, 3), (16, 2), 2 * 8 * 129 * 64),
    ((2, 129, 4, SMOKE, "float32"), (8, 3), (8, 3), (8, 3), 2 * 4 * 129 * 16),
]


@pytest.mark.parametrize("shape,fwd,dkdv,dq,part", PLANS, ids=[str(p[0][:3]) for p in PLANS])
def test_choose_launch_gives_the_grids(shape, fwd, dkdv, dq, part):
    B, S, N, (nope, rope, dv), dtype = shape
    launch = kernel.choose_launch(B, S, N, S, nope, rope, dv, dtype)
    assert launch.grid == fwd and launch.threads == kernel.THREADS[dtype]
    assert launch.smem_bytes == kernel.smem_bytes(dtype)
    bwd = backward.choose_launch(B, S, N, S, nope, rope, dv, dtype)
    assert (bwd.dkdv_grid, bwd.dq_grid, bwd.part_numel) == (dkdv, dq, part)
    assert bwd.dkdv_smem == backward.dkdv_smem_bytes(dtype, -(-S // 64))
    assert bwd.dq_smem == backward.dq_smem_bytes(dtype)
    assert (bwd.dkdv_threads, bwd.dq_threads) == backward.THREADS[dtype]


def test_choose_launch_refuses_past_the_limits():
    with pytest.raises(ValueError, match="grid"):
        kernel.choose_launch(1, 65536 * 64 + 1, 1, 64, 128, 64, 128, "bfloat16")
    with pytest.raises(ValueError, match="shared memory"):
        backward.choose_launch(1, 64 * 20000, 1, 64, 128, 64, 128, "bfloat16")
    with pytest.raises(ValueError, match="empty"):
        kernel.choose_launch(0, 64, 1, 64, 128, 64, 128, "bfloat16")


# (the plan, its shape, whether it fits): the dK/dV CTA's list of query
# tiles at the last S that fits beside the ring and P^T buffers and the
# first that does not; the forward's ring at four stages of 64 keys and at
# five
REFUSALS = [
    ("dK/dV list fits", "backward", 64 * 4272, {}, True),
    ("dK/dV list one tile past", "backward", 64 * 4272 + 1, {}, False),
    ("forward, four stages", "forward", 4096, {}, True),
    ("forward, five stages", "forward", 4096, {"STAGES": 5}, False),
]


@pytest.mark.parametrize("what,plan,S,consts,fits", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_the_plans_refuse_past_shared_memory(what, plan, S, consts, fits, monkeypatch):
    for name, value in consts.items():
        monkeypatch.setattr(kernel, name, value)
    kernel.choose_launch.cache_clear()
    backward.choose_launch.cache_clear()
    try:
        chooser = kernel.choose_launch if plan == "forward" else backward.choose_launch
        if fits:
            assert chooser(1, S, 1, S, 128, 64, 128, "bfloat16").dtype == "bfloat16"
        else:
            with pytest.raises(ValueError, match="shared memory"):
                chooser(1, S, 1, S, 128, 64, 128, "bfloat16")
    finally:
        kernel.choose_launch.cache_clear()
        backward.choose_launch.cache_clear()


class _FakeLibrary:
    """Stands in for the built libraries: records each call's arguments."""

    def __init__(self):
        self.calls, self.rc = [], 0

    def expanded_attention_fwd(self, *args):
        self.calls.append(("fwd", args))
        return self.rc

    def expanded_attention_bwd(self, *args):
        self.calls.append(("bwd", args))
        return self.rc


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers on CPU tensors up to the library call: the routing
    takes the card's branch, the stream is stubbed, the library is a fake."""
    lib = _FakeLibrary()
    for mod in (kernel, ops):
        monkeypatch.setattr(mod, "takes_plain", lambda t: False)
    monkeypatch.setattr(kernel, "_kernel", lambda device: lib)
    monkeypatch.setattr(backward, "_kernel", lambda device: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_the_model_layouts_are_read_in_place(fake_launch):
    """The split views of the query, k_rope's [:, :, 0] view, k_nope and v
    go to the library as they are, through their strides, forward and
    backward; a view whose rows are 4 bytes off 16 takes one counted copy."""
    ten, scale = _inputs(DEEPSEEK, S=70, dtype=torch.bfloat16)
    before = kernel.layout_copies
    leaves = [t.requires_grad_(True) for t in ten[:5]]
    out = expanded_attention(*leaves, ten[5], scale=scale)
    out.backward(torch.ones_like(out))
    assert kernel.layout_copies == before
    (kind, fwd), (kind2, bwd) = fake_launch.calls
    assert (kind, kind2) == ("fwd", "bwd")
    assert fwd[:5] == tuple(t.data_ptr() for t in ten[:5])
    q_nope, q_rope, _, k_rope, _ = ten[:5]
    assert list(fwd[8][:6]) == [70 * 3 * 192, 3 * 192, 192, 70 * 3 * 192, 3 * 192, 192]
    assert list(fwd[8][9:11]) == [70 * 64, 64]               # k_rope: batch, position
    assert fwd[11:18] == (2, 70, 3, 70, 128, 64, 128)
    assert bwd[:5] == fwd[:5] and list(bwd[17][:11]) == list(fwd[8][:11])
    assert bwd[20:27] == fwd[11:18]
    store = torch.zeros(2 * 70 * 3 * 128 + 2, dtype=torch.bfloat16)
    off = store[2:].view(2, 70, 3, 128)               # 4 bytes past a 16-byte boundary
    with torch.no_grad():
        expanded_attention(*ten[:4], off, ten[5], scale=scale)
    assert kernel.layout_copies == before + 1


def test_the_plan_is_a_function_of_shapes_alone(fake_launch):
    """Two calls that differ only in q_pos pass the library the same
    arguments but q_pos's pointer: a captured graph replays any q_pos."""
    ten, scale = _inputs(DEEPSEEK, S=70, dtype=torch.bfloat16)
    with torch.no_grad():
        expanded_attention(*ten, scale=scale)
        expanded_attention(*ten[:5], torch.flip(ten[5], (0,)).contiguous(), scale=scale)
    (_, a), (_, b) = fake_launch.calls
    assert a[:5] == b[:5] and a[6] is b[6] is None and a[7] != b[7]
    assert list(a[8]) == list(b[8]) and a[9:] == b[9:]


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version was called for a kernel launch")

    for mod in (kernel, ops):
        monkeypatch.setattr(mod, "expanded_attention_ref", plain)
    monkeypatch.setattr(ops, "expanded_attention_bwd_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    before = kernel.launches
    ten, scale = _inputs(SMOKE, S=9)
    with pytest.raises(RuntimeError, match="expanded_attention launch failed: error 700"):
        with torch.no_grad():
            expanded_attention(*ten, scale=scale)
    assert kernel.launches == before and len(fake_launch.calls) == 1
    fake_launch.rc = 0
    leaves = [t.requires_grad_(True) for t in ten[:5]]
    out = expanded_attention(*leaves, ten[5], scale=scale)
    fake_launch.rc = 700
    with pytest.raises(RuntimeError, match="expanded_attention_bwd launch failed: error 700"):
        out.sum().backward()


def test_the_expanded_core_is_b7(monkeypatch):
    calls = []

    def recording(*args, scale):
        calls.append(scale)
        return expanded_attention_ref(*args, scale=scale)[0]

    monkeypatch.setattr(TMLA, "expanded_attention", recording)
    jcfg, _, tcfg, tp = _attn("q_lora")
    with torch.no_grad():
        TMLA.mla_attention(tp, torch.from_numpy(_x(jcfg)), tcfg,
                           positions=torch.from_numpy(_positions("arange", 2, 12)))
    assert calls == [1.0 / math.sqrt(48)]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.timeout(600)
def test_the_dry_run_train_step_counts_b7_and_holds_no_scores(monkeypatch):
    """deepseek-v2 smoke's train_4k step on meta tensors over a fake (2, 2)
    mesh, without remat: B7's plain versions run once a layer forward and
    once a layer backward, each counted as one launch, on each device's heads (2 of 4)
    and batch rows (128 of 256), so no storage as large as one (128, 2,
    4096, 4096) float32 score tensor is made (the peak temp is below it)."""
    from repro_torch.launch import dryrun

    cfg = TC.get("deepseek-v2-236b", smoke=True)
    calls = []
    for name in ("expanded_attention_ref", "expanded_attention_bwd_ref"):
        inner = getattr(ops, name)

        def counting(*args, _inner=inner, _name=name, **kw):
            calls.append((_name, tuple(args[0].shape)))
            return _inner(*args, **kw)

        monkeypatch.setattr(ops, name, counting)
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        case = dryrun.build_case(cfg, "train_4k", mesh, remat=False)
        counts = dryrun.count_step(case.step)
    local = (128, 4096, cfg.n_heads // 2, cfg.mla.qk_nope_head_dim)
    assert calls.count(("expanded_attention_ref", local)) == cfg.n_layers
    assert calls.count(("expanded_attention_bwd_ref", local)) == cfg.n_layers
    assert len(calls) == 2 * cfg.n_layers
    scores = 128 * (cfg.n_heads // 2) * 4096 * 4096 * 4
    assert 0 < counts["temp_bytes"] < scores


# ---------------------------------------------------------------------------
# phase 3d of chip_smoke.py
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_3d_covers_the_paths_shapes_and_every_kernel():
    """19h's shape, a 16x16 device's train_4k share, 21b's prompt at 128
    heads, S of 1, 63, 65, 129 (a forward CTA's second warpgroup with one
    row), 512 and 1000, a q_pos that is not arange, large scores (q and k
    drawn 4x as large at 19h's widths and S 1000), the smoke widths at
    float32 (19d) and bf16: each a launch both wrappers plan, a case at
    each dtype of the library (every case runs both directions; phase 3d
    fails unless each (dtype, direction) counted its launches)."""
    cases = _chip_smoke().EXPANDED_CASES
    shapes = {(B, S, N) for _, B, S, N, *_ in cases}
    assert {(2, 4096, 128), (16, 4096, 8), (2, 256, 128)} <= shapes
    assert (2, 256, 128, 128, 64, 128, "bfloat16") in {c[1:8] for c in cases}
    assert {1, 63, 65, 129, 512, 1000} <= {S for _, _, S, *_ in cases}
    assert {"arange", "mixed", "sharp"} == {c[8] for c in cases}
    assert (1000, 128, 64, 128, "bfloat16", "sharp") in {c[2:3] + c[4:9] for c in cases}
    assert (129, 128, 64, 128, "bfloat16", "arange") in {c[2:3] + c[4:9] for c in cases}
    assert {dt for *_, dt, _ in cases} == {"bfloat16", "float32"}
    for _, B, S, N, nope, rope, dv, dtype, _ in cases:
        kernel.choose_launch(B, S, N, S, nope, rope, dv, dtype)
        backward.choose_launch(B, S, N, S, nope, rope, dv, dtype)
    assert {dt for dt, _ in kernel.INSTANCES} == {c[7] for c in cases}
    assert (32, 16, 32, "float32") in {c[4:8] for c in cases}


def test_the_training_path_gives_b7_layouts_it_reads_in_place(monkeypatch):
    """deepseek-v2 smoke's forward and backward at bf16: the five inputs B7
    gets (the split query views, k_nope, k_rope's view, v) and the output's
    gradient its backward gets are read in place (no layout copy on the
    card): the expanded form projects its output through one product over
    the merged heads, whose gradient comes back contiguous."""
    from repro_torch.launch import serve
    from repro_torch.models import forward

    cfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype="bfloat16")
    model = serve.init_params(cfg, seed=0, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    seen = []
    fwd, bwd = ops.ExpandedAttention.forward, ops.ExpandedAttention.backward

    def spy_fwd(*args):
        seen.append(("forward", [readable(t) for t in args[:5]]))
        return fwd(*args)

    def spy_bwd(ctx, do, dlse):
        seen.append(("backward", [readable(do)]))
        return bwd(ctx, do, dlse)

    monkeypatch.setattr(ops.ExpandedAttention, "forward", staticmethod(spy_fwd))
    monkeypatch.setattr(ops.ExpandedAttention, "backward", staticmethod(spy_bwd))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 64)))
    forward(model, {"tokens": tokens}, cfg)[0].float().sum().backward()
    assert [kind for kind, _ in seen] == ["forward"] * cfg.n_layers + ["backward"] * cfg.n_layers
    assert all(all(ok) for _, ok in seen), seen
