"""Decode over a cache sharded over positions (the long-context rules of
``long_500k``: ``kv_seq`` over ``("pod", "data")``), on the CPU.

* **B3's partials and the combine:** the same numpy-seeded inputs through
  the JAX package's ``_sdpa`` (cache form) and ``_sdpa_deferred`` on the
  whole cache, and through ``decode_attention_partials`` on P = 1-4 shards
  of it (T = 50: uneven at 3 and 4) plus ``ops.combine`` over their stack,
  float32 within 1e-5: windows and soft-caps, kv_valid 0 (whole shards
  empty), on a shard's boundary and inside the last shard, S = 1 and 2,
  and a row that no shard sees (JAX's mean of v over every position).
  The kernel's empty shard (0 and -inf) weighs as the plain version's.
* **the launch plan at the long shapes:** B 1 over 262,144-524,288
  positions of zamba2's and gemma2's heads: every cluster resident at
  once, one CTA an SM on at least 95% of the card's SMs; the wrapper's
  checks of ``t_start``; the library call of the partials form (a fake
  library) takes the whole form's plan, the shard's offset and an lse.
* **the reduction over several mesh axes:** a cache split over ``pod`` and
  ``data`` of a fake (2, 2) mesh reduces in one flattened group: one max
  and one sum all-reduce, no all-gather.
* **decode on gloo meshes:** zamba2's and gemma2's smoke configs (float32,
  the JAX weights through ``bridge.params_from_jax``) decode 4 greedy steps
  over a seeded cache of 3072 positions on (1, 2) and (1, 3) ``("pod",
  "data")`` meshes of spawned processes, the cache's positions sharded:
  every step's logits within 1e-5 of JAX's ``decode_step`` on the whole
  cache, the same greedy tokens, B3's partials once an attention layer a
  step.
"""

import dataclasses
import os
import traceback
import types

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
from _sharded_harness import run_mesh  # noqa: E402
from repro_torch.kernels.decode_attention import (combine,  # noqa: E402
                                                  decode_attention_partials, kernel,
                                                  over_stack)

TOL = 1e-5
B, T, NKV = 3, 50, 2


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def bounds(T: int, P: int) -> list[int]:
    """Each shard's first position and the end: ``torch.tensor_split``'s
    cut of ``T`` into ``P``."""
    return [i * (T // P) + min(i, T % P) for i in range(P + 1)]


def _inputs(seed, P, S, *, new, G=3, hd=32, q_scale=1.0):
    """q, the cache, the new part (or None), positions and kv_valid as
    numpy: the rows' offsets are 0 (every shard empty but the new keys),
    the first shard's end (a boundary) and 3 into the last shard."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    b = bounds(T, P)
    kvv = np.array([0, b[1], b[-2] + 3], np.int64)
    if not new:
        kvv = np.maximum(kvv, S)                  # the cache form's token sees itself
    start = kvv if new else kvv - S
    q = randn(B, S, NKV * G, hd) * np.float32(q_scale)
    kn = vn = None
    if new:
        kn, vn = randn(B, S, NKV, hd), randn(B, S, NKV, hd)
    positions = start[:, None] + np.arange(S, dtype=np.int64)[None, :]
    return q, randn(B, T, NKV, hd), randn(B, T, NKV, hd), kn, vn, positions, kvv


def _jax_ref(arrs, *, scale, softcap, window):
    q, kc, vc, kn, vn, positions, kv_valid = (None if a is None else jnp.asarray(a)
                                              for a in arrs)
    positions, kv_valid = positions.astype(jnp.int32), kv_valid.astype(jnp.int32)
    if kn is not None:
        out = JL._sdpa_deferred(q, kc, vc, kn, vn, scale=scale, softcap_val=softcap,
                                positions=positions, window=window, kv_valid=kv_valid)
    else:
        out = JL._sdpa(q, kc, vc, scale=scale, softcap_val=softcap, q_pos=positions,
                       kv_pos=jnp.arange(kc.shape[1]), window=window, kv_valid=kv_valid)
    return np.asarray(out)


def _shards(arrs, P, **kw):
    """Each shard's plain partials, stacked, and each shard's positions."""
    q, kc, vc, kn, vn, positions, kv_valid = (None if a is None else torch.from_numpy(a)
                                              for a in arrs)
    b = bounds(T, P)
    parts, count = [], []
    for i in range(P):
        new = (kn, vn) if i == 0 else (None, None)
        parts.append(decode_attention_partials(q, kc[:, b[i]:b[i + 1]], vc[:, b[i]:b[i + 1]],
                                               *new, positions=positions, kv_valid=kv_valid,
                                               t_start=b[i], **kw))
        count.append(b[i + 1] - b[i] + (q.shape[1] if kn is not None and i == 0 else 0))
    out, lse = (torch.stack(x) for x in zip(*parts))
    return out, lse, torch.tensor(count, dtype=torch.float32).reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (5, 30.0)], ids=["plain", "window-cap"])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("new", [True, False], ids=["deferred", "cache"])
def test_partials_combined_match_jax(new, P, window, cap, S):
    arrs = _inputs(P * 10 + S, P, S, new=new, q_scale=8.0 if cap else 1.0)
    kw = dict(scale=0.125, softcap=cap, window=window)
    out, lse, count = _shards(arrs, P, **kw)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (P, B, S, NKV * 3, 32) and lse.shape == (P, B, S, NKV * 3)
    got = combine(out, lse, count, over_stack)[0]
    np.testing.assert_allclose(got.numpy(), _jax_ref(arrs, **kw), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("new", [True, False], ids=["deferred", "cache"])
def test_a_row_no_shard_sees_is_the_mean_of_v(new, P):
    """Row 0 at position -1 sees no key in any shard: JAX's softmax of
    ``NEG_INF`` scores gives the mean of v over every position (the new
    keys' too); the shards, each the mean of its own, weigh by their
    positions into it."""
    arrs = list(_inputs(7, P, 1, new=new))
    arrs[5] = arrs[5].copy()
    arrs[5][0] = -1
    if new:
        arrs[6] = arrs[6].copy()
        arrs[6][0] = 0
    kw = dict(scale=0.2, softcap=0.0, window=None)
    got = combine(*_shards(arrs, P, **kw), over_stack)[0]
    want = _jax_ref(arrs, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    vs = [arrs[2][0]] + ([arrs[4][0]] if new else [])
    mean_v = np.repeat(np.concatenate(vs).mean(axis=0), 3, axis=0)       # (NH, hd)
    np.testing.assert_allclose(got[0, 0].numpy(), mean_v, atol=TOL)


@pytest.mark.parametrize("everywhere", [False, True], ids=["one-shard", "every-shard"])
def test_the_kernels_empty_shard_weighs_nothing(everywhere):
    """The kernel writes 0 and -inf for a shard with no visible key (the
    plain version the shard's mean of v and about ``NEG_INF``): beside a
    shard that sees a key both weigh 0; where no shard sees one, the
    kernel's shards combine to 0, as the whole-cache kernel writes."""
    arrs = list(_inputs(9, 3, 1, new=False))
    if everywhere:
        arrs[5] = np.full_like(arrs[5], -1)
    kw = dict(scale=0.2, softcap=0.0, window=None)
    out, lse, count = _shards(arrs, 3, **kw)
    empty = lse < -1e29
    assert bool(empty.any()) and bool((~empty).any()) != everywhere
    k_out = torch.where(empty[..., None], 0.0, out)
    k_lse = torch.where(empty, -torch.inf, lse)
    got = combine(k_out, k_lse, count, over_stack)[0]
    if everywhere:
        assert bool((got == 0).all())
    else:
        np.testing.assert_array_equal(got.numpy(), combine(out, lse, count, over_stack)[0].numpy())


def test_one_shard_gives_its_own_bits():
    """With no reduction (one shard) the combine weighs by exp(0) = 1: the
    output is the partials' own, cast."""
    arrs = _inputs(11, 1, 1, new=True)
    out, lse, count = _shards(arrs, 1, scale=0.125)
    got = combine(out[0], lse[0], count[0], dtype=torch.bfloat16)
    assert torch.equal(got, out[0].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the launch plan and the wrapper
# ---------------------------------------------------------------------------

# (B, T, NKV, G·S, hd, new, window): zamba2's cache form and gemma2's global
# and local layers (deferred) at long_500k's cache and at half of it (one of
# two shards)
LONG_PLANS = [(1, t, 32, 1, 80, False, None) for t in (262144, 524288)] + [
    (1, t, 16, 2, 128, True, w) for t in (262144, 524288) for w in (2**30, 4096)]


@pytest.mark.parametrize("shape", LONG_PLANS, ids=lambda s: f"T{s[1]}-hd{s[4]}-w{s[6]}")
def test_the_long_plans_fill_the_card(shape):
    B, T_, NKV_, GS, hd, new, window = shape
    launch = kernel.choose_launch(B, T_, NKV_, GS, hd, "bfloat16", new, window)
    assert kernel.check_launch(launch, B, T_, NKV_, new) is launch
    pairs = B * NKV_ * launch.row_tiles
    ctas = pairs * launch.cluster
    assert pairs <= kernel.resident_clusters(launch.cluster, kernel.per_sm(launch.smem_bytes))
    assert 0.95 * kernel.SMS <= ctas <= kernel.SMS          # one CTA an SM: bytes bind it
    assert launch.span == (T_ if window is None or window >= T_ else window + GS)


@pytest.mark.parametrize("t_start,match", [(-1, "int >= 0"), (1.5, "int >= 0"),
                                           (True, "int >= 0"),
                                           (kernel.MAX_ROWS - 10, "ends past")])
def test_the_shard_offset_is_checked(t_start, match):
    arrs = _inputs(1, 1, 1, new=False)
    q, kc, vc, _, _, positions, kv_valid = (None if a is None else torch.from_numpy(a)
                                            for a in arrs)
    with pytest.raises(ValueError, match=match):
        decode_attention_partials(q, kc, vc, positions=positions, kv_valid=kv_valid,
                                  t_start=t_start)


class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def decode_attention(self, *args):
        self.calls.append(("whole", args))
        return 0

    def decode_attention_partials(self, *args):
        self.calls.append(("partials", args))
        return 0


def test_the_partials_launch_takes_the_whole_forms_plan(monkeypatch):
    """On the card's route (a fake library): the partials form passes the
    whole form's arguments and plan for the same shard, then its lse
    (B, S, NH) float32 and ``t_start``; its output is float32; both counts
    move.  A shard is a strided view: no layout copy."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel, "takes_plain", lambda t: False)
    monkeypatch.setattr(kernel, "_kernel", lambda device: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    cache = torch.zeros((2, 1, 256, 2, 32), dtype=torch.bfloat16)
    q = torch.zeros((1, 1, 6, 32), dtype=torch.bfloat16)
    shard = (cache[0][:, 128:], cache[1][:, 128:])
    kw = dict(positions=torch.tensor([200]), kv_valid=torch.tensor(201))
    copies, launches, partials = kernel.layout_copies, kernel.launches, kernel.partials_launches
    whole = kernel.decode_attention(q, *shard, **kw)
    out, lse = decode_attention_partials(q, *shard, t_start=128, **kw)
    assert kernel.layout_copies == copies
    assert (kernel.launches, kernel.partials_launches) == (launches + 2, partials + 1)
    (form0, a0), (form1, a1) = lib.calls
    assert (form0, form1) == ("whole", "partials")
    assert a1[:5] == a0[:5] and a1[6:8] == a0[6:8] and a1[9:len(a0)] == a0[9:]
    assert list(a1[8]) == list(a0[8])                  # the strides: out is contiguous either way
    assert a1[1] == shard[0].data_ptr()
    assert a1[-2] == lse.data_ptr() and a1[-1] == 128
    assert whole.dtype == torch.bfloat16 and out.dtype == lse.dtype == torch.float32
    assert lse.shape == (1, 1, 6) and out.shape == q.shape


# ---------------------------------------------------------------------------
# several mesh axes
# ---------------------------------------------------------------------------

def test_a_cache_over_two_mesh_axes_reduces_in_one_group():
    """``kv_seq`` over ``("pod", "data")`` of a fake (2, 2) mesh: the
    positions split four ways, and the combine reduces once over a
    flattened group of the four: one max all-reduce of (B, S, NH), one sum
    of (B, S, NH, hd + 1), float32, and no all-gather."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import place, shard_group
    from repro_torch.launch.comm_analysis import KINDS, CommCounter
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.models import layers as TL

    arrs = _inputs(3, 4, 1, new=False)
    q, kc, vc, _, _, positions, kv_valid = (None if a is None else torch.from_numpy(a)
                                            for a in arrs)
    kc, vc = kc[:, :48], vc[:, :48]
    with fake_mesh((2, 2), ("pod", "data")) as mesh:
        kd, vd = (place(t, mesh, [Shard(1), Shard(1)]) for t in (kc, vc))
        assert kd.to_local().shape[1] == 12
        group = torch.distributed.distributed_c10d._resolve_process_group(shard_group(kd, 1))
        assert group.size() == 4
        with torch.no_grad(), CommCounter() as counter:
            TL._decode_attention(q, kd, vd, None, None, scale=0.2, softcap_val=0.0,
                                 positions=positions, window=None, kv_valid=kv_valid)
    kinds = [(KINDS[op], n) for op, n in counter.records if op in KINDS]
    NH = q.shape[2]
    assert kinds == [("all-reduce", 4 * B * NH), ("all-reduce", 4 * B * NH * 33)]


# ---------------------------------------------------------------------------
# decode on gloo meshes
# ---------------------------------------------------------------------------

LONG_ARCHS = ["zamba2-2.7b", "gemma2-27b"]
MESHES = [(1, 2), (1, 3)]
LONG_LEN, START, STEPS = 3072, 1534, 4


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


def _attention_layers(cfg) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else cfg.n_layers


_JAX: dict = {}


def _jax_decode(arch):
    """JAX's weights (numpy), its cache's filled leaves (numpy, by sorted
    name), the first token, and JAX's greedy decode over the whole cache:
    each step's logits and tokens."""
    if arch not in _JAX:
        jcfg, _ = _cfgs(arch)
        params, _ = JT.init_model(jax.random.key(0), jcfg)
        cache = JT.init_cache(jcfg, 1, LONG_LEN, per_slot=False)
        rng = np.random.default_rng(5)
        flat, treedef = jax.tree_util.tree_flatten(cache)
        filled = [np.full(a.shape, START) if a.ndim == 0 else
                  (0.5 * rng.standard_normal(a.shape)).astype(np.float32) for a in flat]
        cache = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v, a.dtype)
                                                       for v, a in zip(filled, flat)])
        first = rng.integers(0, jcfg.vocab, (1, 1))
        tok, logits, tokens = first, [], []
        for _ in range(STEPS):
            out, cache = JT.decode_step(params, cache, jnp.asarray(tok, jnp.int32), jcfg)
            out = np.asarray(out)
            logits.append(out)
            tok = out[:, -1, : jcfg.vocab].argmax(-1)[:, None]
            tokens.append(tok)
        _JAX[arch] = dict(params=jax.tree_util.tree_map(np.asarray, params), leaves=filled,
                          first=first, logits=np.stack(logits), tokens=np.concatenate(tokens, 1))
    return _JAX[arch]


def _sharded_decode(mesh, arch, params, leaves, first):
    """The port's greedy decode of ``arch`` on ``mesh`` under the
    long-context rules from JAX's weights and cache leaves: each step's
    logits and tokens, the cache's attention placements and the calls of
    B3's partials form."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.distributed import (LONG_CONTEXT_OVERRIDES, shard_model, shard_tree,
                                         use_sharding_ctx)
    from repro_torch.models import cache_axes, decode_step, init_cache, layers, param_axes

    _, tcfg = _cfgs(arch)
    rules = dict(LONG_CONTEXT_OVERRIDES)
    model = shard_model(params_from_jax(params, tcfg, device="cpu"), param_axes(tcfg), mesh,
                        rules)
    cache = init_cache(tcfg, 1, LONG_LEN, per_slot=False, device="cpu")
    for (_, t), v in zip(_leaves(cache), leaves, strict=True):
        t.copy_(torch.from_numpy(np.asarray(v)).to(t.dtype))
    cache = shard_tree(cache, cache_axes(tcfg, per_slot=False), mesh, rules)
    calls = []
    inner = layers.decode_attention_partials

    def counting(*a, **kw):
        calls.append(kw["t_start"])
        return inner(*a, **kw)

    layers.decode_attention_partials = counting
    tok, logits, tokens = first, [], []
    try:
        with torch.no_grad(), use_sharding_ctx(mesh, rules):
            for _ in range(STEPS):
                placed = shard_tree(torch.from_numpy(np.asarray(tok)), "batch seq", mesh, rules)
                out = decode_step(model, cache, placed, tcfg)[0].full_tensor().numpy()
                logits.append(out)
                tok = out[:, -1, : tcfg.vocab].argmax(-1)[:, None]
                tokens.append(tok)
    finally:
        layers.decode_attention_partials = inner
    kv = cache["attn_k" if tcfg.family == "hybrid" else "k"]
    return dict(logits=np.stack(logits), tokens=np.concatenate(tokens, 1), calls=calls,
                placements=[str(p) for p in kv.placements], local=tuple(kv.to_local().shape))


def _mesh_body(mesh, shape, cases):
    return {arch: _sharded_decode(mesh, arch, *case) for arch, case in cases.items()}


_RUNS: dict = {}


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def long_mesh(request, tmp_path_factory):
    shape = request.param
    if shape not in _RUNS:
        cases = {a: tuple(_jax_decode(a)[k] for k in ("params", "leaves", "first"))
                 for a in LONG_ARCHS}
        try:
            _RUNS[shape] = run_mesh(shape, _mesh_body, (cases,),
                                    tmp_path_factory.mktemp("long"), names=("pod", "data"))
        except BaseException:
            print(traceback.format_exc())
            raise
    return shape, _RUNS[shape]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_sharded_long_decode_matches_jax(long_mesh, arch):
    shape, runs = long_mesh
    got, want = runs[arch], _jax_decode(arch)
    ways = shape[0] * shape[1]
    assert got["placements"] == ["S(2)", "S(2)"]               # kv_seq over pod and data
    assert got["local"][2] == LONG_LEN // ways
    _, tcfg = _cfgs(arch)
    assert len(got["calls"]) == STEPS * _attention_layers(tcfg)
    assert got["calls"][0] == 0                                # rank 0's shard starts at 0
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], atol=TOL, rtol=TOL)
