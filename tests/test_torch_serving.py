"""The port's serving engine, schedule cache and bucketing, on the CPU.

The port's ``ServingEngine(device="cpu")`` must produce the same greedy
tokens as the JAX ``ServingEngine`` on the same prompts, weights and
bucketing (phi4-smoke, gemma2-smoke, arctic-smoke and deepseek-v2-smoke at
float32).  The rest mirrors the
engine contract of ``test_serving.py`` and a subset of ``test_cache_bytes.py``
and the bucketing properties, against the port's classes.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.aot import ScheduleKey  # noqa: E402
from repro_torch.dispatch import (  # noqa: E402
    DrainTimeoutError,
    ExactBucketing,
    ExplicitBuckets,
    MemoryBudget,
    PowerOfTwoBuckets,
    ScheduleCache,
    make_policy,
)
from repro_torch.models import init_model  # noqa: E402
from repro_torch.obs import SpanTracer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- token parity with the JAX engine ------------------------------------------

def _prompts(vocab, n, seed, lo=3, hi=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))) for _ in range(n)]


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b"])
def test_tokens_identical_to_jax_engine(arch):
    """Five requests over two slots (slot reuse), prompts of 3..16 tokens
    padded to buckets 8/16, eight new tokens each: gemma2-smoke's decode
    runs past its window of 16."""
    jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="float32")
    params, _ = jax_init_model(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    prompts = _prompts(jcfg.vocab, 5, seed=3)
    kw = dict(max_slots=2, max_len=48, prompt_buckets=(8, 16))

    jeng = JaxServingEngine(jcfg, params, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p.astype(np.int32), max_new_tokens=8))
    want = {r.rid: r.generated for r in jeng.run_until_drained()}

    teng = ServingEngine(tcfg, model, device="cpu", **kw)
    for i, p in enumerate(prompts):
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    got = {r.rid: r.generated for r in teng.run_until_drained()}
    assert got == want
    assert teng.stats.prefill_tokens == 5 and teng.stats.tokens_out == 35


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_moe_tokens_identical_to_jax_engine(arch):
    """The MoE family: five requests over two slots with prompts of 5..100
    tokens, padded to buckets 16 and 128.  At bucket 128 the experts take
    the capacity factor (N = 128 > 64, capacity 80 of 4 experts top-2), at
    16 and in decode they run dropless; DeepSeek prefills its latent
    cache."""
    jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="float32")
    params, _ = jax_init_model(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab, n) for n in (5, 100, 12, 70, 16)]
    kw = dict(max_slots=2, max_len=160, prompt_buckets=(16, 128))

    jeng = JaxServingEngine(jcfg, params, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p.astype(np.int32), max_new_tokens=6))
    want = {r.rid: r.generated for r in jeng.run_until_drained()}

    teng = ServingEngine(tcfg, model, device="cpu", **kw)
    assert list(teng.kv_cache)[:2] == (["ckv", "krope"] if tcfg.mla else ["k", "v"])
    for i, p in enumerate(prompts):
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    got = {r.rid: r.generated for r in teng.run_until_drained()}
    assert got == want
    assert teng.stats.prefill_tokens == 5 and teng.stats.tokens_out == 25


# -- the engine contract (mirrors test_serving.py) -----------------------------

@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype="float32")
    return cfg, init_model(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.fixture(scope="module")
def shared_cache():
    return ScheduleCache(capacity=16)


def _engine(model, cache, **kw):
    cfg, params = model
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("prompt_buckets", (8, 16))
    return ServingEngine(cfg, params, schedule_cache=cache, device="cpu", **kw)


def _reqs(cfg, n, max_new=4, seed=1, plen=5):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, plen), max_new_tokens=max_new)
            for i in range(n)]


def test_one_token_request_not_dropped(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    eng.submit(_reqs(cfg, 1, max_new=1)[0])
    done = eng.run_until_drained()
    assert len(done) == 1 and done[0].done
    assert len(done[0].generated) == 1     # exactly one token, from prefill
    assert done[0].t_done >= done[0].t_first > 0
    assert eng.idle


def test_mixed_lengths_all_reported_once(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    reqs = _reqs(cfg, 6)
    for i, r in enumerate(reqs):
        r.max_new_tokens = 1 if i % 2 == 0 else 3
        eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done) == list(range(6))
    for r in done:
        assert len(r.generated) == r.max_new_tokens


def test_step_returns_finished(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    eng.submit(_reqs(cfg, 1, max_new=1)[0])
    assert [r.rid for r in eng.step()] == [0]


def test_engines_share_sealed_steps_on_cpu(model):
    """On the CPU a sealed step takes weights and cache as arguments, so a
    second engine over the same (cfg, shapes) pays zero seals."""
    cache = ScheduleCache(capacity=16)
    first = _engine(model, cache)
    builds = cache.stats.builds
    assert builds == 3                     # decode + buckets 8 and 16
    assert first.stats.prefill_compiles + first.stats.decode_compiles == builds
    second = _engine(model, cache)
    assert cache.stats.builds == builds
    assert second.stats.prefill_compiles == 0 and second.stats.decode_compiles == 0
    assert first.stats.prefill_replays == 0          # no CUDA graph on the CPU


def test_bucketing_policy_replaces_prompt_buckets(model, shared_cache):
    eng = _engine(model, shared_cache, bucketing="pow2:8:16")
    assert eng.prompt_buckets == (8, 16)
    assert eng._bucket(5) == 8
    with pytest.raises(ValueError):
        eng._bucket(17)


def test_prefill_key_memo_is_lru_bounded(model, shared_cache):
    eng = _engine(model, shared_cache, warmup=False)
    eng._prefill_key_cap = 1
    eng._get_prefill_exec(8)
    eng._get_prefill_exec(16)
    assert list(eng._prefill_keys) == [16]
    eng._get_prefill_exec(8)
    assert list(eng._prefill_keys) == [8]


def test_cache_invalidation_reaches_warm_engine(model):
    cache = ScheduleCache(capacity=16)
    eng = _engine(model, cache, warmup=False)
    eng._get_prefill_exec(8)
    builds = cache.stats.builds
    eng._get_prefill_exec(8)
    assert cache.stats.builds == builds
    assert cache.invalidate(eng._prefill_key(8))
    eng._get_prefill_exec(8)
    assert cache.stats.builds == builds + 1
    cache.clear()
    eng._get_prefill_exec(8)
    assert cache.stats.builds == builds + 2


def test_prefill_tokens_counted_separately(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    for r in _reqs(cfg, 2, max_new=3):
        eng.submit(r)
    eng.run_until_drained()
    assert eng.stats.prefill_tokens == 2
    assert eng.stats.tokens_out == 4 and eng.stats.steps == 2


def test_truncation_is_signaled(model, shared_cache):
    """The window fills at ``pos_full >= max_len - 1``: fewer tokens than
    asked, and ``truncated`` says so; the untruncated path stays unflagged."""
    eng = _engine(model, shared_cache, max_len=24)
    req = Request(rid=0, prompt=np.ones(16, np.int64), max_new_tokens=64)
    ok = Request(rid=1, prompt=np.ones(4, np.int64), max_new_tokens=2)
    eng.submit(req)
    eng.submit(ok)
    eng.run_until_drained()
    assert req.done and req.truncated
    assert len(req.generated) == 24 - 1 - 16
    assert ok.done and not ok.truncated and len(ok.generated) == 2


def test_free_slots_never_negative(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    states = []
    for n_queued in range(7):
        for r in _reqs(cfg, n_queued, max_new=2, seed=n_queued + 1):
            eng.submit(r)
        states.append(eng.free_slots())
        assert eng.free_slots() == max(0, 2 - len(eng.queue))
        while not eng.idle:
            eng.step()
            assert eng.free_slots() >= 0
    assert min(states) == 0 and max(states) == 2


def test_retire_fails_queued_requests_loudly(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    seen = []
    reqs = _reqs(cfg, 3, max_new=2)
    for r in reqs:
        r.on_complete = lambda model_name, req: seen.append(req.rid)
        eng.submit(r)
    eng.retire()
    assert not eng.queue
    for r in reqs:
        assert r.done and "retired" in r.error
    assert sorted(seen) == [0, 1, 2]
    with pytest.raises(RuntimeError):
        eng.validate_request(_reqs(cfg, 1)[0])


def test_unservable_direct_submit_fails_request_not_stepper(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    bad = Request(rid=9, prompt=np.zeros(17, np.int64), max_new_tokens=2)
    good = _reqs(cfg, 1, max_new=2)[0]
    eng.submit(bad)
    eng.submit(good)
    finished = eng.run_until_drained()
    assert bad in finished and bad.done and "unservable" in bad.error
    assert good.done and not good.error and len(good.generated) == 2


def test_submit_hook_and_single_stepper_guard(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    fired = []
    eng.set_submit_hook(lambda: fired.append(1))
    eng.submit(_reqs(cfg, 1, max_new=2)[0])
    assert fired == [1]
    eng._step_mu.acquire()
    try:
        with pytest.raises(RuntimeError, match="single-stepper"):
            eng.step()
    finally:
        eng._step_mu.release()
    eng.run_until_drained()


def test_drain_timeout_raises(model, shared_cache):
    cfg, _ = model
    eng = _engine(model, shared_cache)
    eng.submit(_reqs(cfg, 1, max_new=5)[0])
    with pytest.raises(DrainTimeoutError):
        eng.run_until_drained(max_steps=1)
    eng.run_until_drained()


def test_idle_slot_offsets_reset_and_keep_counting(model, shared_cache):
    """As in JAX, the decode step advances every slot's offset, idle ones
    too, and a finished slot is reset to 0 for its next occupant."""
    cfg, _ = model
    eng = _engine(model, shared_cache)
    eng.submit(_reqs(cfg, 1, max_new=3, plen=5)[0])
    eng.step()                                 # prefill into slot 0 + 1 decode
    assert eng.kv_cache["pos"].tolist() == [6, 1]
    eng.run_until_drained()
    assert eng.kv_cache["pos"].tolist() == [0, 2]


def test_tracer_records_engine_spans(model):
    cfg, _ = model
    tracer = SpanTracer().enable()
    eng = _engine(model, ScheduleCache(capacity=8, tracer=tracer), tracer=tracer)
    eng.submit(_reqs(cfg, 1, max_new=2)[0])
    eng.run_until_drained()
    names = [e.name for e in tracer.drain()]
    assert "cache.build" in names and "prefill" in names and "decode" in names


def test_engine_defaults_to_the_card():
    """No ``device`` means CUDA: on a host without a card the engine
    refuses, it never falls back to the CPU."""
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype="float32")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    # on a CUDA host the CPU weights are refused instead
    expected = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(expected):
        ServingEngine(cfg, params)
    with pytest.raises(expected):
        ServingEngine(cfg, params, device="cuda")


def test_engine_refuses_unported_families():
    """Recurrent families are refused by both engines.  The audio family is
    refused up front here, where the JAX engine fails in its prefill warm-up
    (a cache of ``memory_len=0`` hands its ``(B, 0, D)`` memory leaf to the
    one-slot prefill unsliced): serving audio is a feature neither package
    has; batch ``decode_step`` over ``encode_memory`` serves it."""
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), family="ssm")
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, None, device="cpu")
    jcfg = dataclasses.replace(JC.get("seamless-m4t-medium", smoke=True), dtype="float32")
    params, _ = jax_init_model(jax.random.key(0), jcfg)
    with pytest.raises(TypeError, match="cannot reshape"):
        JaxServingEngine(jcfg, params, max_slots=2, max_len=32, prompt_buckets=(16,))
    tcfg = dataclasses.replace(TC.get("seamless-m4t-medium", smoke=True), dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encode_memory"):
        ServingEngine(tcfg, model, max_slots=2, max_len=32, prompt_buckets=(16,), device="cpu")


# -- schedule key --------------------------------------------------------------

def test_schedule_key_from_shapes_and_options():
    meta = torch.empty((2, 1), dtype=torch.long, device="meta")
    args = ({"w": torch.zeros(3, 4)}, meta)
    a = ScheduleKey.from_call(len, args, (("x", 1),), fn_id="f")
    assert a == ScheduleKey.from_call(len, ({"w": torch.ones(3, 4)}, meta.clone()),
                                      (("x", 1),), fn_id="f")
    assert a.leaves == (((3, 4), "torch.float32"), ((2, 1), "torch.int64"))
    assert a != ScheduleKey.from_call(len, ({"w": torch.zeros(3, 5)}, meta), (("x", 1),), fn_id="f")
    assert a != ScheduleKey.from_call(len, args, (("x", 2),), fn_id="f")
    assert a != ScheduleKey.from_call(len, ({"v": torch.zeros(3, 4)}, meta), (("x", 1),), fn_id="f")
    assert ScheduleKey.from_call(len, (3,)).leaves == (((), "int64"),)


# -- ScheduleCache / MemoryBudget (subset of test_cache_bytes.py) --------------

def test_byte_budget_evicts_lru_first():
    cache = ScheduleCache(capacity=64, byte_budget=100)
    for k in "abc":
        cache.put(k, object(), arena_bytes=40)
    assert cache.keys() == ["b", "c"]
    assert cache.arena_bytes_total == 80
    assert cache.stats.evictions == 1 and cache.stats.bytes_evicted == 40


def test_byte_budget_respects_lru_refresh_on_hit():
    cache = ScheduleCache(capacity=64, byte_budget=100)
    cache.put("a", 1, arena_bytes=40)
    cache.put("b", 2, arena_bytes=40)
    assert cache.get("a") == 1
    cache.put("c", 3, arena_bytes=40)
    assert cache.keys() == ["a", "c"]
    assert cache.get("b") is None and cache.stats.misses == 1


def test_entry_count_capacity_and_zero_default_bytes():
    cache = ScheduleCache(capacity=2, byte_budget=10**9)
    for key in "abc":
        cache.put(key, object())               # no estimate given: 0 bytes
    assert len(cache) == 2 and cache.stats.evictions == 1
    assert cache.arena_bytes_total == 0


def test_oversized_entry_rejected_without_disturbing_residents():
    cache = ScheduleCache(capacity=64, byte_budget=100)
    cache.put("small", 1, arena_bytes=10)
    built = []
    got = cache.get_or_build("huge", lambda: built.append(1) or "v", arena_bytes=1000)
    assert got == "v" and "huge" not in cache and "small" in cache
    assert cache.arena_bytes_total == 10 and cache.stats.bytes_evicted == 1000
    cache.get_or_build("huge", lambda: built.append(1) or "v", arena_bytes=1000)
    assert len(built) == 2


def test_replacement_invalidate_and_snapshot():
    cache = ScheduleCache(capacity=64, byte_budget=1000)
    cache.put("k", 1, arena_bytes=100)
    cache.put("k", 2, arena_bytes=250)
    assert cache.arena_bytes_total == 250
    cache.put("j", 3, arena_bytes=50)
    snap = cache.snapshot()
    assert snap["size"] == 2 and sum(e["arena_bytes"] for e in snap["entries"]) == 300
    assert cache.invalidate("k") and not cache.invalidate("k")
    assert cache.arena_bytes_total == 50
    cache.clear()
    assert cache.snapshot()["arena_bytes_total"] == 0
    with pytest.raises(ValueError):
        ScheduleCache(byte_budget=0)
    with pytest.raises(ValueError):
        ScheduleCache(capacity=0)


def test_failed_build_stays_retryable():
    cache = ScheduleCache(capacity=4)

    def boom():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError):
        cache.get_or_build("k", boom)
    assert cache.get_or_build("k", lambda: "ok") == "ok"
    assert cache.stats.builds == 1 and cache.stats.misses == 2


def test_memory_budget_pools_bytes_and_evicts_global_lru():
    budget = MemoryBudget(100)
    a = ScheduleCache(capacity=64, budget=budget)
    b = ScheduleCache(capacity=64, budget=budget)
    a.put("a1", 1, arena_bytes=40)
    b.put("b1", 1, arena_bytes=40)
    b.put("b2", 1, arena_bytes=40)
    assert budget.total_bytes() <= 100 and "a1" not in a
    assert b.keys() == ["b1", "b2"]
    assert budget.rebalance_evictions == 1 and budget.bytes_evicted == 40
    snap = a.snapshot()["budget"]
    assert snap == budget.snapshot() and snap["caches"] == 2
    with pytest.raises(ValueError):
        MemoryBudget(0)


def test_memory_budget_released_on_invalidate_and_clear():
    budget = MemoryBudget(1000)
    a = ScheduleCache(capacity=64, budget=budget)
    b = ScheduleCache(capacity=64, budget=budget)
    a.put("k", 1, arena_bytes=100)
    b.put("j", 1, arena_bytes=250)
    assert budget.total_bytes() == 350
    assert a.invalidate("k")
    assert budget.total_bytes() == 250
    b.clear()
    assert budget.total_bytes() == 0
    big = b.get_or_build("huge", lambda: "v", arena_bytes=5000)   # larger than the pool
    assert big == "v" and "huge" not in b and budget.total_bytes() == 0


def test_engine_entries_carry_arena_estimates(model):
    """The engine's shape-derived estimate: the whole KV cache plus the
    step's token buffer."""
    cfg, _ = model
    cache = ScheduleCache(capacity=16)
    eng = _engine(model, cache)
    kv = sum(t.numel() * t.element_size() for t in eng.kv_cache.values())
    by_key = {e["key"]: e["arena_bytes"] for e in cache.snapshot()["entries"]}
    assert sorted(by_key.values()) == sorted([kv + 2 * 8, kv + 8 * 8, kv + 16 * 8])


# -- bucketing -----------------------------------------------------------------

def test_bucketing_policies():
    assert ExactBucketing().bucket(7) == 7
    with pytest.raises(ValueError):
        ExactBucketing(max_length=4).bucket(5)
    with pytest.raises(ValueError):
        ExactBucketing().bucket(0)
    p = ExplicitBuckets((32, 8, 16))
    assert p.buckets == (8, 16, 32) and p.bucket(9) == 16 and p.static_buckets() == (8, 16, 32)
    with pytest.raises(ValueError):
        p.bucket(33)
    with pytest.raises(ValueError):
        ExplicitBuckets(())
    q = PowerOfTwoBuckets(min_bucket=8, max_bucket=64)
    assert q.bucket(1) == 8 and q.bucket(9) == 16 and q.static_buckets() == (8, 16, 32, 64)
    with pytest.raises(ValueError):
        q.bucket(65)
    assert isinstance(make_policy(None), PowerOfTwoBuckets)
    assert isinstance(make_policy("exact"), ExactBucketing)
    assert make_policy("pow2:4:32").bucket(5) == 8
    assert make_policy((8, 16)).bucket(10) == 16
    assert make_policy(p) is p
    with pytest.raises(ValueError):
        make_policy("nope")


@pytest.mark.parametrize("policy", [
    PowerOfTwoBuckets(min_bucket=8, max_bucket=1024),
    ExplicitBuckets((8, 24, 100, 512, 1024)),
    ExactBucketing(max_length=1024),
], ids=["pow2", "explicit", "exact"])
def test_bucket_properties(policy):
    """Every length 1..1024 maps to a bucket that covers it, is a fixed
    point, grows monotonically, and lies in the static family if any."""
    static = policy.static_buckets()
    prev = 0
    for n in range(1, 1025):
        b = policy.bucket(n)
        assert b >= n and policy.bucket(b) == b and b >= prev
        assert static is None or b in static
        prev = b
