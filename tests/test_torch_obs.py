"""The port's trace export and metrics registry against the JAX package's.

The same inputs through both packages' ``obs`` modules give the same
output: the Chrome trace JSON of the same recorded events (a scripted
tracer, a traced synchronous dispatcher run, a composed run, and worker
events merged with ``extra_events``) equal up to process ids and
timestamps; ``validate_trace``'s findings on broken traces; the analysis
helpers; and the Prometheus and JSON expositions of a registry fed the
same snapshots, byte for byte.  Then the port's own traced threaded run
validates.
"""

from __future__ import annotations

import copy
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.dispatch as JD  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro.serving as JS  # noqa: E402
import repro_torch.dispatch as TD  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
import repro_torch.serving as TS  # noqa: E402

PKGS = {"jax": (JD, JO, JS), "torch": (TD, TO, TS)}
PROMPT = np.array([1, 2, 3], np.int64)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class SeqEngine:
    """Request ``rid`` emits ``rid * 1000 + i``, one token per step."""

    def __init__(self, slots=1, key=None):
        self.slots = [None] * slots
        self.queue = []
        self.key = key
        self._submit_hook = None

    def submit(self, req):
        self.queue.append(req)
        if self._submit_hook is not None:
            self._submit_hook()

    def set_submit_hook(self, hook):
        self._submit_hook = hook

    def free_slots(self):
        return sum(1 for s in self.slots if s is None) - len(self.queue)

    @property
    def idle(self):
        return not self.queue and all(s is None for s in self.slots)

    def step(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self.slots[i] = self.queue.pop(0)
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(req.rid * 1000 + len(req.generated))
            req.t_first = req.t_first or 1.0
            if len(req.generated) >= req.max_new_tokens:
                req.done, req.t_done, self.slots[i] = True, 2.0, None
                finished.append(req)
        return finished


class ComposableEngine(SeqEngine):
    def compose_key(self):
        return ("fake", self.key, len(self.slots))


def _normalise(trace: dict) -> list:
    """The trace's events without process ids and timestamps."""
    out = []
    for ev in trace["traceEvents"]:
        ev = dict(ev)
        ev.pop("pid", None)
        ev.pop("ts", None)
        if "dur" in ev:
            assert ev.pop("dur") >= 0
        out.append(ev)
    return out


def _scripted(D, O, S):
    tr = O.SpanTracer().enable()
    tr.instant("submit", cat="request", lane="a", rid=1, args={"n": 2})
    tr.async_begin("request", 1, lane="a")
    tr.complete("step:a", 10.0, 0.004, cat="step", lane="a", args={"tokens": 3})
    tr.counter("ready", {"lanes": 2})
    tr.complete("prefill", 10.001, 0.002, cat="engine", rid=1, args={"bucket": 16})
    tr.async_end("request", 1, lane="a")
    tr.instant("cache.hit", cat="cache")
    return O.to_chrome_trace(tr.drain())


def _dispatched(D, O, S, composed=False):
    tr = O.SpanTracer().enable()
    disp = D.Dispatcher(max_pending=100, tracer=tr, fairness="drr",
                        composer=D.BatchComposer() if composed else None)
    for name in ("a", "b", "c"):
        eng = ComposableEngine(2, key="k" if name != "c" else "z") if composed else SeqEngine(2)
        disp.register_model(name, eng)
    for rid in range(7):
        disp.submit("abc"[rid % 3], PROMPT, max_new_tokens=1 + rid % 3, tenant=f"t{rid}")
    disp.run_until_drained()
    return O.to_chrome_trace(tr.drain())


def _merged(D, O, S):
    tr = O.SpanTracer().enable()
    tr.complete("step:a", 5.0, 0.01, cat="step", lane="a")
    worker = [O.TraceEvent(5.002, "X", "step", "step:a", 0.006, None, "a", {"finished": 1},
                           77, "MainThread", pid=4321),
              O.TraceEvent(5.003, "i", "cache", "cache.hit", 0.0, None, None, {}, 77,
                           "MainThread", pid=4321)]
    return O.to_chrome_trace(tr.drain(), extra_events=worker)


TRACES = {"scripted": _scripted, "dispatched": _dispatched,
          "composed": lambda D, O, S: _dispatched(D, O, S, composed=True), "merged": _merged}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_chrome_trace_equal_modulo_pid_and_ts(name):
    j = TRACES[name](*PKGS["jax"])
    t = TRACES[name](*PKGS["torch"])
    assert _normalise(j) == _normalise(t)
    assert JO.validate_trace(j) == TO.validate_trace(t) == []
    for fn in ("step_spans", "composed_spans"):
        got = [tuple(x for x in row if not isinstance(x, float))
               for row in getattr(TO, fn)(t)]
        want = [tuple(x for x in row if not isinstance(x, float))
                for row in getattr(JO, fn)(j)]
        assert got == want
    assert TO.worker_overlap(t)[0] == JO.worker_overlap(j)[0]
    if name == "merged":
        tracks = {ev["args"]["name"] for ev in t["traceEvents"]
                  if ev.get("ph") == "M" and ev.get("name") == "process_name"}
        assert tracks == {"dispatcher (parent)", "worker pid=4321"}


def _broken_traces() -> list:
    good = _scripted(*PKGS["jax"])
    out = [None, [], {"traceEvents": "x"}, {"traceEvents": [{"ph": "Z"}]}]
    for mutate in ("drop_ts", "neg_dur", "drop_id", "unbalanced", "unserialisable"):
        tr = copy.deepcopy(good)
        evs = tr["traceEvents"]
        if mutate == "drop_ts":
            next(e for e in evs if e["ph"] == "X").pop("ts")
        elif mutate == "neg_dur":
            next(e for e in evs if e["ph"] == "X")["dur"] = -1
        elif mutate == "drop_id":
            next(e for e in evs if e["ph"] == "b").pop("id")
        elif mutate == "unbalanced":
            evs.remove(next(e for e in evs if e["ph"] == "e"))
        else:
            evs[0]["args"] = {"x": object()}
        out.append(tr)
    return out


@pytest.mark.parametrize("i", range(9))
def test_validate_trace_findings_equal(i):
    tr = _broken_traces()[i]
    want = JO.validate_trace(tr)
    assert TO.validate_trace(tr) == want
    assert want


# -- the metrics registry ---------------------------------------------------

class _Snap:
    def __init__(self, snap):
        self._snap = snap

    def snapshot(self):
        return copy.deepcopy(self._snap)


class _AsyncSnap(_Snap):
    builds_by_stepper = {}


class _Stats:
    def __init__(self, stats):
        self._stats = stats

    def stats(self):
        return dict(self._stats)


def _jax_dispatch_snapshot() -> dict:
    """A real snapshot: the JAX package's synchronous dispatcher after a
    run with priority classes and a composer, its times replaced by fixed
    numbers so both registries see one input."""
    disp = JD.Dispatcher(max_pending=100, fairness="priority:drr", composer=JD.BatchComposer())
    for name, cls in (("a", 0), ("b", 1), ("c", 1)):
        disp.register_model(name, ComposableEngine(2, key="k"), priority_class=cls,
                            latency_target_ms=1e6 if cls == 0 else None)
    for rid in range(9):
        disp.submit("abc"[rid % 3], PROMPT, max_new_tokens=2)
    disp.run_until_drained()
    snap = json.loads(json.dumps(disp.snapshot(), default=str))

    def fix(x, depth=0):
        if isinstance(x, dict):
            return {k: fix(v, depth + 1) for k, v in x.items()}
        if isinstance(x, list):
            return [fix(v, depth + 1) for v in x]
        if isinstance(x, float):
            return round(x * 1e3) / 7.0 if x < 1e6 else 1.5
        return x

    snap = fix(snap)
    snap["async"] = {"steppers": 3, "futures_pending": 0, "builds_on_thread": 0,
                     "arbiter": {"grants": 12, "timed_grants": 1, "timed_wakeups": 2,
                                 "notify_wakeups": 9, "wakeups_per_grant": 0.9166,
                                 "inflight": 0, "parked": 3}}
    snap["pool"] = {"size": 2, "busy_mean": 1.25, "busy_peak": 2, "samples": 12}
    return snap


PLANE = {"n_workers": 2, "serving": 1, "start_method": "spawn", "workers": [
    {"worker": 0, "index": 0, "device": 0, "pid": 11, "status": "serving", "lanes": ["a", "b"],
     "restarts": 1, "heartbeat_age_s": 0.25, "error": None,
     "stats": {"device": 0, "lanes": 2, "steps": 40, "tokens": 80, "cache_bytes": 4096,
               "kernel_launches": {"flash_attention": 64}}},
    {"worker": 1, "index": 1, "device": 1, "pid": 12, "status": "abandoned", "lanes": [],
     "restarts": 3, "heartbeat_age_s": None, "error": "WorkerSetupError()", "stats": {}}]}
CACHE = {"capacity": 64, "entries": 5, "arena_bytes_total": 123456, "byte_budget": None,
         "stats": {"hits": 10, "misses": 5, "evictions": 1, "bytes_evicted": 99,
                   "builds": 5, "build_seconds": 0.125, "hit_rate": 0.6667}}
TRACER = {"enabled": True, "buffered": 12, "emitted": 30, "dropped": 2, "rings": 3}


def _registry(O, dispatch, with_plane: bool):
    reg = O.MetricsRegistry()
    O.register_dispatch(reg, _AsyncSnap(dispatch) if "async" in dispatch else _Snap(dispatch))
    O.register_cache(reg, _Snap(CACHE))
    O.register_tracer(reg, _Stats(TRACER))
    if with_plane:
        O.register_worker_plane(reg, _Snap(PLANE))
    c = O.Counter("requests", help="served")
    c.inc(3)
    g = O.Gauge("depth")
    g.set(4.5)
    h = O.Histogram("step_s", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.002, 0.05, 0.5):
        h.observe(v)
    reg.register("bench", c)
    reg.register("bench", g)
    reg.register("bench", h)
    return reg


@pytest.mark.parametrize("variant", ["minimal", "dispatcher", "with-plane"])
def test_prometheus_and_json_expositions_equal(variant):
    dispatch = ({"requests_done": 3, "pending": 0, "ttft_ms": {"count": 3, "p50": 1.0}}
                if variant == "minimal" else _jax_dispatch_snapshot())
    j = _registry(JO, dispatch, variant == "with-plane")
    t = _registry(TO, dispatch, variant == "with-plane")
    assert t.to_prometheus() == j.to_prometheus()
    assert t.to_json(indent=1) == j.to_json(indent=1)
    assert t.groups == j.groups
    prom = t.to_prometheus()
    for family in ("repro_dispatcher_", "repro_schedule_cache_", "repro_tracer_"):
        assert family in prom
    assert ("repro_workers_" in prom) == (variant == "with-plane")


@pytest.mark.parametrize("seed", range(3))
def test_samples_from_dict_equal(seed):
    rng = np.random.default_rng(seed)
    d = {"a": float(rng.random()), "b": {"c": int(rng.integers(9)), "p50": 1.0, "p99": 2.0,
                                         "count": 4, "mean": 1.5},
         "flag": True, "name": "x", "nested": {"deep": {"v": float(rng.random())}}}
    kw = dict(prefix="pre.", labels=(("lane", "a"),), counters=("pre.a",))
    want = [s.as_dict() for s in JO.samples_from_dict(d, **kw)]
    assert [s.as_dict() for s in TO.samples_from_dict(d, **kw)] == want


# -- the port's own traced threaded run -------------------------------------

@pytest.mark.timeout(60)
def test_port_traced_pool_run_validates_and_overlaps():
    tr = TO.SpanTracer().enable()
    disp = TD.AsyncDispatcher(stepping="pool", pool_size=2, tracer=tr, max_pending=100)
    for name in ("a", "b"):
        disp.register_model(name, SeqEngine(2))
    reg = TO.MetricsRegistry()
    TO.register_dispatch(reg, disp)
    TO.register_tracer(reg, tr)
    with disp:
        futs = [disp.submit("ab"[i % 2], PROMPT, max_new_tokens=3) for i in range(8)]
        for f in futs:
            assert len(f.result(timeout=30).generated) == 3
        prom = reg.to_prometheus()
    trace = TO.to_chrome_trace(tr.drain())
    assert TO.validate_trace(trace) == []
    threads = {ev["args"]["name"] for ev in trace["traceEvents"]
               if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    assert {"repro-dispatch-step[pool-0]", "repro-dispatch-step[pool-1]"} & threads
    assert "repro_arbiter_grants" in prom and "repro_tracer_emitted" in prom
