"""The port's control plane against the JAX package's, on fakes, exactly.

Every test here runs one scripted input through both packages' classes
(``repro.dispatch`` and ``repro_torch.dispatch``) and compares what they
observably do, with ``==``: the lifecycle tables over every pair of states,
each fairness policy's grant sequence over the same workload (lottery from
a fixed seed, quotas on a fake clock), the SLO plane's admission and
overload decisions on a fake clock, ``percentile`` and ``DispatchMetrics``
snapshots, the batch composer's groups, and scripted scheduling scenarios
in virtual time (grants, per-class latencies, preemptions, rejections and
sheds).  The engines are pure-Python fakes, duck-typed to the dispatcher's
engine contract, so nothing here touches a model.

Then the two seams the port adds: each seal and step of a serving engine
runs with its CUDA device current on the calling thread, whichever stepper
drives it (real CPU engines told they run on ``cuda:1`` and ``cuda:2``,
``torch.cuda.device`` replaced by a recorder, so no card is needed), and a
seal never overlaps a replay (the capture lock), observed on fake engines
and on the real CPU engine.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import threading
import time

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
from repro_torch.core import capture  # noqa: E402

PKGS = {"jax": (JD, JS.Request), "torch": (TD, TS.Request)}
PROMPT = np.array([1, 2, 3], np.int64)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def both(fn):
    """``fn(dispatch_module, Request)`` run on each package; returns
    ``(jax_result, port_result)``."""
    return fn(*PKGS["jax"]), fn(*PKGS["torch"])


class FakeClock:
    """Virtual monotonic clock."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class SeqEngine:
    """Request ``rid`` emits ``rid * 1000 + i``, one token per step; each
    step appends the engine's name to the shared ``log``."""

    def __init__(self, name, log, slots=1, clock=None):
        self.name = name
        self.log = log
        self.slots = [None] * slots
        self.queue = []
        self._clock = clock or time.perf_counter

    def submit(self, req):
        self.queue.append(req)

    def free_slots(self):
        return sum(1 for s in self.slots if s is None) - len(self.queue)

    @property
    def idle(self):
        return not self.queue and all(s is None for s in self.slots)

    def step(self):
        self.log.append(self.name)
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self.slots[i] = self.queue.pop(0)
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(req.rid * 1000 + len(req.generated))
            if not req.t_first:
                req.t_first = self._clock()
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                req.t_done = self._clock()
                self.slots[i] = None
                finished.append(req)
        return finished


class ComposableEngine(SeqEngine):
    """A ``SeqEngine`` that opts into the batch composer: equal ``key``s
    give equal ``compose_key()``s."""

    def __init__(self, name, log, slots=1, key="shared"):
        super().__init__(name, log, slots=slots)
        self.key = key
        self._submit_hook = None

    def compose_key(self):
        return ("fake", self.key, len(self.slots))

    def set_submit_hook(self, hook):
        self._submit_hook = hook

    def submit(self, req):
        super().submit(req)
        if self._submit_hook is not None:
            self._submit_hook()


# -- the import surfaces ----------------------------------------------------

MODULES = ("dispatch.errors", "dispatch.lifecycle", "dispatch.metrics", "dispatch.fairness",
           "dispatch.slo", "dispatch.batching", "dispatch.dispatcher", "dispatch.journal",
           "dispatch.workers", "dispatch.async_dispatcher", "obs.export", "obs.registry",
           "serving.spec", "dispatch", "obs", "serving")


def _public(mod) -> set:
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and getattr(v, "__module__", mod.__name__) == mod.__name__
            and (inspect.isclass(v) or inspect.isfunction(v))}


@pytest.mark.parametrize("name", MODULES)
def test_public_names_cover_the_jax_module(name):
    """Each ported module offers every public name of its JAX counterpart
    (``__all__`` where there is one); the worker plane's
    ``xla_host_devices`` is a parameter, not a name, and is gone."""
    import importlib

    jmod = importlib.import_module(f"repro.{name}")
    tmod = importlib.import_module(f"repro_torch.{name}")
    missing = _public(jmod) - set(dir(tmod))
    assert not missing, missing
    if hasattr(jmod, "__all__"):
        assert set(jmod.__all__) <= set(tmod.__all__)


def test_worker_plane_signature_drops_only_xla_host_devices():
    jsig = inspect.signature(JD.WorkerPlane.__init__).parameters
    tsig = inspect.signature(TD.WorkerPlane.__init__).parameters
    assert set(jsig) - set(tsig) == {"xla_host_devices"}
    assert set(tsig) - set(jsig) == {"device"}
    assert tsig["device"].default == "cuda"
    assert tsig["start_method"].default == "spawn"


# -- lifecycle --------------------------------------------------------------

@pytest.mark.parametrize("entity", ["request", "lane"])
def test_lifecycle_tables_equal_over_all_state_pairs(entity):
    def table(D, _R):
        states = D.RequestState if entity == "request" else D.LaneState
        check = (D.check_request_transition if entity == "request"
                 else D.check_lane_transition)
        names = sorted(v for k, v in vars(states).items()
                       if not k.startswith("_") and isinstance(v, str))
        out = {}
        for src in names + [""]:
            for dst in names:
                try:
                    check(src, dst)
                    out[(src, dst)] = "ok"
                except D.IllegalTransition as exc:
                    out[(src, dst)] = (exc.entity, exc.src, exc.dst)
        tab = D.REQUEST_TRANSITIONS if entity == "request" else D.LANE_TRANSITIONS
        return out, {k: sorted(v) for k, v in tab.items()}, sorted(D.TERMINAL_STATES)

    j, t = both(table)
    assert j == t
    assert "ok" in j[0].values() and any(v != "ok" for v in j[0].values())


# -- fairness ---------------------------------------------------------------

LANES = (("a", 3.0, 0), ("b", 1.0, 1), ("c", 1.0, 1))


def _policy(D, spec, clock):
    if spec == "quota":
        # 30 tokens per virtual second, bursts of 4: the clock moves one
        # virtual second per grant, so the buckets refill mid-run
        return D.QuotaFairness(rate=30.0, burst=4.0, clock=clock)
    return spec


@pytest.mark.parametrize("spec", ["round_robin", "weighted", "drr", "drr:0.5", "lottery:7",
                                  "quota", "priority:round_robin", "priority:drr",
                                  "priority:lottery:3"])
def test_fairness_grant_sequence_equal(spec):
    """Three lanes (weights 3, 1, 1; classes 0, 1, 1 where the policy has
    classes), six requests each of 1-5 tokens, served by the synchronous
    dispatcher's ``step()`` until drained: the order in which lanes stepped,
    the tokens, and the policy's own snapshot are equal."""
    def run(D, R):
        clock = FakeClock()
        log = []
        disp = D.Dispatcher(max_pending=1000, fairness=_policy(D, spec, clock))
        for name, w, cls in LANES:
            disp.register_model(name, SeqEngine(name, log, slots=2), weight=w,
                                priority_class=cls if spec.startswith("priority") else 0)
        rid = 0
        for i in range(6):
            for name, _, _ in LANES:
                disp.submit_request(name, R(rid=rid, prompt=PROMPT,
                                            max_new_tokens=1 + (rid * 7) % 5))
                rid += 1
        done = []
        for _ in range(1000):
            if disp.idle:
                break
            done.extend(disp.step())
            clock.advance(1.0)
        tokens = sorted((r.model, r.rid, tuple(r.generated)) for r in done)
        return log, tokens, disp.snapshot()["fairness"]

    j, t = both(run)
    assert j == t
    assert len(j[1]) == 18


@pytest.mark.parametrize("spec", ["round_robin", "weighted", "drr", "priority:round_robin"])
def test_fairness_peek_and_charge_equal(spec):
    """The arbiter's primitive, driven directly: ``fairness_peek`` over a
    changing ready set, each pick granted and charged, for 60 grants."""
    def run(D, R):
        log = []
        disp = D.Dispatcher(max_pending=1000, fairness=spec)
        for name, w, cls in LANES:
            disp.register_model(name, SeqEngine(name, log, slots=1), weight=w,
                                priority_class=cls if spec.startswith("priority") else 0)
        for rid in range(30):
            disp.submit_request(LANES[rid % 3][0], R(rid=rid, prompt=PROMPT,
                                                     max_new_tokens=2))
        picks = []
        for i in range(60):
            active = disp.active_lanes()
            if not active:
                break
            ready = [n for n in active if (i + len(n)) % 4 != 0] or active
            pick = disp.fairness_peek(active, ready)
            picks.append(tuple(pick))
            if pick:
                disp.step_lane(pick[0])
        return picks, disp.snapshot()["fairness"]

    j, t = both(run)
    assert j == t


# -- SLO --------------------------------------------------------------------

OBSERVATIONS = [(0.0, 0, 0.5), (0.1, 0, 0.5), (0.1, 1, 0.01), (0.2, 0, 0.5), (0.5, 0, 0.05),
                (1.0, 0, 0.6), (0.2, 0, 0.6), (0.3, 1, 0.9), (0.3, 1, 0.9), (0.3, 1, 0.9),
                (3.0, 0, 0.01), (2.0, 0, 0.01), (0.1, 1, 0.01), (6.0, 1, 0.01), (0.1, 0, 0.7),
                (0.1, 0, 0.7), (0.1, 0, 0.7)]


def test_adaptive_controller_decisions_equal():
    """The same latencies (against a 0.1 s target) on the same fake clock:
    the overload flags after each observation, the trips and the
    snapshots are equal."""
    def run(D, R):
        clock = FakeClock()
        ctl = D.AdaptiveController(window=3, spike_factor=2.0, cooldown_s=4.0, clock=clock)
        flags = []
        for dt, cls, lat in OBSERVATIONS:
            clock.advance(dt)
            ctl.observe(cls, lat, 0.1)
            flags.append((ctl.overloaded(0), ctl.overloaded(1), ctl.any_overloaded()))
        return flags, ctl.trips, ctl.snapshot()

    j, t = both(run)
    assert j == t
    assert any(f[0] for f in j[0]) and not all(f[0] for f in j[0])


def test_slo_admission_and_shed_choice_equal():
    """Admission at depths 0..5 on lanes with and without targets and
    estimates, the deadlines it stamps, ``pick_shed`` over candidate sets,
    and the SLO snapshot."""
    def run(D, R):
        clock = FakeClock()
        slo = D.SLOPolicy(clock=clock)
        slo.register_lane("i", priority_class=0, latency_target_ms=50.0)
        slo.register_lane("j", priority_class=1, latency_target_ms=300.0)
        slo.register_lane("batch", priority_class=2)
        slo.set_service_estimate(0, 0.020)
        out = []
        for step in range(4):
            clock.advance(0.25)
            slo.on_step("j", 0.04 + 0.01 * step)
            for lane in ("i", "j", "batch"):
                for depth in range(6):
                    try:
                        out.append((lane, depth, round(slo.admit(lane, depth), 9)))
                    except D.AdmissionRejected as exc:
                        out.append((lane, depth, "rejected", exc.priority_class,
                                    round(exc.deadline, 9)))
        sheds = [D.SLOPolicy.pick_shed(c) for c in (
            [("i", 0, 1.0), ("b", 2, 0.5), ("c", 2, 0.7)],
            [("i", 0, 1.0), ("j", 0, 3.0)],
            [("x", 1, 0.0)])]
        return out, sheds, slo.snapshot()

    j, t = both(run)
    assert j == t
    assert any(o[2] == "rejected" for o in j[0])


# -- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("q", [0, 1, 25, 50, 90, 95, 99, 99.9, 100])
def test_percentile_equal(q):
    rng = np.random.default_rng(int(q * 10))
    for n in (1, 2, 7, 100, 1001):
        vals = rng.exponential(size=n).tolist()
        assert JD.percentile(vals, q) == TD.percentile(vals, q)
    assert JD.percentile([], q) == TD.percentile([], q)


def test_dispatch_metrics_snapshot_equal():
    """One scripted event stream (submits, steps, grants, classes,
    preemptions, sheds, rejections, deadlines, occupancy, composed steps,
    finished requests with fixed timestamps) into both ``DispatchMetrics``:
    equal snapshots."""
    def run(D, R):
        m = D.DispatchMetrics()
        m.set_lane_class("a", 0)
        m.set_lane_class("b", 1)
        for i in range(40):
            m.on_submit(1.0 + 0.01 * i)
            lane = "ab"[i % 2]
            m.on_engine_step(lane, 0.002 + 0.0001 * i, tokens=i % 5)
            m.on_grant(0.0001 * (i % 7), lane=lane)
            m.on_grant_cost(0.00001 * i)
            m.on_ready_size(i % 4)
            m.on_pool_occupancy(i % 3, 4)
            if i % 9 == 0:
                m.on_preemption(1)
                m.on_shed(1)
                m.on_reject()
                m.on_admission_reject(0)
            m.on_deadline(i % 2, missed=i % 3 == 0)
            m.on_composed_step(0.003, occupied=1 + i % 4, capacity=4,
                               tokens_by_lane={"a": 1, "b": i % 2})
            r = R(rid=i, prompt=PROMPT, max_new_tokens=3, model=lane)
            r.generated = [1, 2, 3][: 1 + i % 3]
            r.truncated = i % 11 == 0
            r.error = "x" if i % 13 == 0 else None
            r.t_submit, r.t_first, r.t_done = 1.0 + 0.01 * i, 1.05 + 0.01 * i, 1.2 + 0.02 * i
            m.observe_request(r)
        m.drop_engine("b")
        m.on_engine_step("b", 1.0)
        return m.snapshot(cache_stats={"hits": 3})

    j, t = both(run)
    assert j == t


# -- batch composer ---------------------------------------------------------

def test_batch_composer_groups_equal():
    """Four composable lanes over two compatibility keys and one plain
    lane: the composer's groups, the step log and the tokens after a
    synchronous drain are equal."""
    def run(D, R):
        log = []
        disp = D.Dispatcher(max_pending=1000, composer=D.BatchComposer(), fairness="drr")
        for name, key in (("a", "k1"), ("b", "k1"), ("c", "k2"), ("d", "k1")):
            disp.register_model(name, ComposableEngine(name, log, slots=3, key=key),
                                weight=1.0 + (name == "a"))
        disp.register_model("e", SeqEngine("e", log, slots=2))
        groups = disp.composer.snapshot()
        for rid in range(15):
            disp.submit_request("abcde"[rid % 5], R(rid=rid, prompt=PROMPT,
                                                    max_new_tokens=1 + rid % 4))
        done = disp.run_until_drained()
        return (groups, log, sorted((r.model, r.rid, tuple(r.generated)) for r in done),
                disp.composer.snapshot())

    j, t = both(run)
    assert j == t
    assert len(j[2]) == 15


# -- scripted scenarios in virtual time -------------------------------------

class ScenarioRunner:
    """Drives a package's real ``Dispatcher`` through a scripted trace in
    virtual time, as the arbiter would: ``workers`` virtual executors, each
    granted quantum of ``step_cost`` seconds through ``fairness_peek`` over
    the indexed ready set (lanes executing excluded), the real
    ``step_lane`` at each quantum's end.  Returns grants, per-class
    ready-to-grant latencies, tokens, rejections, sheds and preemptions."""

    def __init__(self, D, R, *, fairness, workers=1, step_cost=1.0, estimate=None):
        self.D, self.R = D, R
        self.clock = FakeClock()
        self.slo = D.SLOPolicy(clock=self.clock)
        if estimate is not None:
            self.slo.set_service_estimate(*estimate)
        self.disp = D.Dispatcher(max_pending=1_000_000, fairness=fairness, slo=self.slo)
        self.workers, self.step_cost = workers, step_cost
        self._ready_at: dict = {}
        self.disp.set_lane_event_hook(self._event)

    def _event(self, name, active):
        if active:
            self._ready_at.setdefault(name, self.clock())
        else:
            self._ready_at.pop(name, None)

    def add_lane(self, name, *, priority_class=0, latency_target_ms=None, slots=1):
        self.disp.register_model(name, SeqEngine(name, [], slots=slots, clock=self.clock),
                                 priority_class=priority_class,
                                 latency_target_ms=latency_target_ms)

    def run(self, trace, shed_every=0):
        out = {"grants": [], "latency": {}, "tokens": {}, "rejected": [], "shed": []}

        def record(model, req):
            if getattr(req, "_admission_error", None) is not None:
                out["shed"].append((model, req.rid))
            else:
                out["tokens"][(model, req.rid)] = list(req.generated)

        busy: list = []
        i = 0
        trace = sorted(trace)
        while True:
            now = self.clock()
            while i < len(trace) and trace[i][0] <= now + 1e-9:
                _, lane, n = trace[i]
                try:
                    self.disp.submit_request(lane, self.R(
                        rid=i, prompt=PROMPT, max_new_tokens=n, on_complete=record))
                except self.D.AdmissionRejected:
                    out["rejected"].append((now, lane, i))
                i += 1
            if shed_every and int(now) % shed_every == 0:
                self.disp.shed(now=now)
            while len(busy) < self.workers:
                executing = {lane for _, lane in busy}
                active = self.disp.active_lanes()
                ready = [lane for lane in active if lane not in executing]
                picks = [p for p in self.disp.fairness_peek(active, ready) if p in ready]
                if not picks:
                    break
                lane = picks[0]
                out["grants"].append((now, lane))
                cls = self.slo.lane_class(lane)
                out["latency"].setdefault(cls, []).append(now - self._ready_at.pop(lane, now))
                busy.append((now + self.step_cost, lane))
            if not busy:
                if i >= len(trace):
                    break
                self.clock.t = max(self.clock.t, trace[i][0])
                continue
            t_next = min(t for t, _ in busy)
            if i < len(trace):
                t_next = min(t_next, trace[i][0])
            self.clock.t = max(self.clock.t, t_next)
            for entry in [e for e in busy if e[0] <= self.clock() + 1e-9]:
                busy.remove(entry)
                self.disp.step_lane(entry[1])
                if self.disp.lane_active(entry[1]):
                    self._ready_at[entry[1]] = self.clock()
        snap = self.disp.snapshot()
        out["preemptions"] = snap.get("preemptions", 0)
        # the dispatcher stamps t_submit on the host clock and the fake
        # engines t_done on the virtual one, so e2e times are left out
        out["classes"] = {cls: {k: v for k, v in c.items() if k != "e2e_ms"}
                          for cls, c in (snap.get("classes") or {}).items()}
        return out


SCENARIOS = {
    # interactive work arriving mid-quantum over a saturated batch tier
    "precedence": dict(
        fairness="priority:round_robin", workers=1,
        lanes=[("inter", 0, None), ("b1", 1, None), ("b2", 1, None)],
        trace=[(0.0, "b1", 6), (0.0, "b2", 6), (3.5, "inter", 2)]),
    # periodic interactive arrivals over two long batch streams, two workers
    "overload": dict(
        fairness="priority:drr", workers=2,
        lanes=[("inter", 0, None), ("b1", 1, None), ("b2", 1, None)],
        trace=[(0.0, "b1", 30), (0.0, "b2", 30)]
        + [(3.3 + 5.0 * k, "inter", 1) for k in range(8)]),
    # a 2 s budget at a pinned 1 s per quantum: two admitted, two refused
    "admission": dict(
        fairness="priority:round_robin", workers=1, estimate=(0, 1.0),
        lanes=[("inter", 0, 2000.0)],
        trace=[(0.0, "inter", 1)] * 4),
    # targeted lanes under shedding: the lowest class, latest deadline goes
    "shed": dict(
        fairness="priority:round_robin", workers=1, shed_every=2,
        lanes=[("inter", 0, 3000.0), ("batch", 1, 4000.0)],
        trace=[(0.0, "inter", 3), (0.0, "batch", 3), (0.5, "batch", 2),
               (1.0, "batch", 2), (1.0, "inter", 2), (2.0, "batch", 4)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_results_equal(name):
    """The same scripted scenario through both packages' dispatchers in
    virtual time: grant log, per-class latencies, tokens, rejections,
    sheds, preemptions and per-class snapshot are equal."""
    sc = SCENARIOS[name]

    def run(D, R):
        r = ScenarioRunner(D, R, fairness=sc["fairness"], workers=sc["workers"],
                           estimate=sc.get("estimate"))
        for lane, cls, target in sc["lanes"]:
            r.add_lane(lane, priority_class=cls, latency_target_ms=target)
        return r.run(sc["trace"], shed_every=sc.get("shed_every", 0))

    j, t = both(run)
    assert j == t
    assert j["grants"]
    if name == "admission":
        assert [lane for _, lane, _ in j["rejected"]] == ["inter", "inter"]


# -- the stepping thread's CUDA device --------------------------------------

class _DeviceRecorder:
    """Stands in for ``torch.cuda.device`` / ``current_device``: the
    current device is per thread, as CUDA's is."""

    def __init__(self) -> None:
        self.local = threading.local()
        self.entered: list = []

    def current_device(self) -> int:
        return getattr(self.local, "dev", 0)

    def device(self, dev):
        rec = self

        class _Ctx:
            def __enter__(self):
                self.prev = rec.current_device()
                rec.local.dev = torch.device(dev).index
                rec.entered.append(rec.local.dev)

            def __exit__(self, *exc):
                rec.local.dev = self.prev

        return _Ctx()


def _engine_on(device, params, cfg):
    """A real serving engine built and sealed on the CPU, then told it runs
    on ``device``: its steps still run the CPU's eager steps (every bucket
    is sealed and the cache never evicts), but they enter ``device`` as an
    engine there would.  Records the current CUDA device of every step."""
    eng = TS.ServingEngine(cfg, params, max_slots=2, max_len=32, bucketing=(8,),
                           device="cpu")
    eng.device = torch.device(device)
    eng.seen = []
    run = eng._step_locked

    def step_locked():
        eng.seen.append(torch.cuda.current_device())
        return run()

    eng._step_locked = step_locked
    return eng


@pytest.fixture(scope="module")
def _smoke():
    import repro_torch.configs as C
    from repro_torch.launch.serve import init_params

    cfg = C.get("stablelm-1.6b", smoke=True)
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.mark.timeout(60)
@pytest.mark.parametrize("stepping", ["per-engine", "pool", "single"])
def test_stepper_enters_its_engines_device(stepping, monkeypatch, _smoke):
    """Serving engines on ``cuda:1`` and ``cuda:2`` and one on the CPU,
    stepped by the async dispatcher's threads: every step of a CUDA engine
    runs with that engine's device current on the stepping thread (a pool
    thread serves both, so the device changes between its quanta), and the
    CPU engine's steps enter no device.  The engine owns the rule
    (``ServingEngine.device_scope``), so any stepper gets it."""
    cfg, params = _smoke
    rec = _DeviceRecorder()
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_device", rec.current_device)
    engines = {name: _engine_on(dev, params, cfg)
               for name, dev in (("one", "cuda:1"), ("two", "cuda:2"), ("host", "cpu"))}
    disp = TD.AsyncDispatcher(stepping=stepping, pool_size=1, max_pending=100)
    for name, eng in engines.items():
        disp.register_model(name, eng)
    with disp:
        futs = [disp.submit(name, PROMPT, max_new_tokens=3) for name in engines for _ in range(3)]
        for f in futs:
            assert len(f.result(timeout=30).generated) == 3
    assert engines["one"].seen and set(engines["one"].seen) == {1}
    assert engines["two"].seen and set(engines["two"].seen) == {2}
    assert engines["host"].seen and set(engines["host"].seen) == {0}
    assert set(rec.entered) == {1, 2}


def test_device_scope_of_engines_without_a_cuda_device(monkeypatch, _smoke):
    """A CPU engine seals and steps in no device context; the same engine
    on ``cuda:1`` seals with that device current."""
    cfg, params = _smoke
    rec = _DeviceRecorder()
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_device", rec.current_device)
    host = _engine_on("cpu", params, cfg)
    assert isinstance(host.device_scope(), contextlib.nullcontext)
    host.submit(TS.Request(rid=0, prompt=PROMPT, max_new_tokens=2))
    host.run_until_drained()
    assert host.seen and set(host.seen) == {0} and rec.entered == []
    sealed = []
    monkeypatch.setattr(host, "_seal_now",
                        lambda fn, *ex: sealed.append(torch.cuda.current_device()))
    host.device = torch.device("cuda:1")
    host._seal(None)
    assert sealed == [1] and rec.entered == [1]
    assert torch.cuda.current_device() == 0


# -- capture against replay -------------------------------------------------

class _Intervals:
    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.spans: list = []

    def add(self, kind, t0, t1):
        with self.mu:
            self.spans.append((kind, t0, t1))


class ReplayEngine(SeqEngine):
    """A ``SeqEngine`` whose step replays under the capture lock, as the
    serving engine's device sections do, and logs the interval."""

    def __init__(self, name, spans, slots=2):
        super().__init__(name, [], slots=slots)
        self.spans = spans

    def step(self):
        with capture.CAPTURE_LOCK.replaying():
            t0 = time.perf_counter()
            time.sleep(0.002)
            out = super().step()
            self.spans.add("replay", t0, time.perf_counter())
        return out


class SealingEngine(ReplayEngine):
    """Seals (holds the capture lock exclusively) while it is built."""

    def __init__(self, name, spans):
        super().__init__(name, spans)
        for _ in range(3):
            with capture.CAPTURE_LOCK.capturing():
                t0 = time.perf_counter()
                time.sleep(0.02)
                spans.add("capture", t0, time.perf_counter())


@pytest.mark.timeout(60)
@pytest.mark.parametrize("stepping", ["per-engine", "pool"])
def test_registering_a_lane_seals_between_replays(stepping):
    """Lane A steps (replaying) on stepper threads while lane B registers,
    sealing three times on this thread: no seal overlaps a replay, A keeps
    stepping before, between and after the seals, and B then serves."""
    spans = _Intervals()
    a = ReplayEngine("a", spans)
    disp = TD.AsyncDispatcher(stepping=stepping, pool_size=2, max_pending=1000)
    disp.register_model("a", a)
    with disp:
        futs = [disp.submit("a", PROMPT, max_new_tokens=40) for _ in range(4)]
        time.sleep(0.02)
        disp.register_model("b", SealingEngine("b", spans))
        futs += [disp.submit("b", PROMPT, max_new_tokens=3) for _ in range(2)]
        for f in futs:
            f.result(timeout=30)
    caps = [(t0, t1) for kind, t0, t1 in spans.spans if kind == "capture"]
    reps = [(t0, t1) for kind, t0, t1 in spans.spans if kind == "replay"]
    assert len(caps) == 3
    for c0, c1 in caps:
        for r0, r1 in reps:
            assert r1 <= c0 or r0 >= c1, "a replay overlapped a capture"
    assert any(r1 <= caps[0][0] for _, r1 in reps)
    assert any(r0 >= caps[-1][1] for r0, _ in reps)


class _CountingLock(capture.CaptureLock):
    def __init__(self) -> None:
        super().__init__()
        self.threads: set = set()

    @contextlib.contextmanager
    def capturing(self):
        self.threads.add(threading.current_thread().name)
        with super().capturing():
            yield


@pytest.mark.timeout(60)
def test_serving_engine_seals_and_replays_under_the_capture_lock(monkeypatch):
    """The real engine on the CPU: construction seals the decode step and
    each warm bucket exclusively, a bucket evicted from a one-entry cache
    re-seals on the stepper thread, and every step's device sections are
    shared sections."""
    import repro_torch.configs as C
    from repro_torch.launch.serve import init_params

    lock = _CountingLock()
    monkeypatch.setattr(capture, "CAPTURE_LOCK", lock)
    cfg = C.get("stablelm-1.6b", smoke=True)
    engine = TS.ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"), max_slots=2,
                              max_len=64, bucketing=(8, 16), device="cpu",
                              schedule_cache=TD.ScheduleCache(capacity=1))
    assert lock.captures == 3 and lock.replays == 0
    disp = TD.AsyncDispatcher(stepping="per-engine")
    disp.register_model("m", engine)
    with disp:
        r = disp.submit("m", np.arange(1, 6), max_new_tokens=4).result(timeout=60)
        builds = disp.builds_by_stepper
    assert len(r.generated) == 4
    assert lock.captures == 4 and builds == {"m": 1}      # bucket 8 re-sealed
    assert lock.replays >= 4
    assert "repro-dispatch-step[m]" in lock.threads


def test_capture_lock_excludes_and_prefers_writers():
    """Shared sections re-enter and overlap each other; a capture waits for
    them to end and holds off new ones; a capture inside a shared section
    of its own thread raises instead of deadlocking."""
    lock = capture.CaptureLock()
    order: list = []
    in_replay = threading.Event()
    release = threading.Event()

    def reader():
        with lock.replaying():
            with lock.replaying():
                in_replay.set()
                release.wait(5)
                order.append("replay-end")

    def writer():
        with lock.capturing():
            order.append("capture")

    def late_reader():
        with lock.replaying():
            order.append("late-replay")

    t1 = threading.Thread(target=reader)
    t1.start()
    in_replay.wait(5)
    t2 = threading.Thread(target=writer)
    t2.start()
    while not lock._writers_waiting:
        time.sleep(0.001)
    t3 = threading.Thread(target=late_reader)
    t3.start()
    time.sleep(0.02)
    assert order == []
    release.set()
    for t in (t1, t2, t3):
        t.join(5)
    assert order == ["replay-end", "capture", "late-replay"]
    with lock.replaying():
        with pytest.raises(RuntimeError):
            with lock.capturing():
                pass
    st = lock.stats()
    assert st["captures"] == 1 and st["replays"] == 3     # re-entry counts once


def test_obs_and_serving_surfaces_match():
    assert set(JO.__all__) == set(TO.__all__)
    assert set(JS.__all__) == set(TS.__all__)
