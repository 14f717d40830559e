"""The port's worker plane on the CPU, under ``spawn`` and ``fork``.

The failure matrix of the JAX package's ``tests/test_workers.py``, at its
fast-failure constants, against ``repro_torch.dispatch``: setup failure
(the injected worker condemned ``WorkerSetupError`` and never respawned),
a crash in the middle of a step (in-flight work fails ``WorkerCrashed``,
queued work replays on the respawned worker), a heartbeat timeout (a wedged
worker condemned ``WorkerTimeout``), parent shutdown (no orphan process),
and the merged multi-process trace.  The engines there are deterministic
fakes: request ``rid`` emits ``rid * 1000 + i``, and faults fire by request
id, never by timer.

Then the real thing: worker processes build the port's ``ServingEngine``
from a ``ServingEngineSpec(device="cpu")`` and serve the same tokens as an
engine built in this process from the same spec.  And the seams of the port:
``fork`` is refused once CUDA reports itself initialised (monkeypatched: no
card needed), ``device_topology`` raises for a CUDA plane with no CUDA
device, and a worker makes its device current before it builds.

Spawned children import this module by name to unpickle the fakes, so it
imports no JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.dispatch import (
    AsyncDispatcher,
    EngineWorker,
    WorkerCrashed,
    WorkerError,
    WorkerPlane,
    WorkerSetupError,
    WorkerTimeout,
    device_topology,
)
from repro_torch.dispatch import workers as W
from repro_torch.serving import Request, ServingEngineSpec

START_METHODS = ("fork", "spawn")
HB = dict(hb_interval=0.05, hb_timeout=1.0)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class TickEngine:
    """Request ``rid`` emits ``rid * 1000 + i``, one per step; a rid in
    ``crash_rids`` makes the step ``os._exit(13)``, one in ``hang_rids``
    sleeps ``hang_s`` (alive but silent)."""

    def __init__(self, slots=1, crash_rids=(), hang_rids=(), hang_s=120.0):
        self.slots = [None] * slots
        self.queue: list = []
        self.crash_rids, self.hang_rids, self.hang_s = set(crash_rids), set(hang_rids), hang_s

    def submit(self, req):
        self.queue.append(req)

    def free_slots(self):
        return sum(1 for s in self.slots if s is None) - len(self.queue)

    @property
    def idle(self):
        return not self.queue and all(s is None for s in self.slots)

    def step(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self.slots[i] = self.queue.pop(0)
        for req in self.slots:
            if req is None:
                continue
            if req.rid in self.crash_rids:
                os._exit(13)
            if req.rid in self.hang_rids:
                time.sleep(self.hang_s)
        finished = []
        now = time.perf_counter()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(req.rid * 1000 + len(req.generated))
            req.t_first = req.t_first or now
            if len(req.generated) >= req.max_new_tokens:
                req.done, req.t_done, self.slots[i] = True, now, None
                finished.append(req)
        return finished


class TickSpec:
    """Picklable recipe of a :class:`TickEngine` (the ``EngineSpec``
    contract)."""

    def __init__(self, slots=1, crash_rids=(), hang_rids=(), hang_s=120.0):
        self.max_slots = slots
        self.crash_rids, self.hang_rids, self.hang_s = tuple(crash_rids), tuple(hang_rids), hang_s

    def build(self, device_index, schedule_cache=None):
        return TickEngine(self.max_slots, self.crash_rids, self.hang_rids, self.hang_s)


class SetupFailWorker(EngineWorker):
    """An ``EngineWorker`` whose setup raises on worker ``fail_index``."""

    def setup(self, device_index, fail_index=0, **kwargs):
        if self.index == fail_index:
            raise RuntimeError(f"injected setup failure (worker {self.index})")
        super().setup(device_index, **kwargs)


def _req(rid, max_new=4):
    return Request(rid=rid, prompt=np.array([1, 2, 3], np.int64), max_new_tokens=max_new)


def _expected(rid, n):
    return [rid * 1000 + i for i in range(n)]


def _drive(proxy, deadline_s=30.0):
    done: list = []
    deadline = time.monotonic() + deadline_s
    while not proxy.idle:
        done.extend(proxy.step())
        if time.monotonic() > deadline:
            raise AssertionError("lane did not drain in time")
    return done


def _assert_no_orphans():
    deadline = time.monotonic() + 5.0
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert mp.active_children() == []


# -- the failure matrix -----------------------------------------------------

@pytest.mark.timeout(120)
@pytest.mark.parametrize("start_method", START_METHODS)
def test_workers_end_to_end_token_identity(start_method):
    """Four fake lanes over two workers through the async front door."""
    plane = WorkerPlane(2, start_method=start_method, **CPU, **HB)
    disp = AsyncDispatcher(max_pending=1000, stepping="workers", worker_plane=plane)
    names = [f"m{i}" for i in range(4)]
    for name in names:
        disp.register_model(name, TickSpec(slots=2))
    with disp:
        futures = {(name, rid): disp.submit_request(name, _req(rid))
                   for i, name in enumerate(names) for rid in (2 * i, 2 * i + 1)}
        for (name, rid), fut in futures.items():
            assert list(fut.result(timeout=60).generated) == _expected(rid, 4), (name, rid)
        snap = disp.snapshot()["async"]["workers"]
        assert snap["n_workers"] == 2 and snap["serving"] == 2
        assert snap["start_method"] == start_method
        assert sorted(lane for w in snap["workers"] for lane in w["lanes"]) == names
        assert all(w["device"] == 0 and w["spawn_s"] > 0 for w in snap["workers"])
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("start_method", START_METHODS)
def test_setup_failure_condemns_only_injected_worker(start_method):
    plane = WorkerPlane(2, start_method=start_method, worker_cls=SetupFailWorker,
                        setup_kwargs={"fail_index": 0}, max_restarts=3, **CPU, **HB)
    try:
        plane.start()
        snap = plane.snapshot()
        assert snap["workers"][0]["status"] == "abandoned"
        assert snap["workers"][1]["status"] == "serving"
        with pytest.raises(WorkerSetupError):
            plane.assign("doomed", TickSpec())
        survivor = plane.assign("ok", TickSpec())
        survivor.submit(_req(1))
        assert [list(r.generated) for r in _drive(survivor)] == [_expected(1, 4)]
        time.sleep(plane.hb_interval * 6)
        snap = plane.snapshot()
        assert snap["workers"][0]["status"] == "abandoned"
        assert snap["workers"][0]["restarts"] == 0
    finally:
        plane.shutdown()
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("start_method", START_METHODS)
def test_midstep_crash_fails_inflight_typed_and_replays_queued(start_method):
    plane = WorkerPlane(2, start_method=start_method, max_restarts=3, **CPU, **HB)
    try:
        plane.start()
        victim = plane.assign("victim", TickSpec(crash_rids=(7,)))
        bystander = plane.assign("bystander", TickSpec())
        assert victim.worker_index() != bystander.worker_index()
        victim.submit(_req(7))
        failed = victim.step()
        assert [r.rid for r in failed] == [7]
        exc = failed[0]._failure_exc
        assert isinstance(exc, WorkerCrashed) and exc.worker == victim.worker_index()
        victim.submit(_req(8))
        done = _drive(victim, deadline_s=60.0)
        assert [list(r.generated) for r in done] == [_expected(8, 4)]
        assert all(getattr(r, "_failure_exc", None) is None for r in done)
        w = plane.snapshot()["workers"][victim.worker_index()]
        assert w["restarts"] >= 1 and w["register_s"] >= 0
        bystander.submit(_req(9))
        assert [list(r.generated) for r in _drive(bystander)] == [_expected(9, 4)]
    finally:
        plane.shutdown()
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("start_method", START_METHODS)
def test_heartbeat_timeout_condemns_wedged_worker(start_method):
    plane = WorkerPlane(2, start_method=start_method, max_restarts=0, step_timeout=60.0,
                        **CPU, **HB)
    try:
        plane.start()
        victim = plane.assign("victim", TickSpec(hang_rids=(5,), hang_s=120.0))
        survivor = plane.assign("survivor", TickSpec())
        victim.submit(_req(5))
        t0 = time.monotonic()
        failed = victim.step()
        assert [r.rid for r in failed] == [5]
        assert isinstance(failed[0]._failure_exc, WorkerTimeout)
        assert time.monotonic() - t0 < 30.0
        victim.submit(_req(6))
        failed = []
        deadline = time.monotonic() + 10.0
        while not failed and time.monotonic() < deadline:
            failed = victim.step()
        assert [r.rid for r in failed] == [6]
        assert isinstance(failed[0]._failure_exc, WorkerError)
        survivor.submit(_req(9))
        assert [list(r.generated) for r in _drive(survivor)] == [_expected(9, 4)]
    finally:
        plane.shutdown()
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("start_method", START_METHODS)
def test_parent_shutdown_collects_and_leaves_no_orphans(start_method):
    plane = WorkerPlane(2, start_method=start_method, **CPU, **HB)
    try:
        plane.start()
        lane = plane.assign("m", TickSpec())
        lane.submit(_req(3))
        _drive(lane)
    finally:
        plane.shutdown()
    snap = plane.snapshot()
    assert all(w["status"] != "serving" for w in snap["workers"])
    served = [w for w in snap["workers"] if w["stats"].get("steps")]
    assert served and served[0]["stats"]["steps"] >= 4
    plane.shutdown()
    with pytest.raises(RuntimeError):
        plane.start()
    with pytest.raises(RuntimeError):
        plane.assign("late", TickSpec())
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(120)
def test_async_worker_crash_fails_only_victim_lane_futures():
    plane = WorkerPlane(2, start_method="fork", max_restarts=0, **CPU, **HB)
    disp = AsyncDispatcher(max_pending=1000, stepping="workers", worker_plane=plane)
    disp.register_model("a", TickSpec(crash_rids=(7,)))
    disp.register_model("b", TickSpec())
    disp.register_model("c", TickSpec())
    disp.register_model("d", TickSpec())
    with disp:
        with pytest.raises(WorkerCrashed):
            disp.submit_request("a", _req(7)).result(timeout=60)
        for name, rid in (("b", 1), ("d", 2)):
            r = disp.submit_request(name, _req(rid)).result(timeout=60)
            assert list(r.generated) == _expected(rid, 4)
        with pytest.raises(WorkerError):
            disp.submit_request("c", _req(8)).result(timeout=60)
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(120)
def test_trace_merge_has_per_process_tracks():
    tracer = obs.get_tracer()
    tracer.clear()
    tracer.enable()
    plane = WorkerPlane(2, start_method="fork", trace=True, **CPU, **HB)
    disp = AsyncDispatcher(max_pending=1000, stepping="workers", worker_plane=plane)
    disp.register_model("m0", TickSpec())
    disp.register_model("m1", TickSpec())
    try:
        with disp:
            for rid, name in ((0, "m0"), (1, "m1")):
                r = disp.submit_request(name, _req(rid)).result(timeout=60)
                assert list(r.generated) == _expected(rid, 4)
    finally:
        tracer.disable()
    worker_events = plane.trace_events()
    assert worker_events
    worker_pids = {ev.pid for ev in worker_events}
    assert 1 not in worker_pids
    trace = obs.to_chrome_trace(tracer.drain(), extra_events=worker_events)
    tracer.clear()
    assert obs.validate_trace(trace) == []
    tracks = {ev["pid"]: ev["args"]["name"] for ev in trace["traceEvents"]
              if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    assert tracks.get(1) == "dispatcher (parent)"
    for pid in worker_pids:
        assert tracks[pid] == f"worker pid={pid}"
    _assert_no_orphans()


# -- the port's engines in worker processes ---------------------------------

def _spec(max_slots=2):
    return ServingEngineSpec(arch="stablelm-1.6b", max_slots=max_slots, max_len=64,
                             bucketing=(8, 16), seed=3, device="cpu")


def _prompts(n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 300, int(rng.integers(3, 17))) for _ in range(n)]


@pytest.mark.timeout(180)
@pytest.mark.parametrize("start_method", START_METHODS)
def test_worker_engines_serve_the_in_process_tokens(start_method):
    """Two lanes of ``ServingEngineSpec(device="cpu")`` recipes built in two
    worker processes: every request's tokens equal those of an engine built
    here from the same spec, and the spec round-trips ``pickle_spec``."""
    from repro_torch.serving.spec import pickle_spec

    spec = _spec()
    assert pickle_spec(spec) and spec.target(5) == torch.device("cpu")
    ref = spec.build(0)
    prompts = _prompts()
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    want = [list(r.generated) for r in reqs]

    plane = WorkerPlane(2, start_method=start_method, **CPU, **HB)
    disp = AsyncDispatcher(max_pending=100, stepping="workers", worker_plane=plane)
    disp.register_model("a", spec)
    disp.register_model("b", spec)
    with disp:
        futs = [(disp.submit("a", p, max_new_tokens=5), disp.submit("b", p, max_new_tokens=5))
                for p in prompts]
        for (fa, fb), w in zip(futs, want):
            assert list(fa.result(timeout=120).generated) == w
            assert list(fb.result(timeout=120).generated) == w
        snap = disp.snapshot()["async"]["workers"]
    assert all(w["stats"]["kernel_launches"] == {"flash_attention": 0, "stream_pack": 0}
               for w in snap["workers"])      # the CPU takes the plain versions
    assert plane.leaked() == []
    _assert_no_orphans()


@pytest.mark.timeout(180)
def test_worker_engine_crash_replays_queued_tokens():
    """A real engine's worker killed (SIGKILL) between steps with four
    requests in flight and two queued: the four fail ``WorkerCrashed``, the
    two replay on the respawned worker with the in-process engine's
    tokens."""
    import signal

    spec = _spec(max_slots=4)
    prompts = _prompts(6, seed=9)
    ref = spec.build(0)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    want = [list(r.generated) for r in reqs]

    plane = WorkerPlane(1, start_method="spawn", max_restarts=2,
                        **CPU, hb_interval=0.05, hb_timeout=5.0)
    try:
        plane.start()
        lane = plane.assign("m", spec)
        for i, p in enumerate(prompts):
            lane.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        assert lane.step() == []              # four seated, two queued
        pid = plane.snapshot()["workers"][0]["pid"]
        os.kill(pid, signal.SIGKILL)
        done = _drive(lane, deadline_s=90.0)
        failed = sorted(r.rid for r in done if isinstance(
            getattr(r, "_failure_exc", None), WorkerCrashed))
        served = {r.rid: list(r.generated) for r in done
                  if getattr(r, "_failure_exc", None) is None}
        assert failed == [0, 1, 2, 3]
        assert served == {4: want[4], 5: want[5]}
        w = plane.snapshot()["workers"][0]
        assert w["restarts"] == 1 and w["pid"] != pid
    finally:
        plane.shutdown()
    assert plane.leaked() == []
    _assert_no_orphans()


# -- the port's seams ---------------------------------------------------------

def test_fork_refused_once_cuda_is_initialised(monkeypatch):
    """With CUDA reporting itself initialised here, a ``fork`` plane refuses
    to start (typed), and so does a respawn; ``spawn`` is not refused."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    plane = WorkerPlane(1, start_method="fork", **CPU, **HB)
    with pytest.raises(WorkerSetupError, match="fork"):
        plane.start()
    with pytest.raises(WorkerSetupError):
        W.refuse_fork_after_cuda("fork")
    W.refuse_fork_after_cuda("spawn")
    handle = W._WorkerHandle(0, 0)
    plane._spawn(handle)
    assert handle.abandoned and isinstance(handle.error, WorkerSetupError)
    assert plane.leaked() == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    W.refuse_fork_after_cuda("fork")


def test_device_topology(monkeypatch):
    """CPU planes put every worker on device 0; CUDA planes wrap over the
    visible devices and raise when there is none — no quiet fallback."""
    assert device_topology(3, "cpu") == [0, 0, 0]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(WorkerSetupError, match="no CUDA device"):
        device_topology(2)
    with pytest.raises(WorkerSetupError):
        WorkerPlane(1)                       # the default device is cuda
    with pytest.raises(WorkerSetupError):
        AsyncDispatcher(stepping="workers", devices=1)
    with pytest.raises(ValueError):
        device_topology(1, "tpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_topology(5) == [0, 1, 0, 1, 0]


def test_spec_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ServingEngineSpec(arch="stablelm-1.6b")
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.build(0)
    with pytest.raises(ValueError):
        ServingEngineSpec(device="tpu").target(0)


def test_engine_worker_makes_its_cuda_device_current(monkeypatch):
    """``EngineWorker.setup`` calls ``torch.cuda.set_device(device_index)``
    for a CUDA plane before anything is built, and not for a CPU plane."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    w = EngineWorker()
    w.setup(3, device="cuda")
    w.setup(1, device="cpu")
    w.setup(2)                                 # the plane's default: cuda
    assert calls == [3, 2]
    assert w.stats()["device"] == 2
