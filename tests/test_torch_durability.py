"""The port's durable control plane on the CPU: the request journal held
against the JAX package's, fault injection, and kill-and-restart.

* **Journal parity** — one scripted run (two lanes, journaled specs,
  requests left queued, granted and stepping, a lane retiring) through each
  package's ``Dispatcher`` with a ``RequestJournal`` attached: the
  journal's rows (lanes, requests, transitions, timestamps aside), the
  ``JournalState`` read back, the recovery report and the tokens of the
  recovered drain are equal.
* **Fault injection** — a crash at a transition fires deterministically;
  failing journal writes degrade the journal, never the serving.
* **Kill-and-restart** — this file run as a script (the ``__main__`` block
  at the end) is a journaled ``AsyncDispatcher`` in a given stepping mode
  that the test SIGKILLs in mid-flight; a fresh dispatcher here recovers the
  journal and every unfinished request replays token-identically: on fake
  engines in the pool and worker-process modes, and on the port's real
  ``ServingEngine`` rebuilt from its journaled ``ServingEngineSpec``.

The JAX package is imported only inside the parity tests, so the child
process (and the worker processes it forks) load no JAX.
"""

from __future__ import annotations

import importlib
import os
import signal
import sqlite3
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.dispatch import (
    AsyncDispatcher,
    Dispatcher,
    FaultInjected,
    FaultInjector,
    RequestJournal,
    RequestState,
    WorkerPlane,
)
from repro_torch.serving import Request, ServingEngineSpec
from repro_torch.serving.spec import EngineSpec

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)
PROMPT = np.array([1, 2, 3, 4], np.int64)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class SlowSeqEngine:
    """Request ``rid`` emits ``rid * 1000 + i``, one token per step, each
    step ``step_delay`` seconds long."""

    def __init__(self, slots: int = 2, step_delay: float = 0.0) -> None:
        self.slots: list = [None] * slots
        self.queue: list = []
        self.step_delay = step_delay

    def submit(self, req) -> None:
        self.queue.append(req)

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None) - len(self.queue)

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def step(self) -> list:
        if self.step_delay:
            time.sleep(self.step_delay)
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self.slots[i] = self.queue.pop(0)
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(req.rid * 1000 + len(req.generated))
            req.t_first = req.t_first or time.perf_counter()
            if len(req.generated) >= req.max_new_tokens:
                req.done, req.t_done, self.slots[i] = True, time.perf_counter(), None
                finished.append(req)
        return finished


class SlowSeqSpec(EngineSpec):
    """Picklable recipe of a :class:`SlowSeqEngine`."""

    def __init__(self, slots: int = 2, step_delay: float = 0.0) -> None:
        self.max_slots = slots
        self.step_delay = step_delay

    def build(self, device_index: int, schedule_cache=None):
        return SlowSeqEngine(self.max_slots, self.step_delay)


def _expected(rid: int, n: int) -> list:
    return [rid * 1000 + i for i in range(n)]


# -- journal parity with the JAX package ------------------------------------

def _rows(path: str) -> dict:
    conn = sqlite3.connect(path)
    try:
        lanes = conn.execute(
            "SELECT name, state, weight, priority_class, latency_target_ms, spec IS NOT NULL "
            "FROM lanes ORDER BY seq").fetchall()
        reqs = conn.execute(
            "SELECT rid, lane, prompt, max_new_tokens, tenant, deadline > 0 FROM requests "
            "ORDER BY seq").fetchall()
        trans = conn.execute("SELECT rid, state FROM transitions ORDER BY seq").fetchall()
    finally:
        conn.close()
    return {"lanes": lanes, "requests": reqs, "transitions": trans}


def _journaled_run(pkg: str, path: str, steps: int) -> dict:
    """Two journaled lanes (one a priority-1 lane), nine requests, ``steps``
    synchronous quanta, lane ``b`` retiring; then the journal is closed as
    a crash would leave it, read back, recovered into a fresh dispatcher
    over fresh engines, and drained."""
    D = importlib.import_module(f"{pkg}.dispatch")
    disp_kw = dict(max_pending=100, fairness="priority:round_robin")
    journal = D.RequestJournal(path, flush_interval=0.002)
    disp = D.Dispatcher(journal=journal, **disp_kw)
    disp.register_model("a", SlowSeqEngine(slots=2), spec=SlowSeqSpec(2), weight=2.0,
                        latency_target_ms=1e6)
    disp.register_model("b", SlowSeqEngine(slots=1), spec=SlowSeqSpec(1), priority_class=1)
    for i in range(9):
        disp.submit("ab"[i % 2], PROMPT.copy(), max_new_tokens=2 + i % 3, tenant=f"t{i % 2}")
    for _ in range(steps):
        disp.step()
    disp.retire_model("b")
    journal.sync()
    journal.close()
    rows = _rows(path)
    state = D.RequestJournal(path).recover_state()
    got_state = (
        [(lr.name, lr.state, type(lr.spec).__name__, lr.spec.max_slots, lr.weight,
          lr.priority_class, lr.latency_target_ms) for lr in state.lanes],
        [(rr.rid, rr.lane, rr.prompt.tolist(), rr.max_new_tokens, rr.tenant, rr.state)
         for rr in state.requests],
        state.max_rid)
    j2 = D.RequestJournal(path, flush_interval=0.002)
    d2 = D.Dispatcher(journal=j2, **disp_kw)
    report = d2.recover(j2, engines={"a": SlowSeqEngine(2), "b": SlowSeqEngine(1)})
    done = d2.run_until_drained()
    j2.sync()
    j2.close()
    report = {k: v for k, v in report.items() if k != "requests"}
    return {"rows": rows, "state": got_state, "report": report,
            "tokens": sorted((r.model, r.rid, tuple(r.generated)) for r in done),
            "after": _rows(path)["transitions"][len(rows["transitions"]):]}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("steps", [0, 1, 3, 8])
def test_journal_rows_state_and_recovery_equal_jax(tmp_path, steps):
    j = _journaled_run("repro", str(tmp_path / "jax.db"), steps)
    t = _journaled_run("repro_torch", str(tmp_path / "torch.db"), steps)
    assert j == t
    assert j["rows"]["transitions"] and j["state"][0]
    for model, rid, toks in t["tokens"]:
        assert list(toks) == _expected(rid, len(toks))


# -- fault injection --------------------------------------------------------

def _mk_journal(tmp_path, **kw):
    kw.setdefault("flush_interval", 0.005)
    return RequestJournal(str(tmp_path / "j.db"), **kw)


@pytest.mark.timeout(60)
def test_crash_at_transition_is_deterministic(tmp_path):
    fi = FaultInjector()
    fi.crash_at("request", RequestState.STEPPING, count=2)
    j = _mk_journal(tmp_path, faults=fi)
    d = Dispatcher(journal=j, faults=fi)
    d.register_model("a", SlowSeqEngine(slots=4))
    for _ in range(3):
        d.submit("a", PROMPT.copy(), max_new_tokens=2)
    with pytest.raises(FaultInjected):
        d.run_until_drained()
    assert fi.log == [("transition", ("request", 1, RequestState.STEPPING))]
    j.close()


@pytest.mark.timeout(60)
def test_journal_write_faults_degrade_not_crash(tmp_path):
    fi = FaultInjector()
    fi.fail_journal_writes(1000)
    j = _mk_journal(tmp_path, faults=fi, max_write_retries=2)
    d = Dispatcher(journal=j, faults=fi)
    d.register_model("a", SlowSeqEngine(slots=2))
    for _ in range(4):
        d.submit("a", PROMPT.copy(), max_new_tokens=2)
    done = d.run_until_drained()
    assert sorted(list(r.generated) for r in done) == sorted(
        _expected(r.rid, 2) for r in done)
    deadline = time.monotonic() + 5.0
    while not j.stats()["degraded"] and time.monotonic() < deadline:
        time.sleep(0.02)
    stats = j.stats()
    assert stats["degraded"] and stats["write_errors"] > 0 and stats["dropped_records"] > 0
    j.close()


# -- kill-and-restart ---------------------------------------------------------

def _real_spec() -> ServingEngineSpec:
    return ServingEngineSpec(arch="stablelm-1.6b", max_slots=2, max_len=64,
                             bucketing=(8, 16), seed=1, device="cpu")


def _real_prompts(n: int) -> list:
    rng = np.random.default_rng(11)
    return [rng.integers(0, 300, int(rng.integers(3, 17))) for _ in range(n)]


def _spawn_crash_child(tmp_path, mode: str, n_req: int, max_new: int):
    journal = str(tmp_path / "j.db")
    marker = str(tmp_path / "marker")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO_DIR, "src"), TESTS_DIR, env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), journal, mode, marker,
         str(n_req), str(max_new)],
        env=env, cwd=REPO_DIR, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 90.0
    while not os.path.exists(marker) and time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"child died before marker: {proc.stderr.read().decode()}")
        time.sleep(0.02)
    assert os.path.exists(marker), "child never became ready"
    with open(marker) as f:
        lines = f.read().split()
    assert lines[0] == "submitted"
    time.sleep(0.3)                          # let the kill land mid-flight
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=30)
    proc.stderr.close()
    return journal, [int(p) for p in lines[1:]]


def _assert_pids_exit(pids: list, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    for pid in pids:
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"worker pid {pid} leaked past SIGKILL")


@pytest.mark.timeout(180)
@pytest.mark.parametrize("mode", ["pool", "workers"])
def test_sigkill_recovery_fake_engines(tmp_path, mode):
    """A journaled server (pool of two, or one forked worker process) is
    SIGKILLed in mid-flight; recovered here from the journaled spec (in
    workers mode onto a fresh worker plane), every requeued request
    replays to its exact tokens."""
    n_req, max_new = 8, 6
    journal_path, pids = _spawn_crash_child(tmp_path, mode, n_req, max_new)
    if mode == "workers":
        assert pids
        _assert_pids_exit(pids)
    j = RequestJournal(journal_path)
    kw = (dict(stepping="pool", pool_size=2) if mode == "pool" else dict(
        stepping="workers", worker_plane=WorkerPlane(
            1, device="cpu", start_method="fork", hb_interval=0.05, hb_timeout=5.0)))
    disp = AsyncDispatcher(max_pending=1000, journal=j, **kw)
    report = disp.recover(j)
    assert report["lanes"] == ["a"]
    assert 0 < report["requeued"] <= n_req
    with disp:
        for rid, fut in report["futures"].items():
            assert list(fut.result(timeout=120).generated) == _expected(rid, max_new), rid
    if mode == "workers":
        assert disp.plane.leaked() == []
    j.close()


@pytest.mark.timeout(240)
def test_sigkill_recovery_real_engine_rebuilt_from_spec(tmp_path):
    """The port's ``ServingEngine`` (stablelm-1.6b smoke, CPU) behind a
    journaled per-engine dispatcher, SIGKILLed in mid-flight: the lane is
    rebuilt here from its journaled ``ServingEngineSpec`` and the requeued
    requests give the tokens of an engine built from the same spec and
    driven directly."""
    n_req, max_new = 12, 24
    journal_path, _ = _spawn_crash_child(tmp_path, "real", n_req, max_new)
    spec = _real_spec()
    ref = spec.build(0)
    prompts = _real_prompts(n_req)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    want = {tuple(int(t) for t in r.prompt): list(r.generated) for r in reqs}

    j = RequestJournal(journal_path)
    disp = AsyncDispatcher(max_pending=1000, journal=j, stepping="per-engine")
    report = disp.recover(j)
    assert report["lanes"] == ["real"]
    assert 0 < report["requeued"] <= n_req
    with disp:
        for rid, fut in report["futures"].items():
            r = fut.result(timeout=120)
            assert list(r.generated) == want[tuple(int(t) for t in r.prompt)], rid
    j.close()


def main(argv: list) -> None:
    """Child entry point: a journaled server that submits, marks itself
    ready, and serves until it is killed."""
    # the spec classes through the module, not this ``__main__`` alias, so
    # the journal's pickles resolve in any process
    from test_torch_durability import SlowSeqSpec as Spec

    journal_path, mode, marker = argv[0], argv[1], argv[2]
    n_req, max_new = int(argv[3]), int(argv[4])
    torch.set_num_threads(1)
    journal = RequestJournal(journal_path, flush_interval=0.01)
    if mode == "workers":
        plane = WorkerPlane(1, device="cpu", start_method="fork",
                            hb_interval=0.05, hb_timeout=5.0)
        disp = AsyncDispatcher(max_pending=1000, stepping="workers", worker_plane=plane,
                               journal=journal)
        disp.register_model("a", Spec(slots=2, step_delay=0.05))
        prompts = [PROMPT] * n_req
    elif mode == "real":
        spec = _real_spec()
        engine = spec.build(0)
        step = engine.step

        def paced_step():
            # 10 ms between steps, so the kill 0.3 s after the marker lands
            # mid-flight however fast the host steps the smoke engine (the
            # tokens do not depend on the pace)
            time.sleep(0.01)
            return step()

        engine.step = paced_step
        disp = AsyncDispatcher(max_pending=1000, stepping="per-engine", journal=journal)
        disp.register_model("real", engine, spec=spec)
        prompts = _real_prompts(n_req)
    else:
        spec = Spec(slots=2, step_delay=0.05)
        disp = AsyncDispatcher(max_pending=1000, stepping=mode, pool_size=2, journal=journal)
        disp.register_model("a", spec.build(0), spec=spec)
        prompts = [PROMPT] * n_req
    disp.start()
    lane = disp.models[0]
    for p in prompts:
        disp.submit(lane, p, max_new_tokens=max_new)
    journal.sync(timeout=10.0)
    pids: list = []
    if mode == "workers":
        snap = disp.snapshot()["async"]["workers"]
        pids = [w["pid"] for w in snap["workers"] if w.get("pid", -1) > 0]
    with open(marker + ".tmp", "w") as f:
        f.write("submitted\n")
        for pid in pids:
            f.write(f"{pid}\n")
    os.rename(marker + ".tmp", marker)
    time.sleep(300)


if __name__ == "__main__":
    main(sys.argv[1:])
