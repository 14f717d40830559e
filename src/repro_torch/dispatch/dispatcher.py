"""Multi-tenant dispatcher: route requests onto pre-sealed schedules.

The layer the GPU-datacenter scheduling survey (Gao et al.) calls out as
missing from single-model AoT systems: many models ("tenants"), each with
its own :class:`~repro_torch.serving.ServingEngine` over cached schedules, served
from one submission front door.

Flow (mirroring the related ``gpu_dispatch`` repo's submit/monitor shape,
but cooperative and in-process — the repo's engines are synchronous):

    submit(model, prompt)           # backpressure: bounded total queue
      └─ per-model lane (FIFO)
    step() / step_lane(model)       # fairness policy picks lanes to serve
      ├─ admission control: fill free engine slots from the model's lane
      ├─ engine.step(): one sealed decode step + prefills
      └─ completion callbacks + metrics for every finished request

Fairness is pluggable (:mod:`repro_torch.dispatch.fairness`): the default
``round_robin`` policy rotates which lane admits and decodes first, so a
flood on one model cannot starve another; ``weighted`` gives lanes decode
quanta proportional to their weights; ``quota`` enforces token-rate
budgets.  Backpressure is a bounded pending count: ``submit`` raises
:class:`QueueFullError` once ``max_pending`` requests are queued or
in-flight, pushing the wait upstream instead of growing memory.

Thread-safety / locking contract (fine-grained; see DESIGN.md §locking):

* ``_reg_mu`` — narrow registry lock over the lane table.  Held only for
  dict lookups and registration, never across an engine call.
* per-lane ``step_mu`` — serializes admission + ``engine.step()`` for ONE
  lane.  Two lanes step concurrently; one lane never steps twice at once
  (this is what upholds the engine's single-stepper contract).
* per-lane ``queue_mu`` — guards that lane's FIFO only.  ``submit``
  touches just this lock (plus the counter lock), so its latency is
  independent of any engine's step duration — a submit no longer waits
  out a decode step, even on its own lane.
* ``_fair_mu`` — serializes all :class:`FairnessPolicy` calls (policies
  are not internally locked).
* ``_count_mu`` — guards the pending-count and rid allocator; O(1), which
  is what makes ``submit``-side backpressure cheap.
* ``_ready_mu`` — guards the **indexed ready set** (``_active_set``): the
  incrementally maintained set of lanes with queued or in-flight work.
  Lanes enter on ``submit`` and leave when a ``step_lane`` quantum drains
  them; the lane-event hook fires *under this lock* with ``(name, active)``
  deltas, so the async arbiter's mirror always applies transitions in
  truth order — no full-registry walk ever happens on the grant path.

Lock order: ``step_mu → queue_mu`` and ``step_mu → _fair_mu`` are the only
dispatcher-internal nestings; ``_reg_mu`` and ``_count_mu`` never nest
with anything.  ``_ready_mu`` is taken before the arbiter's lock (the
hook runs under it) and never after any dispatcher lock that the hook's
consumers take.  With a batch composer attached, a compose group's
``step_mu`` stands in for its member lanes' step locks (``group.step_mu →
queue_mu → _ready_mu`` via the engine submit hook is the one new nesting;
nothing under ``_ready_mu`` takes a lane lock, so the order is acyclic),
and the composer's own mutex is a leaf.  Completion callbacks run OUTSIDE
all dispatcher locks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.obs.tracer import get_tracer

# QueueFullError / DrainTimeoutError live in .errors (under the unified
# DispatchError taxonomy) but remain importable from here for
# compatibility with pre-taxonomy call sites.
from .errors import DrainTimeoutError, JournalCorrupt, QueueFullError
from .fairness import ClassedFairness, FairnessSpec, make_fairness
from .lifecycle import LaneState, LifecycleTracker, RequestState
from .metrics import DispatchMetrics
from .slo import AdmissionRejected, SLOPolicy


class _Lane:
    """One tenant: its engine, FIFO, and the two locks that protect them.

    ``queue_mu`` (brief) guards the FIFO; ``step_mu`` (held across one
    engine step) serializes stepping.  ``retired`` (set under ``queue_mu``
    by :meth:`Dispatcher.retire_model`) refuses new submissions while the
    lane drains out; ``retire_future`` resolves to the engine once the
    drained lane's removal finalizes, and ``finalizing`` (also under
    ``queue_mu``) makes that finalization once-only no matter how many
    steppers observe the drain.  Internal to the dispatcher."""

    __slots__ = (
        "name", "engine", "queue", "queue_mu", "step_mu", "retired",
        "priority_class", "finalizing", "retire_future", "lc_state",
    )

    def __init__(
        self, name: str, engine: Any, *, priority_class: int = 0
    ) -> None:
        self.name = name
        self.engine = engine
        self.queue: deque = deque()
        self.queue_mu = threading.Lock()
        self.step_mu = threading.Lock()
        self.retired = False
        self.priority_class = priority_class
        self.finalizing = False
        self.retire_future: Optional[Future] = None
        self.lc_state = ""   # stamped by LifecycleTracker.lane_begin


class Dispatcher:
    """Multi-tenant front door over per-model serving engines.

    Engines are duck-typed: anything with ``submit(request)``,
    ``step() -> list[Request]``, ``free_slots()``, and ``idle`` works
    (``repro_torch.serving.ServingEngine`` is the canonical one).

    Thread-safe with fine-grained locks: submissions, snapshots, and steps
    of *different* lanes all proceed concurrently; see the module docstring
    for which lock protects what.  ``step()`` serves lanes in policy order
    from the calling thread; ``step_lane()`` is the per-engine quantum that
    ``AsyncDispatcher``'s per-engine stepper threads drive in parallel.
    """

    def __init__(
        self,
        *,
        max_pending: int = 256,
        metrics: Optional[DispatchMetrics] = None,
        fairness: FairnessSpec = None,
        completed_log: int = 4096,
        tracer: Optional[Any] = None,
        composer: Optional[Any] = None,
        slo: Optional[SLOPolicy] = None,
        journal: Optional[Any] = None,
        faults: Optional[Any] = None,
    ) -> None:
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self.metrics = metrics or DispatchMetrics()
        # durability plane (repro_torch.dispatch.journal): when a RequestJournal
        # is attached, every lane registration and request lifecycle
        # transition is recorded append-only (O(1) enqueue here; all
        # SQLite I/O on the journal's writer thread), and recover() can
        # rebuild the control plane from it after a crash.  ``faults`` is
        # the test-only FaultInjector threaded through the same paths.
        self.journal = journal
        self.faults = faults
        self.lifecycle = LifecycleTracker(journal=journal, faults=faults)
        # SLO plane (repro_torch.dispatch.slo): priority classes, latency
        # targets, admission control, shedding.  Always present — with no
        # targets registered it admits everything and costs one dict probe
        self.slo = slo if slo is not None else SLOPolicy()
        # cross-tenant batch composer (repro_torch.dispatch.batching): when set,
        # compatible lanes share one host engine and step via step_group
        self.composer = composer
        # request-lifecycle span recorder (repro_torch.obs); the process-wide
        # default is disabled, so every emit below is one guarded branch
        self.tracer = tracer if tracer is not None else get_tracer()
        self.fairness = make_fairness(fairness)
        # kept so the first priority-classed registration can adopt the
        # live policy into a ClassedFairness seeded from the same spec
        self._fairness_spec = fairness
        self._lanes: dict[str, _Lane] = {}
        self._order: list[str] = []
        self._rank: dict[str, int] = {}      # name -> registration index
        self._next_rank = 0
        self._reg_epoch = 0                  # bumped on (un)registration
        self._reg_mu = threading.Lock()      # lane table + registration
        self._fair_mu = threading.Lock()     # all FairnessPolicy calls
        self._count_mu = threading.Lock()    # pending count + rid allocator
        self._pending_count = 0
        self._next_rid = 0
        # indexed ready set: lanes with queued or in-flight work, maintained
        # incrementally on submit / step-complete / unregister transitions.
        # This is what keeps the async grant path O(active), not O(tenants):
        # the arbiter mirrors it from (name, active) deltas instead of
        # walking every registered lane per pump.
        self._ready_mu = threading.Lock()
        self._active_set: set[str] = set()
        # class-partitioned view of the same ready set (cls -> lane names),
        # maintained on the identical transitions under _ready_mu — the
        # O(1) answer to "does a higher class have ready work right now"
        self._ready_by_class: dict[int, set] = {}
        # lane-readiness delta feed (event-driven arbiter hand-off): set by
        # the async layer, invoked UNDER _ready_mu with (name, active) so
        # deltas reach the consumer in truth order — a submit's "active"
        # and a drain's "inactive" can never arrive inverted.  The hook
        # must be fast, must not raise, and must not call back into any
        # dispatcher method that takes _ready_mu.
        self._lane_event_hook: Optional[Callable[[str, bool], None]] = None
        # finished Requests, completion order; bounded — a long-running
        # service must not retain every request it ever served.  deque
        # appends are atomic, so no extra lock.
        self.completed: deque = deque(maxlen=completed_log)

    # -- registration ------------------------------------------------------

    def register_model(
        self,
        name: str,
        engine: Any,
        *,
        weight: float = 1.0,
        priority_class: int = 0,
        latency_target_ms: Optional[float] = None,
        spec: Optional[Any] = None,
    ) -> Any:
        """Add a tenant: ``name`` gets its own lane over ``engine``.

        ``weight`` parameterizes the fairness policy (decode-quantum share
        under ``weighted``, refill-rate multiplier under ``quota``).
        ``priority_class`` (lower = more important; default 0) places the
        lane in the SLO plane's strict class ordering: the first nonzero
        class upgrades a single-class fairness policy in place to
        :class:`~repro_torch.dispatch.fairness.ClassedFairness` (existing lanes
        keep their schedule as class 0).  ``latency_target_ms`` gives the
        lane a per-request deadline — completions feed the adaptive
        overload controller and submissions gain admission control
        (:class:`~repro_torch.dispatch.slo.AdmissionRejected` backpressure).
        ``spec`` (a picklable :class:`~repro_torch.serving.spec.EngineSpec`)
        is the lane's rehydration recipe: when a journal is attached it
        is persisted with the registration, and :meth:`recover` rebuilds
        the engine from it after a restart — lanes registered without a
        spec need a caller-provided engine to recover.
        Registration is thread-safe and allowed while serving is live —
        an ``AsyncDispatcher`` picks the new lane up on its next pass.
        """
        if priority_class < 0:
            raise ValueError(
                f"priority_class must be >= 0, got {priority_class}"
            )
        if latency_target_ms is not None and latency_target_ms <= 0:
            raise ValueError(
                f"latency_target_ms must be > 0, got {latency_target_ms}"
            )
        lane = _Lane(name, engine, priority_class=int(priority_class))
        with self._reg_mu:
            if name in self._lanes:
                raise ValueError(f"model {name!r} already registered")
            self._lanes[name] = lane
            self._order.append(name)
            self._rank[name] = self._next_rank
            self._next_rank += 1
            self._reg_epoch += 1
        existing = [n for n in self.models if n != name]
        with self._fair_mu:
            if priority_class != 0 and not isinstance(
                self.fairness, ClassedFairness
            ):
                # lazy upgrade: the live policy becomes class 0 with all
                # its accumulated state; further classes get fresh inner
                # policies built from the original spec
                self.fairness = ClassedFairness.adopt(
                    self.fairness, self._fairness_spec, existing
                )
            self.fairness.register(
                name, weight=weight, priority_class=priority_class
            )
        self.slo.register_lane(
            name,
            priority_class=priority_class,
            latency_target_ms=latency_target_ms,
        )
        self.metrics.set_lane_class(name, priority_class)
        self.metrics.track_engine(name)   # lift any unregister tombstone
        if self.composer is not None:
            self.composer.add_lane(name, engine)
        # engine-side submit hook: direct engine.submit() work becomes
        # visible to the indexed ready set (and thus to pool grants and
        # the composer's refill path) instead of only to the sync walk
        set_hook = getattr(engine, "set_submit_hook", None)
        if set_hook is not None:
            set_hook(self._engine_submit_hook(name))
        self.lifecycle.lane_begin(
            lane, spec=spec, weight=weight, priority_class=priority_class,
            latency_target_ms=latency_target_ms,
        )
        return engine

    def retire_model(self, name: str) -> Future:
        """Mark tenant ``name`` retired; returns a future resolving to the
        retired engine once the lane drains and its removal finalizes.

        The lane refuses new submissions the moment this is called (a
        racing ``submit`` raises ``KeyError``); queued and in-flight
        requests keep being served by whatever is already stepping —
        ``AsyncDispatcher`` steppers, worker-plane step threads, or a
        caller's own ``step()`` loop — and the stepper that completes the
        lane's **last** request finalizes the removal (registry, ready
        index, fairness, SLO, metrics, ``engine.retire()``) and resolves
        the future.  The caller never drains on its own thread; a lane
        that is already idle finalizes inline before this returns.
        Idempotent: repeated calls return the same future.  If
        finalization raises, the future carries that exception.
        """
        lane = self._lane(name)
        if self.composer is not None:
            # a retiring HOST lane disbands its group: refill pauses for
            # the survivors so the drain below can run the host dry
            self.composer.begin_retire(name)
        with lane.queue_mu:
            fut = lane.retire_future
            fresh = fut is None
            if fresh:
                lane.retired = True
                fut = Future()
                fut.set_running_or_notify_cancel()   # never cancellable
                lane.retire_future = fut
        if fresh:
            self.lifecycle.lane_advance(lane, LaneState.RETIRING)
            # already-idle lane: nobody will step it again, finalize now
            self._maybe_finalize_retire(lane)
        return fut

    def unregister_model(self, name: str, *, max_steps: int = 100_000) -> Any:
        """Retire tenant ``name`` and block until it is fully removed;
        returns the retired engine.

        Built on :meth:`retire_model`: the lane is marked retired, then
        this thread steps it until the retire future resolves — so with no
        steppers running the caller drains the lane itself (each quantum a
        normal ``step_lane``), and with an ``AsyncDispatcher`` live the
        caller's quanta are mostly no-ops while the steppers drain it
        (whoever completes the last request finalizes).  Raises
        :class:`DrainTimeoutError` if ``max_steps`` quanta cannot drain
        the lane, leaving it retired but registered so the failure is
        inspectable.  If the engine exposes a ``retire()`` hook
        (``ServingEngine`` does), it is invoked during finalization.
        """
        fut = self.retire_model(name)
        for _ in range(max_steps):
            if fut.done():
                break
            self.step_lane(name)
        if not fut.done():
            raise DrainTimeoutError(
                f"unregister exhausted {max_steps} steps draining {name!r}"
            )
        return fut.result()

    def _maybe_finalize_retire(self, lane: _Lane) -> None:
        """Finalize a retired lane once it is drained (no queued work, an
        idle engine, no composed in-flight residue) — called after every
        quantum/shed that completed requests, and once inline from
        :meth:`retire_model`.  The ``finalizing`` flag (under
        ``queue_mu``) makes exactly one observer run the removal; the
        drain check shares that critical section with admission's
        queue-pop-then-seat, so a mid-admission lane can never read as
        drained."""
        if not lane.retired or lane.retire_future is None:
            return
        with lane.queue_mu:
            if lane.finalizing:
                return
            if (
                lane.queue
                or not lane.engine.idle
                or self._composed_busy(lane.name)
            ):
                return
            lane.finalizing = True
        try:
            self._finalize_retire(lane)
        except BaseException as exc:  # noqa: BLE001 - surface on the future
            if not lane.retire_future.done():
                lane.retire_future.set_exception(exc)
            raise

    def _finalize_retire(self, lane: _Lane) -> None:
        """The removal sequence (runs once, on the draining thread): leave
        the compose group, unhook the engine, evict from the ready index,
        the fairness policy, the SLO plane, the registry, and the metrics,
        retire the engine, then resolve the retire future."""
        name = lane.name
        if self.composer is not None:
            # host drained (or member emptied): leave the group; survivors
            # of a dissolved group re-form around a fresh host
            self.composer.finish_retire(name)
        set_hook = getattr(lane.engine, "set_submit_hook", None)
        if set_hook is not None:
            set_hook(None)
        # retire from the ready index (delta: the arbiter drops the lane
        # from its mirror, ready stamps, and queued grants) BEFORE the
        # registry removal, so no new grant can form for a vanishing lane
        with self._ready_mu:
            self._active_set.discard(name)
            self._discard_classed_locked(name, lane.priority_class)
            hook = self._lane_event_hook
            if hook is not None:
                hook(name, False)
        with self._fair_mu:
            self.fairness.unregister(name)
        self.slo.unregister_lane(name)
        with self._reg_mu:
            self._lanes.pop(name, None)
            if name in self._order:
                self._order.remove(name)
            self._rank.pop(name, None)
            self._reg_epoch += 1
        # second eviction delta, AFTER the registry removal: a per-engine
        # stepper that read "lane active" before the first delta may have
        # parked a waiter in the window between the two — this delta
        # evicts it, and any later park attempt is refused by the
        # registry check at acquire time, so no phantom waiter can
        # outlive the tenant
        with self._ready_mu:
            self._active_set.discard(name)
            self._discard_classed_locked(name, lane.priority_class)
            hook = self._lane_event_hook
            if hook is not None:
                hook(name, False)
        self.metrics.drop_engine(name)
        retire = getattr(lane.engine, "retire", None)
        if retire is not None:
            retire()
        self.lifecycle.lane_advance(lane, LaneState.RETIRED)
        lane.retire_future.set_result(lane.engine)

    @property
    def models(self) -> tuple[str, ...]:
        """Registered model names, in registration order."""
        with self._reg_mu:
            return tuple(self._order)

    def engine(self, name: str) -> Any:
        """The engine serving ``name`` (KeyError if unregistered)."""
        return self._lane(name).engine

    def has_model(self, name: str) -> bool:
        """Whether ``name`` is currently registered — O(1), one dict probe
        under the registry lock (steppers poll this to learn their lane
        was unregistered)."""
        with self._reg_mu:
            return name in self._lanes

    def _lane(self, name: str) -> _Lane:
        with self._reg_mu:
            try:
                return self._lanes[name]
            except KeyError:
                raise KeyError(f"unknown model {name!r}") from None

    def _lane_or_none(self, name: str) -> Optional[_Lane]:
        with self._reg_mu:
            return self._lanes.get(name)

    def _lanes_snapshot(self) -> list[_Lane]:
        with self._reg_mu:
            return [self._lanes[n] for n in self._order]

    # -- submission (backpressure) -----------------------------------------

    def pending(self) -> int:
        """Requests submitted through this dispatcher and not yet finished
        (queued in lanes plus live in engines).  O(1): maintained as a
        counter so backpressure checks never take a lane lock."""
        with self._count_mu:
            return self._pending_count

    def _admit(self, req: Any) -> None:
        """Charge one request against ``max_pending`` (raising at capacity)
        and stamp submit-side bookkeeping.  Called with NO lock held."""
        with self._count_mu:
            full = self._pending_count >= self.max_pending
            if not full:
                self._pending_count += 1
        if full:
            # outside _count_mu: it is a leaf lock and must stay one
            self.metrics.on_reject()
            raise QueueFullError(
                f"dispatcher at capacity ({self.max_pending} pending)"
            )
        req._dispatcher_pending = True
        req.t_submit = time.perf_counter()
        self.metrics.on_submit(req.t_submit)

    def submit(
        self,
        model: str,
        prompt: np.ndarray,
        *,
        max_new_tokens: int = 16,
        tenant: str = "",
        on_complete: Optional[Callable[[str, Any], None]] = None,
    ):
        """Enqueue one request for ``model``; returns the ``Request``.

        Raises ``KeyError`` for an unknown model, a validation error for a
        request the engine can never serve (synchronously, on the
        submitter), :class:`QueueFullError` at capacity, and — when the
        lane carries a latency target whose deadline is provably
        unmeetable — :class:`~repro_torch.dispatch.slo.AdmissionRejected`, with
        the pending charge rolled back.  Only the lane's queue lock and
        the O(1) counter lock are taken, so submit latency is independent
        of engine step time.
        """
        from repro_torch.serving.engine import Request  # lazy: avoid import cycle

        lane = self._lane(model)
        req = Request(
            rid=-1,                     # allocated only after validation
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            tenant=tenant,
            model=model,
            on_complete=on_complete,
        )
        self._validate(lane, req)
        self._admit(req)
        self.lifecycle.begin(req)
        self._slo_admit(lane, req)
        with self._count_mu:
            req.rid = self._next_rid
            self._next_rid += 1
        self._enqueue(lane, req)
        return req

    def submit_request(self, model: str, req: Any) -> Any:
        """Enqueue a caller-constructed ``Request`` (keeps its rid/fields;
        a pre-stamped ``req.deadline`` is honored by admission control)."""
        lane = self._lane(model)
        self._validate(lane, req)
        req.model = model
        self._admit(req)
        self.lifecycle.begin(req)
        self._slo_admit(lane, req)
        self._enqueue(lane, req)
        return req

    def _slo_admit(self, lane: _Lane, req: Any) -> None:
        """Admission control (after the capacity charge, before enqueue):
        stamp the request's deadline from the lane's latency target and
        raise :class:`~repro_torch.dispatch.slo.AdmissionRejected` — with the
        pending backpressure charge rolled back, exactly like a racing
        retirement — when that deadline is provably unmeetable behind the
        work already queued."""
        with lane.queue_mu:
            queued_ahead = len(lane.queue)
        try:
            req.deadline = self.slo.admit(
                lane.name,
                queued_ahead,
                deadline=getattr(req, "deadline", 0.0) or None,
            )
        except AdmissionRejected:
            req._dispatcher_pending = False
            with self._count_mu:
                self._pending_count -= 1
            self.metrics.on_admission_reject(lane.priority_class)
            # rejected before the durability point: SUBMITTED -> FAILED
            # stays in memory only (the journal never saw this request)
            self.lifecycle.advance(req, RequestState.FAILED, lane=lane.name)
            raise

    def _enqueue(self, lane: _Lane, req: Any) -> None:
        """Append to the lane FIFO (re-checking retirement under the queue
        lock — an unregister racing this submit must not strand a request
        in a lane nobody will ever drain) and mark the lane ready."""
        with lane.queue_mu:
            if lane.retired:
                retired = True
            else:
                retired = False
                lane.queue.append(req)
        if retired:
            # roll back the admission charge before surfacing the error
            req._dispatcher_pending = False
            with self._count_mu:
                self._pending_count -= 1
            self.lifecycle.advance(req, RequestState.FAILED, lane=lane.name)
            raise KeyError(f"model {lane.name!r} is being unregistered")
        # the durability point: the request is in a lane FIFO, so the
        # journal writes its full record (the enqueue above held queue_mu;
        # this runs after release — journal I/O is on the writer thread
        # regardless, but even the O(1) record enqueue stays outside)
        self.lifecycle.advance(req, RequestState.QUEUED, lane=lane.name)
        if lane.lc_state == LaneState.REGISTERED:
            self.lifecycle.lane_advance(lane, LaneState.ACTIVE)
        if self.tracer.enabled:
            # one async track per request: opened here (rid is final and the
            # request is durably queued), closed in _complete / _fail
            self.tracer.async_begin("request", req.rid, lane=lane.name)
            self.tracer.instant(
                "queued", cat="request", lane=lane.name, rid=req.rid
            )
        self._touch_ready(lane)
        # overload response on the submitter's thread: when the adaptive
        # controller reports a tripped class, walk the queues once and
        # shed what provably cannot make its deadline anymore.  Gated on
        # the O(classes) flag check, so the untripped fast path pays one
        # method call
        if self.slo.any_overloaded():
            self.shed()

    def set_lane_event_hook(
        self, hook: Optional[Callable[[str, bool], None]]
    ) -> None:
        """Install (or clear, with ``None``) the lane-readiness delta hook.

        The hook is called as ``hook(name, active)`` under the ready-set
        lock whenever a lane's membership in the indexed ready set is
        (re)confirmed or revoked: a ``submit`` appended a request
        (``active=True``), a :meth:`step_lane` quantum finished (``True``
        if work remains, ``False`` if the lane drained), or
        :meth:`unregister_model` retired the lane (``False``).  On
        install, the current ready set is replayed as ``active=True``
        deltas so a consumer attached mid-flight starts from a correct
        mirror.  The async layer points this at its quantum arbiter, which
        maintains an O(active) mirror and grants freed quanta on the event
        itself instead of a timed tick.  Hooks must be fast, must not
        raise, and must not call back into dispatcher methods that take
        the ready-set lock.
        """
        with self._ready_mu:
            self._lane_event_hook = hook
            if hook is not None:
                for name in self._active_set:
                    hook(name, True)

    def _touch_ready(self, lane: _Lane) -> None:
        """Recompute ``lane``'s activity, fold the transition into the
        indexed ready set, and feed the delta hook — all under
        ``_ready_mu`` so consumers see transitions in truth order.  Called
        after every mutation of a lane's work state; the recompute happens
        under the lock, so the last caller in any race observes current
        truth and the index converges.

        The hook fires on **transitions only**: a submit landing on an
        already-active lane (or a step leaving work behind) changes no
        lane's grantability — the arbiter already mirrors the lane as
        active, and its next grant flows from ``release``.  Skipping the
        no-op delta keeps a busy submitter entirely off the arbiter's
        mutex, which profiling showed was the grant path's largest
        remaining contention cost."""
        with self._ready_mu:
            active = (
                bool(lane.queue)
                or not lane.engine.idle
                or self._composed_busy(lane.name)
            )
            was = lane.name in self._active_set
            if active and not was:
                self._active_set.add(lane.name)
                self._ready_by_class.setdefault(
                    lane.priority_class, set()
                ).add(lane.name)
            elif not active and was:
                self._active_set.discard(lane.name)
                self._discard_classed_locked(lane.name, lane.priority_class)
            else:
                return
            hook = self._lane_event_hook
            if hook is not None:
                hook(lane.name, active)

    def _discard_classed_locked(self, name: str, cls: int) -> None:
        """Drop ``name`` from the class-partitioned ready view (caller
        holds ``_ready_mu``), pruning the class bucket when it empties so
        the partition stays O(classes-with-ready-work)."""
        bucket = self._ready_by_class.get(cls)
        if bucket is not None:
            bucket.discard(name)
            if not bucket:
                del self._ready_by_class[cls]

    def ready_by_class(self) -> dict:
        """The indexed ready set partitioned by priority class
        (``{class: sorted lane names}``), most important class first —
        the SLO plane's O(1)-maintained view of who is contending."""
        with self._ready_mu:
            return {
                cls: sorted(names)
                for cls, names in sorted(self._ready_by_class.items())
            }

    def _validate(self, lane: _Lane, req: Any) -> None:
        """An unservable request (e.g. prompt beyond the engine's bucket
        family) must raise HERE, on the submitter — once it reaches a lane,
        the failure would surface on the stepping thread and poison every
        tenant's in-flight work."""
        validate = getattr(lane.engine, "validate_request", None)
        if validate is not None:
            validate(req)

    # -- the serving loop --------------------------------------------------

    @staticmethod
    def _engine_tokens(stats: Any) -> Optional[int]:
        """Total tokens an engine has emitted (prefill + decode), or None
        when the engine keeps no token stats."""
        out = getattr(stats, "tokens_out", None)
        if out is None:
            return None
        return out + getattr(stats, "prefill_tokens", 0)

    def lane_active(self, name: str) -> bool:
        """Whether ``name`` has queued or in-flight work right now.

        Lock-free peek (deque length reads are atomic): callers use it to
        decide *whether to try* a step, and a stale answer only costs one
        empty quantum or one short sleep.  Unknown (or just-unregistered)
        lanes report ``False`` — a stepper racing an unregister must see
        "nothing to do", not an exception."""
        lane = self._lane_or_none(name)
        if lane is None:
            return False
        return (
            bool(lane.queue)
            or not lane.engine.idle
            or self._composed_busy(name)
        )

    def _composed_busy(self, name: str) -> bool:
        # a composed member's in-flight work lives in its group's HOST
        # engine, invisible to the lane's own engine.idle — this is the
        # extra activity term every readiness check needs
        comp = self.composer
        return comp is not None and comp.lane_busy(name)

    def _engine_submit_hook(self, name: str) -> Callable[[], None]:
        # fired by the engine inside submit() (under no engine lock that
        # we re-enter); recomputing readiness here is what makes direct
        # engine.submit() traffic reach the indexed ready set
        def hook() -> None:
            lane = self._lane_or_none(name)
            if lane is not None:
                self._touch_ready(lane)
        return hook

    def _active(self) -> list[str]:
        # sync-path truth walk (one pass over every lane): kept for
        # step()/run_until_drained so work submitted to an engine directly,
        # outside this dispatcher, is still served.  The async grant path
        # never calls this — it mirrors the O(active) indexed set instead.
        return [
            lane.name for lane in self._lanes_snapshot()
            if lane.queue
            or not lane.engine.idle
            or self._composed_busy(lane.name)
        ]

    def active_lanes(self) -> list[str]:
        """The indexed ready set: lanes with dispatcher-submitted queued or
        in-flight work, in registration order.  O(active) — read straight
        from the incrementally maintained index, no per-lane peeks, which
        is what the async arbiter's mirror is seeded from.  (Work submitted
        to an engine directly, outside this dispatcher, is visible to the
        sync :meth:`step` loop but not to this index.)"""
        with self._ready_mu:
            names = list(self._active_set)
        rank = self.lane_ranks()
        return sorted(names, key=lambda n: rank.get(n, len(rank)))

    def lane_ranks(self) -> dict:
        """Registration rank per lane name (``{name: index}``) — the
        ordering key consumers use to sort small active subsets in
        registration order without walking the registry per lane.  Ranks
        are stable for a lane's lifetime; unregistering leaves gaps.
        Cache this against :meth:`registration_epoch`: a rank snapshot is
        valid exactly as long as the epoch it was taken under."""
        with self._reg_mu:
            return dict(self._rank)

    def registration_epoch(self) -> int:
        """Monotonic counter bumped by every register/unregister — the
        O(1) validity check for :meth:`lane_ranks` snapshots (a reused
        tenant name gets a NEW rank; a stale cache would keep feeding
        policies the old ordering)."""
        with self._reg_mu:
            return self._reg_epoch

    def fairness_peek(self, active: list, ready: list) -> list:
        """Policy picks over the TRUE active set restricted to ``ready``
        lanes, under the fairness lock — the grant primitive
        (``FairnessPolicy.peek_ready``) ``AsyncDispatcher``'s quantum
        arbiter calls when a readiness event fires or a pool worker asks
        for its next lane (charging still happens in :meth:`step_lane`).
        A transient registration mismatch (a lane mid-register or
        mid-unregister appearing in ``active`` before/after the policy
        knows it) yields no picks rather than an exception — the next
        event re-pumps from consistent state."""
        with self._fair_mu:
            try:
                picks = self.fairness.peek_ready(list(active), list(ready))
            except KeyError:
                picks = []
            events = self._drain_preempted_locked()
        self._report_preemptions(events)
        return picks

    def _drain_preempted_locked(self) -> Any:
        # collect (lane, class) displacement events under _fair_mu; the
        # metrics feed happens after release (metrics' lock stays a leaf)
        drain = getattr(self.fairness, "drain_preempted", None)
        return drain() if drain is not None else ()

    def _report_preemptions(self, events: Any) -> None:
        for _, cls in events:
            self.metrics.on_preemption(cls)

    def shed(self, *, now: Optional[float] = None) -> list:
        """Shed queued requests whose deadlines are provably unmeetable.

        Walks every lane that carries a latency target, collects queued
        requests that can no longer finish by their deadline (given the
        class's current service estimate and their queue position), and
        fails them one at a time — each round's victim chosen by
        :meth:`SLOPolicy.pick_shed`: the **lowest class with the latest
        deadline**, so interactive work is the last to go.  A shed request
        completes with ``error`` set and a typed
        :class:`~repro_torch.dispatch.slo.AdmissionRejected` attached (the async
        layer fails its future with it); the pending backpressure charge
        is released through the normal completion path and per-class shed
        counters are bumped.  In-flight (seated) requests are never
        touched — shedding, like preemption, acts only at the queue.
        Returns the shed requests.  Triggered automatically on submit
        while the adaptive controller reports overload; safe to call
        directly at any time (no-op when every deadline is still
        meetable)."""
        shed_reqs: list = []
        # each round re-walks the queues (positions shift as victims
        # leave); bounded by the pending cap so a racing producer cannot
        # pin the submitter in here
        for _ in range(self.max_pending + 1):
            cands: list = []
            for lane in self._lanes_snapshot():
                if self.slo.target_s(lane.name) is None:
                    continue
                with lane.queue_mu:
                    queued = list(lane.queue)
                for pos, req in enumerate(queued):
                    dl = getattr(req, "deadline", 0.0)
                    if dl and self.slo.unmeetable(
                        lane.name, dl, pos, now=now
                    ):
                        cands.append(
                            (lane.name, lane.priority_class, dl, req)
                        )
            if not cands:
                break
            i = self.slo.pick_shed([c[:3] for c in cands])
            name, cls, dl, req = cands[i]
            lane = self._lane_or_none(name)
            if lane is None:
                continue
            with lane.queue_mu:
                try:
                    lane.queue.remove(req)
                    removed = True
                except ValueError:
                    removed = False   # a stepper seated it first: not ours
            if not removed:
                continue
            exc = AdmissionRejected(
                f"shed under overload: {name!r} (class {cls}) deadline "
                "became unmeetable while queued",
                lane=name, priority_class=cls, deadline=dl,
            )
            self.lifecycle.advance(req, RequestState.SHED, lane=name)
            req.error = str(exc)
            req._admission_error = exc
            req.done = True
            req.t_done = time.perf_counter()
            self.metrics.on_shed(cls)
            self._touch_ready(lane)
            self._complete(name, [req])
            # a shed can be what empties a retiring lane's queue
            self._maybe_finalize_retire(lane)
            shed_reqs.append(req)
        return shed_reqs

    def step_lane(self, name: str, *, release: Optional[Callable[[], None]] = None) -> list:
        """One scheduling quantum for a single lane; returns its finished
        requests.  The per-engine stepping primitive: concurrent calls on
        *different* lanes overlap (each under its own ``step_mu``), and the
        engine's single-stepper contract is upheld per lane.

        Charges the fairness policy for the quantum and feeds per-engine
        step metrics.  ``release``, if given, is invoked once the engine
        step and the fairness charge are done but BEFORE completion
        callbacks fire — the async layer returns its arbiter grant there,
        so a slow user callback never holds a scheduling quantum hostage.
        The lane's ready-index transition fires before ``release``, so the
        re-pump the release triggers already sees post-step truth.
        Completion callbacks run on the calling thread, outside every
        dispatcher lock.  A lane unregistered between grant and step is a
        no-op quantum (``release`` still runs) — never an error on the
        stepping thread.

        A lane composed into a :class:`~repro_torch.dispatch.batching.ComposeGroup`
        delegates its quantum to :meth:`step_group` — the host engine is
        then only ever stepped under the group's step lock, which is what
        keeps the single-stepper contract intact with N lanes sharing it.
        """
        comp = self.composer
        if comp is not None and comp.group_of(name) is not None:
            return self.step_group(name, release=release)
        return self._step_lane_solo(name, release=release)

    def _step_lane_solo(
        self, name: str, *, release: Optional[Callable[[], None]] = None
    ) -> list:
        lane = self._lane_or_none(name)
        if lane is None:
            # unregistered while a grant was in flight: return the quantum
            # and report nothing finished
            if release is not None:
                release()
            return []
        seated: list = []
        with lane.step_mu:
            engine = lane.engine
            # admission control: only hand the engine what it can seat now,
            # so queueing (and thus backpressure) stays visible here
            with lane.queue_mu:
                while lane.queue and engine.free_slots() > 0:
                    req = lane.queue.popleft()
                    seated.append(req)
                    engine.submit(req)
            stats = getattr(engine, "stats", None)
            tok_before = self._engine_tokens(stats)
            t0 = time.perf_counter()
            newly = engine.step()
            dt = time.perf_counter() - t0
            if tok_before is not None:
                tokens = self._engine_tokens(stats) - tok_before
            else:
                # duck-typed engine without token stats: charge a finished
                # request's output in one burst at completion
                tokens = sum(len(r.generated) for r in newly)
            if self.tracer.enabled:
                # span lands on the stepping thread's track — in pool mode
                # that is what makes multi-worker overlap visible
                self.tracer.complete(
                    f"step:{name}", t0, dt, cat="step", lane=name,
                    args={"tokens": tokens, "finished": len(newly)},
                )
        # lifecycle transitions for this quantum's admissions, after the
        # step lock is released: the quantum popped them (GRANTED) and
        # handed them to the engine (STEPPING).  A crash before these
        # records land replays the requests as QUEUED — same tokens, one
        # redundant re-grant
        for req in seated:
            self.lifecycle.advance(req, RequestState.GRANTED, lane=name)
            self.lifecycle.advance(req, RequestState.STEPPING, lane=name)
        with self._fair_mu:
            self.fairness.charge(name, steps=1, tokens=tokens)
        self.metrics.on_engine_step(name, dt, tokens=tokens)
        self.slo.on_step(name, dt)   # class service-time estimate feed
        # fold the post-step truth into the ready index (and deliver the
        # delta to the arbiter) BEFORE returning the grant: the release
        # re-pump must not re-grant a lane this quantum just drained
        self._touch_ready(lane)
        if release is not None:
            release()
        self._complete(name, newly)
        # retired lane: the quantum that completes its last request
        # finalizes the removal and resolves the retire future
        self._maybe_finalize_retire(lane)
        if self.journal is not None:
            # quantum boundary: nudge the journal writer to commit (and
            # fsync) everything this quantum recorded — outside all locks
            self.journal.quantum_mark()
        return newly

    def step_group(
        self, name: str, *, release: Optional[Callable[[], None]] = None
    ) -> list:
        """One COMPOSED scheduling quantum: step the host engine of
        ``name``'s compose group, serving every member's in-flight
        sequences in one batched decode; returns all finished requests
        (any member's).

        The quantum, under the group's step lock (never the host lane's —
        one stepper in the host at a time, whoever's grant arrived):

        1. **refill** — freed host slots are seated from member lane
           queues in fairness-policy order (``peek_ready`` over the
           group's members), falling back to join order when the policy
           holds for a lane with nothing queued (work conservation beats
           an idle slot);
        2. **step** — one ``host.step()``: one sealed decode step serving
           N tenants;
        3. **attribute** — per-lane token deltas are measured per slot
           (each seated request knows its owner), the fairness policy is
           charged via ``charge_composed`` (the step splits by token
           share; tokens charge in full), composer metrics record
           occupancy/coalescing, and a ``composed:<host>`` span plus
           per-tenant share instants land in the trace;
        4. member engines holding DIRECT submissions (work seated outside
           the dispatcher) are stepped too — their KV lives in their own
           engine, not the host.

        Ready-index transitions for every member fire before ``release``;
        completion callbacks run last, outside all locks, routed per
        request owner.  A group dissolved between grant and step falls
        back to a solo quantum.
        """
        comp = self.composer
        group = comp.group_of(name) if comp is not None else None
        if group is None:
            return self._step_lane_solo(name, release=release)
        with group.step_mu:
            host = group.host
            members = comp.members(name)
            if not members:
                members = [name]
            retiring = group.retiring
            refill_from = [retiring] if retiring is not None else members
            seated = self._refill_group(group, members, refill_from)
            # pre-step snapshot of every request that can emit tokens this
            # step: seated slots plus engine-queued admissions
            before = [
                (req, len(req.generated))
                for req in list(getattr(host, "slots", ()))
                + list(getattr(host, "queue", ()))
                if req is not None
            ]
            t0 = time.perf_counter()
            newly = list(host.step())
            dt = time.perf_counter() - t0
            tokens_by_lane: dict[str, int] = {}
            for req, n0 in before:
                d = len(req.generated) - n0
                if d > 0:
                    owner = getattr(req, "model", "") or group.host_lane
                    tokens_by_lane[owner] = tokens_by_lane.get(owner, 0) + d
            occupied = sum(
                1 for s in getattr(host, "slots", ()) if s is not None
            )
            occupied += sum(
                1 for r in newly if getattr(r, "error", None) is None
            )
            capacity = len(getattr(host, "slots", ()))
            if self.tracer.enabled:
                # one decode span for the shared step, fanning out to
                # per-tenant share instants (cat="composer")
                self.tracer.complete(
                    f"composed:{group.host_lane}", t0, dt, cat="step",
                    lane=group.host_lane,
                    args={
                        "lanes": len(tokens_by_lane),
                        "occupied": occupied,
                        "finished": len(newly),
                    },
                )
                for owner, toks in tokens_by_lane.items():
                    self.tracer.instant(
                        "composed_share", cat="composer", lane=owner,
                        args={"tokens": toks},
                    )
            # escape hatch: direct engine.submit() work lives in the
            # member's OWN engine (its KV is there) — step it alongside
            for m in members:
                if m == group.host_lane:
                    continue
                lane_m = self._lane_or_none(m)
                if lane_m is None or lane_m.engine.idle:
                    continue
                eng = lane_m.engine
                with lane_m.step_mu:
                    mb = [
                        (r, len(r.generated))
                        for r in list(getattr(eng, "slots", ()))
                        + list(getattr(eng, "queue", ()))
                        if r is not None
                    ]
                    newly.extend(eng.step())
                d = sum(len(r.generated) - n0 for r, n0 in mb)
                if d > 0:
                    tokens_by_lane[m] = tokens_by_lane.get(m, 0) + d
        # composed admissions: the group quantum granted + seated them
        # (lifecycle records land after the group step lock is released)
        for owner, req in seated:
            self.lifecycle.advance(req, RequestState.GRANTED, lane=owner)
            self.lifecycle.advance(req, RequestState.STEPPING, lane=owner)
        if tokens_by_lane:
            with self._fair_mu:
                try:
                    self.fairness.charge_composed(tokens_by_lane)
                except KeyError:
                    pass   # a lane mid-(un)register: skip the charge
            for owner, toks in tokens_by_lane.items():
                # per-engine series keep per-tenant visibility; composed
                # steps appear in every occupant's series with the shared
                # step's wall time
                self.metrics.on_engine_step(owner, dt, tokens=toks)
                self.slo.on_step(owner, dt)
        if occupied or tokens_by_lane:
            self.metrics.on_composed_step(
                dt, occupied=occupied, capacity=capacity,
                tokens_by_lane=tokens_by_lane,
            )
        for m in members:
            lane_m = self._lane_or_none(m)
            if lane_m is not None:
                self._touch_ready(lane_m)
        if release is not None:
            release()
        by_owner: dict[str, list] = {}
        for req in newly:
            owner = getattr(req, "model", "") or group.host_lane
            by_owner.setdefault(owner, []).append(req)
        for owner, reqs in by_owner.items():
            self._complete(owner, reqs)
        # a retiring member's work drains through ANY member's quantum —
        # check every member so whichever quantum ran it dry finalizes
        for m in members:
            lane_m = self._lane_or_none(m)
            if lane_m is not None:
                self._maybe_finalize_retire(lane_m)
        if self.journal is not None:
            self.journal.quantum_mark()
        return newly

    def _refill_group(self, group: Any, members: list, refill_from: list) -> list:
        """Seat freed host slots from member lane queues, one seat per
        fairness pick (called under the group's step lock).  ``refill_from``
        restricts donors during a disband drain.  Returns the seated
        ``(lane name, request)`` pairs so the caller can record their
        lifecycle transitions once the group lock is released."""
        host = group.host
        seated: list = []
        lanes: dict[str, _Lane] = {}
        for m in refill_from:
            lane = self._lane_or_none(m)
            if lane is not None and lane.queue:
                lanes[m] = lane
        while lanes and host.free_slots() > 0:
            queued = [m for m in members if m in lanes]
            live = set(group.occupancy())
            active = [m for m in members if m in lanes or m in live]
            with self._fair_mu:
                try:
                    picks = self.fairness.peek_ready(active, queued)
                except KeyError:
                    picks = []
            pick = next((p for p in picks if p in lanes), None)
            if pick is None:
                # the policy held its quantum for a lane with nothing
                # queued: seat in join order rather than idle a slot
                pick = queued[0]
            lane = lanes[pick]
            with lane.queue_mu:
                req = lane.queue.popleft() if lane.queue else None
            if req is None:
                del lanes[pick]
                continue
            host.submit(req)
            seated.append((pick, req))
            if not lane.queue:
                del lanes[pick]
        return seated

    def _complete(self, name: str, newly: list) -> None:
        """Account finished requests and fire their callbacks (no locks
        held — a slow or re-entrant callback cannot stall other lanes)."""
        for req in newly:
            # enforced terminal transition (shed requests arrive already
            # terminal; direct engine submissions carry no state and are
            # skipped by the tracker)
            if not self.lifecycle.is_terminal(req):
                dst = (
                    RequestState.FAILED
                    if getattr(req, "error", None) is not None
                    else RequestState.COMPLETED
                )
                self.lifecycle.advance(req, dst, lane=name)
            if self.tracer.enabled:
                self.tracer.instant(
                    "complete", cat="request", lane=name, rid=req.rid,
                    args={"tokens": len(req.generated)},
                )
                self.tracer.async_end("request", req.rid, lane=name)
            self.metrics.observe_request(req)
            self.completed.append(req)
            if getattr(req, "error", None) is None:
                # served requests with a latency target feed the adaptive
                # controller and the per-class deadline-miss series (shed
                # requests never do — they'd double-count the overload)
                target = self.slo.target_s(name)
                if target is not None and req.t_done and req.t_submit:
                    missed = self.slo.on_complete(
                        name, req.t_done - req.t_submit
                    )
                    self.metrics.on_deadline(
                        self.slo.lane_class(name), missed
                    )
            if getattr(req, "_dispatcher_pending", False):
                req._dispatcher_pending = False
                with self._count_mu:
                    self._pending_count -= 1
            cb = getattr(req, "on_complete", None)
            if cb is not None:
                cb(name, req)

    def step(self) -> list:
        """One dispatch quantum over all lanes; returns requests that
        finished during it.

        The fairness policy picks which active lanes (lanes with queued or
        in-flight work) are served and in what order; each served lane is
        charged the decode step and the tokens it produced, so ``weighted``
        and ``quota`` policies converge on their configured shares.  Safe
        to call from multiple threads (lane steps serialize per lane), but
        one driver — or per-engine steppers via ``step_lane`` — is the
        intended shape.
        """
        active = self._active()
        if not active:
            return []
        with self._fair_mu:
            try:
                order = self.fairness.select(active)
            except KeyError:
                # a lane mid-(un)register: skip the quantum, next one sees
                # consistent registry + policy state
                order = []
            events = self._drain_preempted_locked()
        self._report_preemptions(events)
        finished = []
        served_groups: set[int] = set()
        for name in order:
            comp = self.composer
            group = comp.group_of(name) if comp is not None else None
            if group is not None:
                # one composed step serves every member: don't re-step the
                # shared host once per member in the same quantum
                if id(group) in served_groups:
                    continue
                served_groups.add(id(group))
            finished.extend(self.step_lane(name))
        return finished

    @property
    def idle(self) -> bool:
        """True when no dispatcher-submitted request is pending and every
        engine reports itself idle (covers work submitted to an engine
        directly, outside this dispatcher)."""
        if self.pending() > 0:
            return False
        return all(lane.engine.idle for lane in self._lanes_snapshot())

    def run_until_drained(self, max_steps: int = 100_000) -> list:
        """Step until every lane and engine is empty; returns all requests
        finished during the drain, in completion order.

        Raises :class:`DrainTimeoutError` if ``max_steps`` quanta pass with
        requests still pending — a wedged engine or a non-work-conserving
        policy must surface, not silently return a partial drain.
        """
        finished = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if self.idle:
                return finished
        if self.idle:
            return finished
        raise DrainTimeoutError(
            f"drain exhausted {max_steps} steps with "
            f"{self.pending()} requests still pending"
        )

    def snapshot(self) -> dict:
        """Metrics snapshot including per-model schedule-cache stats,
        per-engine step series, pending depth, and fairness state."""
        caches = {}
        for lane in self._lanes_snapshot():
            cache = getattr(lane.engine, "schedule_cache", None)
            if cache is not None:
                caches[lane.name] = cache.stats.as_dict()
        snap = self.metrics.snapshot()
        if caches:
            snap["schedule_cache"] = caches
        snap["models"] = list(self.models)
        snap["pending"] = self.pending()
        with self._ready_mu:
            snap["ready_lanes"] = len(self._active_set)
            snap["ready_by_class"] = {
                cls: len(names)
                for cls, names in sorted(self._ready_by_class.items())
            }
        snap["slo"] = self.slo.snapshot()
        with self._fair_mu:
            snap["fairness"] = self.fairness.snapshot()
        if self.composer is not None:
            snap["compose_groups"] = self.composer.snapshot()
        if self.journal is not None:
            snap["journal"] = self.journal.stats()
        return snap

    # -- crash recovery ----------------------------------------------------

    def recover(
        self,
        journal: Any,
        *,
        engines: Optional[dict] = None,
        register: Optional[Callable[..., Any]] = None,
        on_requeue: Optional[Callable[[Any], None]] = None,
    ) -> dict:
        """Rebuild the control plane from ``journal`` after a restart.

        Call on a fresh dispatcher (normally one constructed with the
        same journal attached, so the recovered state is re-journaled
        going forward).  Three phases, in order:

        1. **Lanes** — every journaled lane whose latest state is not
           ``RETIRED`` is re-registered with its original weight,
           priority class, and latency target.  The engine comes from
           ``engines[name]`` when the caller provides one, else it is
           rebuilt from the lane's journaled
           :class:`~repro_torch.serving.spec.EngineSpec` recipe (built
           in-process on device 0; pass ``register=`` to route
           registration elsewhere, e.g. ``AsyncDispatcher`` hands specs
           to its worker plane).  A lane journaled without a spec and
           without a caller engine raises
           :class:`~repro_torch.dispatch.errors.JournalCorrupt` — it cannot be
           recovered.
        2. **Requests** — every non-terminal request is requeued on its
           lane in original admission order, bypassing admission control
           (the work was already admitted once; backpressure applies to
           *new* submissions).  A request that was ``STEPPING`` at crash
           time is first marked ``INTERRUPTED`` (journaled), then
           requeued — resubmission is idempotent because engines are
           rebuilt fresh, so its tokens regenerate from the start.  One
           that was ``GRANTED`` goes through ``PREEMPTED`` (its quantum
           died with the old process).  The rid allocator is advanced
           past every journaled rid.
        3. **Retiring lanes** — lanes that were mid-retire resume
           draining: ``retire_model`` is re-issued after their work is
           requeued.

        ``on_requeue(req)`` (optional) runs for each rebuilt request
        just before it re-enters its lane queue — attach completion
        callbacks or futures there, BEFORE any stepper can finish the
        request (``AsyncDispatcher.recover`` uses it to hand back
        futures).

        Returns a report dict: ``lanes`` (recovered names), ``requeued``,
        ``interrupted``, ``preempted``, ``skipped`` (requests whose lane
        could not be recovered), and ``requests`` (the rebuilt
        :class:`~repro_torch.serving.Request` objects, in requeue order)."""
        state = journal.recover_state()
        reg = register if register is not None else self._register_recovered
        lanes: list = []
        retiring: list = []
        for rec in state.lanes:
            if self.has_model(rec.name):
                continue   # caller pre-registered it; keep their engine
            engine = (engines or {}).get(rec.name)
            if engine is None and rec.spec is None:
                raise JournalCorrupt(
                    f"lane {rec.name!r} was journaled without an engine "
                    "spec; pass engines={name: engine} to recover it",
                    path=getattr(journal, "path", ""),
                )
            reg(
                rec.name,
                engine if engine is not None else rec.spec,
                weight=rec.weight,
                priority_class=rec.priority_class,
                latency_target_ms=rec.latency_target_ms,
                spec=rec.spec,
            )
            lanes.append(rec.name)
            if rec.state == LaneState.RETIRING:
                retiring.append(rec.name)
        report = self._requeue_recovered(state, on_requeue=on_requeue)
        for name in retiring:
            self.retire_model(name)
        report["lanes"] = lanes
        return report

    def _register_recovered(self, name: str, engine_or_spec: Any, **kw: Any) -> Any:
        """Default recovery registration: a bare spec is built in-process
        on device 0 (``AsyncDispatcher.recover`` overrides this to hand
        specs to its stepping plane instead)."""
        from repro_torch.serving.spec import EngineSpec  # lazy: avoid cycle

        engine = engine_or_spec
        if isinstance(engine, EngineSpec):
            engine = engine.build(0)
        return self.register_model(name, engine, **kw)

    def _requeue_recovered(
        self, state: Any, *, on_requeue: Optional[Callable[[Any], None]] = None
    ) -> dict:
        """Phase 2 of :meth:`recover`: requeue every journaled
        non-terminal request in admission order (see :meth:`recover` for
        the semantics)."""
        from repro_torch.serving.engine import Request  # lazy: avoid import cycle

        requeued = interrupted = preempted = skipped = 0
        requests: list = []
        with self._count_mu:
            self._next_rid = max(self._next_rid, state.max_rid + 1)
        for rec in state.requests:
            lane = self._lane_or_none(rec.lane)
            if lane is None:
                skipped += 1
                continue
            req = Request(
                rid=rec.rid,
                prompt=rec.prompt,
                max_new_tokens=rec.max_new_tokens,
                tenant=rec.tenant,
                model=rec.lane,
            )
            if rec.deadline:
                req.deadline = rec.deadline
            req.state = rec.state
            req._journaled = True
            if rec.state == RequestState.STEPPING:
                # it may have produced tokens the old process lost:
                # mark the interruption durably, then resubmit — engines
                # were rebuilt, so the replay regenerates from scratch
                self.lifecycle.advance(req, RequestState.INTERRUPTED)
                interrupted += 1
            elif rec.state == RequestState.GRANTED:
                self.lifecycle.advance(req, RequestState.PREEMPTED)
                preempted += 1
            req._dispatcher_pending = True
            req.t_submit = time.perf_counter()
            if on_requeue is not None:
                on_requeue(req)
            requests.append(req)
            with self._count_mu:
                self._pending_count += 1
            self.metrics.on_submit(req.t_submit)
            self.lifecycle.advance(req, RequestState.QUEUED, lane=rec.lane)
            with lane.queue_mu:
                lane.queue.append(req)
            if lane.lc_state == LaneState.REGISTERED:
                self.lifecycle.lane_advance(lane, LaneState.ACTIVE)
            if self.tracer.enabled:
                self.tracer.async_begin("request", req.rid, lane=rec.lane)
                self.tracer.instant(
                    "requeued", cat="request", lane=rec.lane, rid=req.rid
                )
            self._touch_ready(lane)
            requeued += 1
        return {
            "requeued": requeued,
            "interrupted": interrupted,
            "preempted": preempted,
            "skipped": skipped,
            "requests": requests,
        }
