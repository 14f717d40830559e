"""Async front door: future-returning ``submit`` over per-engine steppers.

The port of the JAX package's ``dispatch/async_dispatcher.py``; on the card
a stepper replays CUDA graphs, and a lane that registers (or a schedule
cache that re-seals after an eviction) captures one while other lanes
replay — :mod:`repro_torch.core.capture` keeps the two apart.

Nimble's run-time loop is pure submission — every scheduling decision was
paid ahead of time (the Nimble paper, §4.1 and §4.3) — but the synchronous ``Dispatcher``
still makes callers *host* that loop: ``run_until_drained`` blocks the
submitting thread.  :class:`AsyncDispatcher` moves the loop onto daemon
threads so the caller's critical path is exactly one bounded-queue append:

    async_disp = AsyncDispatcher(fairness="weighted")
    async_disp.register_model("m", engine, weight=3.0)
    async_disp.start()
    fut = async_disp.submit("m", prompt)      # returns immediately
    req = fut.result(timeout=30)              # tokens in req.generated
    async_disp.stop()                         # drains, then joins

Stepping models (``stepping=``):

* ``"per-engine"`` (default) — one stepper thread per registered model, so
  decode **overlaps across tenants** (the paper's parallelism argument
  applied to serving: independent engines are independent GPU work and
  must not be serialized by the scheduler).  The shared ``FairnessPolicy``
  still arbitrates quanta through a :class:`_QuantumArbiter`: a stepper
  acquires a grant before each engine step, and ``max_concurrent_steps``
  caps how many grants are outstanding (``None`` — no cap; ``1`` — strict
  serial policy order even with many steppers).  How much actually
  overlaps is the POLICY's call: ``round_robin`` and ``quota`` grant every
  eligible lane per quantum (full overlap); ``weighted`` stride scheduling
  picks exactly one lane per quantum by construction — rationing quanta IS
  its semantics, so weighted shares stay exact and decode stays
  effectively serial.  Pick round_robin/quota when raw overlap matters
  more than weighted shares.
* ``"pool"`` — a small FIXED worker pool (``pool_size``, default
  ``min(8, os.cpu_count())``) multiplexing every registered lane: the
  hundred-tenant shape, where per-engine's thread-per-model collapses
  into hundreds of parked threads.  Any idle worker pulls the policy's
  next ready lane from the arbiter (the shared ready set is the pool's
  work queue), so the stepper thread count stays at ``pool_size`` no
  matter how many tenants register, while outputs stay token-identical
  and fairness ordering still flows through the arbiter.
* ``"single"`` — the legacy loop: one thread stepping all lanes in policy
  order.  Kept as the benchmark baseline and for strictly-serial setups.

Quantum hand-off is **event-driven and O(active)**: the dispatcher's
lane-event hook feeds ``(lane, active)`` deltas from its indexed ready
set into the arbiter's mirror (no registry walk ever happens on the
grant path), and each delta or ``release`` re-runs the grant pump
immediately, handing the freed quantum to exactly one parked executor
(per-worker parking slots — a grant is a single targeted ``notify``, not
a ``notify_all`` herd).  One designated *ticker* per arbiter waits with
a timeout purely as the quota-refill fallback (time-based credit appears
with no event); every other parked worker sleeps untimed, so
wakeups-per-grant stays ≤ 2 no matter the pool size.

Invariant (the paper's): stepper threads NEVER trace or compile — they
only replay sealed executables.  Engines must be warmed at registration
(finite bucketing policies warm eagerly; an exact policy can lazily build
on a stepper, which ``builds_on_thread`` / ``builds_by_stepper`` expose so
tests and operators can assert the invariant holds per stepper — pool
workers report under their ``pool-N`` labels).

Locking protocol (deadlock-free by ordering): the dispatcher's ready-set
lock is taken before the arbiter's mutex (deltas are delivered under
it), steppers take the arbiter's mutex before the dispatcher's fairness
and registry locks, lane locks before the fairness lock, and this
class's condition is held only across leaf-lock peeks into the
dispatcher (``lane_active`` / ``idle`` — registry and counter locks),
never across an engine step or an arbiter call — ``drain`` and ``stop``
wait only on loop-published state (the busy-lane set, ``_pending``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Optional

from repro_torch.obs.tracer import get_tracer

from .dispatcher import Dispatcher, DrainTimeoutError
from .fairness import FairnessSpec
from .metrics import DispatchMetrics
from .slo import AdmissionRejected

_SINGLE = "loop"         # stepper label in "single" mode


class _ParkSlot:
    """One parked executor: a pool worker or a per-engine stepper.

    Each slot owns a private condition over the arbiter's one mutex, so a
    grant wakes exactly the executor it is for — hand-off style — instead
    of ``notify_all``-ing the whole fleet.  ``lane`` is the hand-off
    mailbox (the pump deposits the granted lane before notifying);
    ``evicted`` marks a per-engine waiter whose lane vanished (drained by
    another thread or unregistered); ``timed_wait`` is True only while the
    owning thread is parked with a timeout (the designated ticker)."""

    __slots__ = ("cv", "lane", "since", "evicted", "timed_wait")

    def __init__(self, mu: threading.Lock, since: float) -> None:
        self.cv = threading.Condition(mu)
        self.lane: Optional[str] = None
        self.since = since            # executor free since (grant floor)
        self.evicted = False
        self.timed_wait = False


class _QuantumArbiter:
    """Grants stepping quanta through the shared policy, event-driven,
    with O(active) per-event cost — never O(registered tenants).

    Two grant shapes:

    * **per-engine** — a dedicated stepper calls :meth:`acquire` for ITS
      lane and blocks on its own parking slot until the policy grants it;
    * **pool** — any idle worker calls :meth:`acquire_any`; a granted lane
      is *handed* to exactly one parked worker (single ``notify``), and a
      worker arriving while grants are banked pops the policy-ordered
      grant queue without re-running selection.

    Both call :meth:`release` after the engine step.  Grants flow through
    ``FairnessPolicy.peek_ready`` over the **mirrored ready index**: the
    dispatcher's lane-event hook feeds ``(lane, active)`` deltas into
    ``_active``, so a pump touches only lanes that currently have work —
    the contender scan no longer walks the registry, and ``_ready_since``
    stamps are evicted on the inactive delta instead of by a per-pump
    full-dict sweep.  ``max_concurrent`` bounds outstanding grants (a lane
    is never granted to two workers at once, bound or no bound).

    **Per-worker parking (the wakeup contract)**: every event wakes at
    most the executors it grants to, plus at most one promotion notify —
    when the parked set's head changes, the new head is woken once so it
    re-parks as the *designated ticker*.  Only the ticker waits with a
    timeout (``tick``, default 10 ms), which survives purely as the
    quota-refill fallback: time-based credit appears with no triggering
    event, and one ticker discovering it is enough — the rest of the pool
    sleeps untimed.  Wakeups-per-grant is therefore ≤ 2 by construction
    (one hand-off + at most one promotion), vs ≈ pool_size under the old
    ``notify_all`` scheme.  ``grants`` counts all grants, ``timed_grants``
    grants the fallback tick served (best-effort attribution: a racing
    event grant landing between a tick expiry and that thread's own pump
    is counted as timed), ``timed_wakeups`` every tick expiry (idle
    parking included), and ``notify_wakeups`` every targeted notify
    (hand-offs, promotions, evictions).  Per-grant latency feeds
    ``metrics.on_grant``; per-grant CPU cost (selection + bookkeeping
    time over grants issued) feeds ``metrics.on_grant_cost``; ready-set
    size samples feed ``metrics.on_ready_size``.

    When the policy's top pick is an active lane that is not ready (its
    stepper mid-bookkeeping, or the lane already executing), the arbiter
    holds other grants rather than handing the quantum to a
    less-deserving lane — that hold is what keeps e.g. stride ratios
    exact at ``max_concurrent=1``.  Multi-grant policies (``drr``,
    ``round_robin``, ``quota``) return several picks per pump; the pool
    hands one to each parked worker and banks the rest in the grant
    queue.

    Lock order: the arbiter mutex is taken before the dispatcher's
    registry and fairness locks, never the reverse; it is never held
    around an engine step.  The dispatcher's ready-set lock is above the
    arbiter mutex (deltas arrive under it).
    """

    _FALLBACK_WAIT = 0.01     # quota refills are time-driven; events cover the rest

    def __init__(
        self,
        dispatcher: Dispatcher,
        max_concurrent: Optional[int],
        *,
        metrics: Optional[DispatchMetrics] = None,
        pool_size: int = 0,
        tick: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        tracer: Optional[Any] = None,
    ):
        if max_concurrent is not None and max_concurrent < 1:
            raise ValueError(
                f"max_concurrent_steps must be >= 1 or None, got {max_concurrent}"
            )
        self._disp = dispatcher
        self._max = max_concurrent
        self._metrics = metrics
        self._tracer = tracer if tracer is not None else get_tracer()
        self._pool_size = pool_size          # 0: per-engine mode
        self._tick = self._FALLBACK_WAIT if tick is None else tick
        self._clock = clock
        self._mu = threading.Lock()          # one mutex; per-slot conditions
        self._active: set[str] = set()       # delta-fed ready-index mirror
        self._waiting: dict[str, _ParkSlot] = {}   # per-engine: lane -> slot
        self._parked: dict[int, _ParkSlot] = {}    # pool: id(slot) -> slot, FIFO
        self._granted_q: deque = deque()     # banked policy-ordered grants
        self._inflight: set[str] = set()     # grants being executed
        self._ready_since: dict[str, float] = {}   # lane -> grantable since
        self._rank: dict[str, int] = {}      # registration-order cache
        self._rank_epoch = -1                # dispatcher epoch it was cut at
        self._last_event = 0.0               # last grant-enabling event
        self._closed = False
        self.grants = 0                      # quanta handed out
        self.timed_wakeups = 0               # fallback-tick expiries (incl. idle)
        self.timed_grants = 0                # grants the fallback tick served
        self.notify_wakeups = 0              # targeted notifies (hand-off/promote)
        self.pump_cpu_s = 0.0                # CPU seconds spent selecting/granting
        self.group_grants = 0                # grants widened to a compose group
        self.co_grants = 0                   # co-member quanta claimed alongside

    # -- executor-facing ---------------------------------------------------

    def acquire(self, lane: str) -> bool:
        """Block until the policy grants ``lane`` a quantum (per-engine
        mode); False once the arbiter is closed, the lane is no longer
        registered, or the lane was evicted (drained by another thread or
        unregistered) — the stepper should re-check its lane's state and
        try again."""
        with self._mu:
            # refuse a lane that is already unregistered: a stepper racing
            # unregister_model past the eviction delta must not park a
            # phantom waiter the policies would trip over forever
            if self._closed or not self._disp.has_model(lane):
                return False
            slot = _ParkSlot(self._mu, self._clock())
            self._waiting[lane] = slot
            self._pump_locked()
            timed = False
            parked = False
            while slot.lane is None:
                if self._closed or slot.evicted:
                    if self._waiting.get(lane) is slot:
                        del self._waiting[lane]
                        self._promote_ticker_locked()
                    return False
                if not parked and self._tracer.enabled:
                    parked = True
                    self._tracer.instant("park", cat="arbiter", lane=lane)
                slot.timed_wait = self._ticker_locked() is slot
                expired = not slot.cv.wait(
                    self._tick if slot.timed_wait else None
                )
                slot.timed_wait = False
                timed = expired        # attribute the grant to ITS wakeup
                if expired:
                    self.timed_wakeups += 1
                    if self._tracer.enabled:
                        self._tracer.instant("tick", cat="arbiter", lane=lane)
                    self._pump_locked()
            if timed:
                self.timed_grants += 1
            if parked and self._tracer.enabled:
                self._tracer.instant("wake", cat="arbiter", lane=lane)
            return not self._closed

    def acquire_any(self) -> Optional[str]:
        """Block until the policy grants SOME ready lane (pool mode);
        returns the lane to step, or ``None`` once the arbiter is closed.
        A banked grant is popped without re-running selection; otherwise
        the worker parks on its own slot and is woken only when a grant is
        handed specifically to it (or, for the one designated ticker, when
        the quota-refill fallback tick expires)."""
        with self._mu:
            slot = _ParkSlot(self._mu, self._clock())
            timed = False
            try:
                while not self._closed:
                    if slot.lane is not None:      # handed off while parked
                        lane, slot.lane = slot.lane, None
                        if timed:
                            self.timed_grants += 1
                        if self._tracer.enabled:
                            self._tracer.instant(
                                "wake", cat="arbiter", lane=lane
                            )
                        return lane
                    lane = self._pick_locked(slot.since)
                    if lane is not None:
                        if timed:
                            self.timed_grants += 1
                        return lane
                    # park (keeping original FIFO position across spurious
                    # and promotion wakes — a promoted worker re-times its
                    # wait without unparking, so one promotion never
                    # cascades into waking the next worker, and the next)
                    if id(slot) not in self._parked:
                        self._parked[id(slot)] = slot
                        if self._tracer.enabled:
                            self._tracer.instant("park", cat="arbiter")
                    slot.timed_wait = self._ticker_locked() is slot
                    expired = not slot.cv.wait(
                        self._tick if slot.timed_wait else None
                    )
                    slot.timed_wait = False
                    timed = expired    # attribute the grant to ITS wakeup
                    if expired:
                        self.timed_wakeups += 1
                        if self._tracer.enabled:
                            self._tracer.instant("tick", cat="arbiter")
                        # the designated ticker is the one executor awake on
                        # a wall-clock cadence, so it owns the idle-period
                        # occupancy samples — without this, the series only
                        # ever sees grant instants and a parked pool looks
                        # exactly as busy as its last grant left it
                        if self._pool_size and self._metrics is not None:
                            self._metrics.on_pool_occupancy(
                                len(self._inflight), self._pool_size
                            )
                return None
            finally:
                # leaving for any reason (grant, close): free the parking
                # spot and hand the ticker role to the next in line
                if self._parked.get(id(slot)) is slot:
                    del self._parked[id(slot)]
                    self._promote_ticker_locked()

    def acquire_group(self, lane: str, members: list) -> list:
        """Widen ``lane``'s already-held grant to its compose group: claim
        every co-member that is active and not already granted, so ONE
        worker drives the composed step on behalf of all of them and no
        second worker can be granted a co-member mid-step.  Returns the
        claimed lane list (``lane`` first) for :meth:`release_group`.
        Non-blocking — co-members that are inactive or already executing
        are simply not claimed (their work is still served by the
        composed step; their own grants, if any, find an empty lane)."""
        with self._mu:
            claimed = [lane]
            for m in members:
                if m == lane or m in self._inflight or m not in self._active:
                    continue
                self._inflight.add(m)
                self._ready_since.pop(m, None)
                self.co_grants += 1
                claimed.append(m)
            if len(claimed) > 1:
                self.group_grants += 1
                claimed_set = set(claimed)
                if self._granted_q:
                    # a banked grant for a claimed lane must not leak to
                    # another worker while the composed step runs
                    self._granted_q = deque(
                        n for n in self._granted_q if n not in claimed_set
                    )
            return claimed

    def release_group(self, lanes: list) -> None:
        """Return a group grant (:meth:`acquire_group`'s claim list): all
        claimed quanta free at once, then one pump re-grants."""
        with self._mu:
            now = self._clock()
            self._last_event = now
            for lane in lanes:
                self._inflight.discard(lane)
                if lane in self._active:
                    self._ready_since.setdefault(lane, now)
            if self._tracer.enabled and self._pool_size:
                self._tracer.counter(
                    "pool_busy", len(self._inflight), cat="pool",
                    series="busy",
                )
            self._pump_locked()

    def release(self, lane: str) -> None:
        """Return ``lane``'s grant (its engine step finished, fairness
        already charged): the freed quantum is re-granted immediately,
        directly to a parked executor when one is due."""
        with self._mu:
            self._inflight.discard(lane)
            if self._tracer.enabled and self._pool_size:
                self._tracer.counter(
                    "pool_busy", len(self._inflight), cat="pool",
                    series="busy",
                )
            now = self._clock()
            self._last_event = now
            if lane in self._active:
                self._ready_since.setdefault(lane, now)
            self._pump_locked()

    def notify_ready(self, lane: str, active: bool = True) -> None:
        """Dispatcher lane-event delta: fold ``lane``'s new activity into
        the mirror and re-run the grant pump.

        ``active=True`` (a submit appended work, or a step left work
        behind) admits the lane to the mirror and stamps its
        grantable-since clock; ``active=False`` (the lane drained or was
        unregistered) evicts the lane from the mirror, its ready stamp
        (the event-driven eviction that replaces the old per-pump sweep),
        any banked grant, and — per-engine — its parked stepper.  Runs
        under the dispatcher's ready-set lock, so deltas apply in truth
        order; cost is O(active), never O(tenants)."""
        with self._mu:
            if self._closed:
                return
            now = self._clock()
            self._last_event = now
            if active:
                self._active.add(lane)
                if lane not in self._inflight:
                    self._ready_since.setdefault(lane, now)
            else:
                self._active.discard(lane)
                self._ready_since.pop(lane, None)
                if lane in self._granted_q:
                    self._granted_q = deque(
                        n for n in self._granted_q if n != lane
                    )
                slot = self._waiting.pop(lane, None)
                if slot is not None:
                    slot.evicted = True
                    slot.cv.notify()
                    self.notify_wakeups += 1
            self._pump_locked()

    def close(self) -> None:
        """Wake and refuse every current and future acquire."""
        with self._mu:
            self._closed = True
            self._granted_q.clear()
            for slot in list(self._waiting.values()):
                slot.evicted = True
                slot.cv.notify()
            self._waiting.clear()
            for slot in list(self._parked.values()):
                slot.cv.notify()
            self._parked.clear()

    def stats(self) -> dict:
        """Grant-path counters for snapshots: grants issued, grants served
        by the fallback tick (vs an event), tick expiries (idle parking
        included), targeted notifies, wakeups-per-grant, in-flight and
        parked executor counts, mirrored ready-set size, banked grants,
        and cumulative selection CPU seconds."""
        with self._mu:
            wakeups = self.notify_wakeups + self.timed_wakeups
            return {
                "grants": self.grants,
                "timed_grants": self.timed_grants,
                "timed_wakeups": self.timed_wakeups,
                "notify_wakeups": self.notify_wakeups,
                "wakeups_per_grant": (
                    wakeups / self.grants if self.grants else 0.0
                ),
                "inflight": len(self._inflight),
                "parked": len(self._parked) + len(self._waiting),
                "ready": len(self._active),
                "queued_grants": len(self._granted_q),
                "pump_cpu_s": self.pump_cpu_s,
                "group_grants": self.group_grants,
                "co_grants": self.co_grants,
            }

    # -- grant machinery (all under _mu) -----------------------------------

    def _capacity_left(self) -> bool:
        return self._max is None or len(self._inflight) < self._max

    def _order_locked(self, names) -> list[str]:
        # registration order from a cached rank map, validated by the
        # dispatcher's O(1) registration epoch — a reused tenant name gets
        # a NEW rank on re-register, and the full-snapshot refresh also
        # drops retired names, so the cache can neither serve stale
        # ordering nor grow with dead tenants.  Sorting the small
        # contender set is O(a log a) in the ACTIVE count, not the
        # registered count.
        epoch = self._disp.registration_epoch()
        rank = self._rank
        if epoch != self._rank_epoch:
            rank = self._rank = self._disp.lane_ranks()
            self._rank_epoch = epoch
        return sorted(names, key=lambda n: rank.get(n, 1 << 30))

    def _contenders_locked(self) -> list[str]:
        # the policy must see the TRUE active set — every lane with work,
        # whether its stepper is waiting here, executing a granted
        # quantum, or mid-bookkeeping.  Feeding it subsets corrupts
        # stateful policies (stride's rejoin-lift would keep erasing a
        # lane's pass progress).  The mirror makes this O(active): no
        # registry walk, no per-lane engine peeks.
        return self._order_locked(
            self._active | self._inflight | set(self._waiting)
        )

    def _grant_locked(self, name: str, now: float, floor: float) -> None:
        # grant latency clocks the ARBITER's reaction: from the latest of
        # the lane becoming ready, its executor becoming free (``floor``:
        # worker-idle / stepper-wait timestamp), and the last
        # grant-enabling event processed — to the grant.  Policy rationing
        # (stride holding for its top pick) and backlog behind busy
        # workers are thereby excluded: both are scheduling decisions, not
        # hand-off delay.
        self._inflight.add(name)
        self.grants += 1
        since = max(self._ready_since.pop(name, now),
                    floor, self._last_event)
        if self._metrics is not None:
            # lane= routes the sample into the per-class grant series too
            self._metrics.on_grant(max(0.0, now - since), lane=name)
            if self._pool_size:
                self._metrics.on_pool_occupancy(
                    len(self._inflight), self._pool_size
                )
        if self._tracer.enabled:
            self._tracer.instant(
                "grant", cat="arbiter", lane=name,
                args={"wait_s": max(0.0, now - since)},
            )
            if self._pool_size:
                self._tracer.counter(
                    "pool_busy", len(self._inflight), cat="pool",
                    series="busy",
                )

    def _pop_banked_locked(self) -> Optional[str]:
        while self._granted_q:
            name = self._granted_q.popleft()
            if name in self._active and name not in self._inflight:
                return name
        return None

    def _pick_locked(self, floor: float) -> Optional[str]:
        """One pool grant for the calling worker: pop a banked grant, or
        run one policy selection (banking the surplus picks)."""
        if self._closed or not self._capacity_left():
            return None
        t0 = time.perf_counter()
        name = self._pop_banked_locked()
        if name is None:
            ready = self._ready_pool_locked()
            if not ready:
                self.pump_cpu_s += time.perf_counter() - t0
                return None
            picks = [
                n for n in self._disp.fairness_peek(
                    self._contenders_locked(), ready
                )
                if n not in self._inflight
            ]
            if not picks:
                self.pump_cpu_s += time.perf_counter() - t0
                return None
            name = picks[0]
            self._granted_q = deque(picks[1:])
        self._grant_locked(name, self._clock(), floor)
        dt = time.perf_counter() - t0
        self.pump_cpu_s += dt
        if self._metrics is not None:
            self._metrics.on_grant_cost(dt)
            self._metrics.on_ready_size(len(self._active))
        return name

    def _ready_pool_locked(self) -> list[str]:
        ready = [n for n in self._active if n not in self._inflight]
        if not ready:
            return []
        now = self._clock()
        for n in ready:
            self._ready_since.setdefault(n, now)
        return self._order_locked(ready)

    def _pump_locked(self) -> None:
        """Hand out as many grants as policy + capacity allow, each to
        exactly one executor (single targeted notify per grant)."""
        if self._closed:
            return
        t0 = time.perf_counter()
        if self._pool_size:
            granted = self._pump_pool_locked()
        else:
            granted = self._pump_engines_locked()
        dt = time.perf_counter() - t0
        self.pump_cpu_s += dt
        if granted and self._metrics is not None:
            self._metrics.on_grant_cost(dt / granted)
            self._metrics.on_ready_size(len(self._active))
        self._promote_ticker_locked()

    def _pump_pool_locked(self) -> int:
        # one selection feeds every parked worker; surplus picks are
        # banked (policy order preserved) so arriving workers pop in O(1)
        self._granted_q.clear()
        if not self._capacity_left():
            return 0
        ready = self._ready_pool_locked()
        if not ready:
            return 0
        now = self._clock()
        granted = 0
        for name in self._disp.fairness_peek(self._contenders_locked(), ready):
            if name in self._inflight:
                continue
            if not self._capacity_left():
                break
            if self._parked:
                # LIFO hand-off: the most-recently-parked worker gets the
                # lane, so the FIFO head — the designated ticker — keeps
                # its timed wait and no promotion notify is needed unless
                # the ticker itself is the last worker standing
                slot = next(reversed(self._parked.values()))
                del self._parked[id(slot)]
                self._grant_locked(name, now, slot.since)
                slot.lane = name
                slot.cv.notify()
                self.notify_wakeups += 1
                granted += 1
            else:
                self._granted_q.append(name)
        return granted

    def _pump_engines_locked(self) -> int:
        granted = 0
        while self._waiting and self._capacity_left():
            ready = self._order_locked(
                [n for n in self._waiting if n not in self._inflight]
            )
            if not ready:
                break
            now = self._clock()
            progress = 0
            for name in self._disp.fairness_peek(
                self._contenders_locked(), ready
            ):
                slot = self._waiting.get(name)
                if (
                    slot is None
                    or name in self._inflight
                    or not self._capacity_left()
                ):
                    continue
                del self._waiting[name]
                self._grant_locked(name, now, slot.since)
                slot.lane = name
                slot.cv.notify()
                self.notify_wakeups += 1
                progress += 1
            granted += progress
            if not progress:
                # the policy's picks are all executing or mid-bookkeeping:
                # hold the quantum for them (handing it to a less-deserving
                # waiter would break the policy's ordering); release/
                # notify_ready events — or the fallback tick — re-pump
                break
        return granted

    def _ticker_locked(self) -> Optional[_ParkSlot]:
        # the ONE executor that waits with a timeout (quota fallback);
        # everyone else sleeps untimed.  Head of the parked/waiting FIFO.
        if self._parked:
            return next(iter(self._parked.values()))
        if self._waiting:
            return next(iter(self._waiting.values()))
        return None

    def _promote_ticker_locked(self) -> None:
        # when the head changes, the new head may be in an untimed wait:
        # wake it once so it re-parks as the ticker.  This is the only
        # wakeup a grant causes beyond its own hand-off notify — hence
        # wakeups-per-grant ≤ 2.
        head = self._ticker_locked()
        if head is not None and not head.timed_wait and head.lane is None:
            head.cv.notify()
            self.notify_wakeups += 1


class AsyncDispatcher:
    """Threaded serving front door wrapping a (thread-safe) ``Dispatcher``.

    Composition, not inheritance: the synchronous dispatcher keeps owning
    lanes/fairness/backpressure; this class owns only the stepper threads,
    the futures, and the lifecycle.  Either construct it over an existing
    ``Dispatcher`` or pass the same keyword arguments through.

    Thread-safety: every public method is safe from any thread.  Futures
    resolve on the stepper thread that finished the request, before the
    user's ``on_complete`` callback runs; callbacks execute outside all
    dispatcher locks.

    ``device`` (``"cuda"``, the default, or ``"cpu"``) is the device of the
    worker plane that ``stepping="workers", devices=N`` builds; in the
    in-process modes every engine carries its own device, and each step runs
    with that device current on the stepping thread.
    """

    def __init__(
        self,
        dispatcher: Optional[Dispatcher] = None,
        *,
        max_pending: int = 256,
        metrics: Optional[DispatchMetrics] = None,
        fairness: FairnessSpec = None,
        idle_wait: float = 0.02,
        stepping: str = "per-engine",
        max_concurrent_steps: Optional[int] = None,
        pool_size: Optional[int] = None,
        tracer: Optional[Any] = None,
        composer: Optional[Any] = None,
        devices: Optional[int] = None,
        device: str = "cuda",
        worker_plane: Optional[Any] = None,
        journal: Optional[Any] = None,
        faults: Optional[Any] = None,
    ) -> None:
        if stepping not in ("per-engine", "single", "pool", "workers"):
            raise ValueError(
                f'stepping must be "per-engine", "single", "pool", or '
                f'"workers", got {stepping!r}'
            )
        if pool_size is not None and pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        if stepping != "workers" and (
            devices is not None or worker_plane is not None
        ):
            raise ValueError(
                'devices/worker_plane are only meaningful with '
                f'stepping="workers", got stepping={stepping!r}'
            )
        if devices is not None and devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if dispatcher is None:
            dispatcher = Dispatcher(
                max_pending=max_pending, metrics=metrics, fairness=fairness,
                tracer=tracer, composer=composer, journal=journal,
                faults=faults,
            )
        else:
            if tracer is not None:
                dispatcher.tracer = tracer
            if composer is not None:
                dispatcher.composer = composer
            if journal is not None:
                # late attachment onto a caller-built dispatcher: the
                # journal (and injector) reach the same lifecycle tracker
                # the dispatcher already threads through its transitions
                dispatcher.journal = journal
                dispatcher.lifecycle.journal = journal
            if faults is not None:
                dispatcher.faults = faults
                dispatcher.lifecycle.faults = faults
        self.dispatcher = dispatcher
        self.idle_wait = idle_wait
        self.stepping = stepping
        self.max_concurrent_steps = max_concurrent_steps
        # stepping="workers": per-device worker processes behind the same
        # pool stepper loop — the parent keeps ready set / fairness / SLO /
        # futures, the plane owns engines + caches in child processes.
        # Constructed unstarted; start() spawns the fleet.
        self.plane: Optional[Any] = None
        if stepping == "workers":
            if self.dispatcher.composer is not None:
                raise ValueError(
                    'stepping="workers" does not support a batch composer: '
                    "a composed batch cannot span worker processes"
                )
            if worker_plane is not None:
                self.plane = worker_plane
            else:
                from .workers import WorkerPlane

                # spawn, not fork: a forked child cannot use a CUDA
                # context its parent initialised.  Callers wanting fork
                # (cheap, fake engines) pass their own worker_plane.
                self.plane = WorkerPlane(
                    devices if devices is not None else 1,
                    device=device,
                    start_method="spawn",
                    tracer=self.dispatcher.tracer,
                    faults=faults,
                )
        # thread budget for stepping="pool": tenants share these workers, so
        # the stepper thread count stays flat no matter how many models
        # register (the many-tenant scaling the per-engine mode lacks)
        self.pool_size = (
            pool_size if pool_size is not None
            else min(8, os.cpu_count() or 1)
        )
        # plain (non-reentrant) lock: nothing under _cv re-enters it, and
        # the submitter/worker hot paths cross it several times per
        # quantum — an RLock's ownership bookkeeping is measurable there
        self._cv = threading.Condition(threading.Lock())
        self._threads: dict[str, threading.Thread] = {}
        self._arbiter: Optional[_QuantumArbiter] = None
        self._running_flag = False
        self._stop_flag = False
        self._busy: set[str] = set()      # loop-published; r/w under _cv
        self._error: Optional[BaseException] = None
        self._pending: set[Future] = set()
        # stepper build attribution: the cache tags builds with the
        # builder's thread ident (unique among live threads), so counting
        # needs no racy before/after deltas.  Counts from dead steppers are
        # frozen at exit (idents can be recycled once dead).
        self._live: dict[str, tuple[int, int]] = {}   # label -> (ident, base)
        self._frozen: dict[str, int] = {}             # label -> frozen count

    # -- passthroughs ------------------------------------------------------

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
        """Register a tenant; if the dispatcher is live in per-engine mode,
        its stepper thread spawns immediately.  Pool mode needs no spawn:
        the fixed workers multiplex every registered lane, so a hundredth
        tenant costs a dict entry, not a thread.  ``priority_class`` and
        ``latency_target_ms`` flow to the SLO plane exactly as on
        :meth:`Dispatcher.register_model` — grants consult class ordering
        before fairness, and unmeetable deadlines fail the submit future
        with :class:`~repro_torch.dispatch.slo.AdmissionRejected`.

        In workers mode ``engine`` must be a picklable
        :class:`~repro_torch.serving.spec.EngineSpec` — the plane assigns the
        lane to a worker process (round-robin over devices), the worker
        builds the real engine in-child, and the lane proxy registered
        here is what the parent's steppers drive (a setup failure
        surfaces on this thread as a typed
        :class:`~repro_torch.dispatch.workers.WorkerError`).  The spec doubles
        as the lane's journal recipe, so in workers mode a journaled
        dispatcher is recoverable with no extra arguments; other modes
        pass ``spec=`` explicitly to make a lane journal-recoverable."""
        if self.stepping == "workers":
            if hasattr(engine, "submit") or not hasattr(engine, "build"):
                raise ValueError(
                    'stepping="workers" registers EngineSpec recipes, not '
                    "live engines (device state cannot cross a process "
                    f"boundary); got {type(engine).__name__}"
                )
            if spec is None:
                spec = engine
            engine = self.plane.assign(name, engine)
        try:
            out = self.dispatcher.register_model(
                name,
                engine,
                weight=weight,
                priority_class=priority_class,
                latency_target_ms=latency_target_ms,
                spec=spec,
            )
        except BaseException:
            # a rejected registration (duplicate name, ...) must not leave
            # the lane assigned worker-side
            if self.stepping == "workers":
                self.plane.release(name)
            raise
        with self._cv:
            if (
                self.stepping == "per-engine"
                and self._running_flag
                and not self._stop_flag
                and self._error is None
                and name not in self._threads
            ):
                self._spawn_locked(name, self._run_lane)
        return out

    def recover(
        self, journal: Any, *, engines: Optional[dict] = None
    ) -> dict:
        """Rebuild lanes and requeue non-terminal requests from
        ``journal`` (see :meth:`Dispatcher.recover` for the full
        semantics and report shape).

        Mode-aware lane recovery: in workers mode the journaled
        :class:`~repro_torch.serving.spec.EngineSpec` recipes go straight back
        to the worker plane (engines rebuild in child processes, exactly
        like a live registration); in the in-process modes a journaled
        spec is built here on device 0.  ``engines`` overrides the recipe
        per lane.  Callable before or after :meth:`start` — requeued work
        is granted as soon as steppers run.

        On top of the base report, ``report["futures"]`` maps each
        requeued rid to a :class:`~concurrent.futures.Future` resolving
        with the finished request — the same contract :meth:`submit`
        gives new work, so a restarted server can re-await everything the
        crash orphaned."""
        from concurrent.futures import Future  # local: only used here

        from repro_torch.serving.spec import EngineSpec  # lazy: avoid cycle

        def _reg(name: str, engine_or_spec: Any, **kw: Any) -> Any:
            eng = engine_or_spec
            if self.stepping != "workers" and isinstance(eng, EngineSpec):
                eng = eng.build(0)
            return self.register_model(name, eng, **kw)

        futures: dict = {}

        def _attach(req: Any) -> None:
            # runs BEFORE the request re-enters its lane queue, so the
            # future cannot miss a completion; bypasses _new_future's
            # running check — recovery is legal before start()
            fut: Future = Future()
            with self._cv:
                self._pending.add(fut)
            req.on_complete = self._completion(fut, None)
            futures[req.rid] = fut

        report = self.dispatcher.recover(
            journal, engines=engines, register=_reg, on_requeue=_attach
        )
        report["futures"] = futures
        # wake the grant plane: requeued lanes are ready the moment the
        # loop runs
        for name in report.get("lanes", ()):
            self._kick(name)
        return report

    def retire_model(self, name: str) -> Future:
        """Mark tenant ``name`` retired; returns a future resolving to the
        retired engine once the steppers drain the lane (non-blocking —
        the calling thread never steps).  Whichever stepper completes the
        lane's last request finalizes the removal; the future then clears
        the async-side residue (the lane's ``_busy`` entry and, in
        per-engine mode, its stepper's registry slot — the thread exits on
        its own once the lane vanishes)."""
        fut = self.dispatcher.retire_model(name)

        def _cleanup(_f: Future) -> None:
            with self._cv:
                self._busy.discard(name)
                if self.stepping == "per-engine":
                    self._threads.pop(name, None)
                self._cv.notify_all()

        fut.add_done_callback(_cleanup)
        return fut

    def unregister_model(self, name: str, *, timeout: float = 60.0) -> Any:
        """Drain and retire tenant ``name``; returns the retired engine.

        While the steppers are live the calling thread only WAITS — the
        lane is marked retired (:meth:`Dispatcher.retire_model`) and the
        steppers drain it, the completing one finalizing the removal; the
        old behavior of draining on the calling thread concurrently with
        the steppers is gone.  With no steppers running the caller drains
        the lane itself via :meth:`Dispatcher.unregister_model`.  Either
        way the async-side residue is then retired: the lane's ``_busy``
        entry, and — in per-engine mode — its stepper thread, which exits
        on its own and is joined here.  ``DrainTimeoutError`` semantics
        arrive via the future: a lane the steppers cannot drain within
        ``timeout`` raises it, leaving the lane retired but registered.
        """
        if self.running and self._error is None:
            fut = self.dispatcher.retire_model(name)
            try:
                engine = fut.result(timeout=timeout)
            except FutureTimeoutError:
                raise DrainTimeoutError(
                    f"unregister timed out after {timeout:g}s waiting for "
                    f"steppers to drain {name!r}"
                ) from None
        else:
            engine = self.dispatcher.unregister_model(name)
        stepper = None
        with self._cv:
            self._busy.discard(name)
            if self.stepping == "per-engine":
                stepper = self._threads.pop(name, None)
            self._cv.notify_all()      # wake the stepper / drain waiters
        if stepper is not None:
            stepper.join(timeout=10.0)
            if stepper.is_alive():     # pragma: no cover - diagnostics
                raise DrainTimeoutError(
                    f"stepper for {name!r} failed to exit after unregister"
                )
        return engine

    @property
    def models(self) -> tuple[str, ...]:
        """Registered model names, in registration order."""
        return self.dispatcher.models

    def engine(self, name: str) -> Any:
        """The engine serving ``name``."""
        return self.dispatcher.engine(name)

    def pending(self) -> int:
        """Dispatcher-side pending count (queued + in-flight requests)."""
        return self.dispatcher.pending()

    @property
    def metrics(self) -> DispatchMetrics:
        """The wrapped dispatcher's metrics aggregate."""
        return self.dispatcher.metrics

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        """Whether the stepping loop is live (accepting submissions)."""
        if not self._running_flag:
            return False
        if not self._threads:      # per-engine mode with no models yet
            return True
        return any(t.is_alive() for t in self._threads.values())

    def _spawn_locked(self, label: str, target: Callable[[str], None]) -> None:
        t = threading.Thread(
            target=self._run_guarded, args=(label, target),
            name=f"repro-dispatch-step[{label}]", daemon=True,
        )
        self._threads[label] = t
        t.start()

    def start(self) -> "AsyncDispatcher":
        """Spawn the daemon stepper thread(s) (idempotent while running).

        Per-engine mode spawns one stepper per registered model (models
        registered later get theirs on registration); pool mode spawns
        exactly ``pool_size`` workers that multiplex every lane; single
        mode spawns the one legacy loop thread.  Arbitrated modes also
        install the dispatcher's lane-event hook so readiness events reach
        the arbiter (the event-driven hand-off).
        """
        with self._cv:
            # check-and-spawn is one critical section: two concurrent
            # start() calls must not each observe "not running" and spawn
            # rival stepper sets.  The model list is read INSIDE it too: a
            # register_model racing start() either sees _running_flag set
            # (and spawns the stepper itself) or is seen by this read —
            # read it outside and a lane could end up stepper-less forever.
            names = self.dispatcher.models
            if self._error is not None:
                raise RuntimeError(
                    "dispatcher previously failed; construct a new one"
                ) from self._error
            if self._running_flag and (
                not self._threads
                or any(t.is_alive() for t in self._threads.values())
            ):
                return self
            self._stop_flag = False
            self._running_flag = True
            self._threads = {}
            if self.stepping == "per-engine":
                self._arbiter = _QuantumArbiter(
                    self.dispatcher, self.max_concurrent_steps,
                    metrics=self.metrics, tracer=self.dispatcher.tracer,
                )
                self.dispatcher.set_lane_event_hook(self._arbiter.notify_ready)
                for name in names:
                    self._spawn_locked(name, self._run_lane)
            elif self.stepping == "pool":
                self._arbiter = _QuantumArbiter(
                    self.dispatcher, self.max_concurrent_steps,
                    metrics=self.metrics, pool_size=self.pool_size,
                    tracer=self.dispatcher.tracer,
                )
                self.dispatcher.set_lane_event_hook(self._arbiter.notify_ready)
                for i in range(self.pool_size):
                    self._spawn_locked(f"pool-{i}", self._run_pool)
            elif self.stepping == "workers":
                # spawns the fleet (raises if the plane was shut down by a
                # previous stop(): worker processes do not restart — build
                # a new AsyncDispatcher).  Parent-side stepping reuses the
                # pool loop: one thread per worker drives granted lanes
                # through blocking step RPCs, so N workers overlap N steps.
                self.plane.start()
                self._arbiter = _QuantumArbiter(
                    self.dispatcher, self.max_concurrent_steps,
                    metrics=self.metrics, pool_size=self.plane.n_workers,
                    tracer=self.dispatcher.tracer,
                )
                self.dispatcher.set_lane_event_hook(self._arbiter.notify_ready)
                for i in range(self.plane.n_workers):
                    self._spawn_locked(f"workers-{i}", self._run_pool)
            else:
                self._spawn_locked(_SINGLE, self._run_single)
        return self

    def stop(self, *, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop every stepper; by default drain all work first.

        The threads are stopped even when the drain raises (a wedged engine
        must not leave steppers running behind a DrainTimeoutError).  Any
        futures still unresolved after the threads exit — ``drain=False``
        leftovers, or stragglers that raced the stop — are cancelled, never
        silently stranded.  ``timeout`` bounds both the drain and the join.
        """
        if not self._threads and not self._running_flag:
            return
        alive = False
        try:
            if drain and self._error is None and self.running:
                self.drain(timeout=timeout)
        finally:
            with self._cv:
                self._stop_flag = True
                self._running_flag = False
                self._cv.notify_all()
            if self._arbiter is not None:
                self._arbiter.close()
            # ONE deadline shared by every join: `timeout` bounds the whole
            # stop, not stop-per-stepper (8 wedged tenants must not turn a
            # 5s timeout into 40s)
            deadline = _now() + (10.0 if timeout is None else max(timeout, 0.1))
            for t in self._threads.values():
                t.join(max(0.0, deadline - _now()))
                alive = alive or t.is_alive()
            self.dispatcher.set_lane_event_hook(None)
            if not alive:
                self._threads = {}
                self._arbiter = None
            if self.plane is not None:
                # after the stepper joins: no step RPC is in flight, so
                # shutdown's final trace collection sees quiet pipes.
                # Worker processes are not restartable — a later start()
                # raises through plane.start()'s closed check.
                self.plane.shutdown(
                    timeout=10.0 if timeout is None else max(timeout, 0.1)
                )
            with self._cv:
                leftovers, self._pending = self._pending, set()
            for fut in leftovers:
                fut.cancel()
        if alive:                              # pragma: no cover - diagnostics
            raise DrainTimeoutError("stepper threads failed to stop")

    def __enter__(self) -> "AsyncDispatcher":
        """``with`` support: enters by starting the steppers."""
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        """Exits by stopping; drains only on a clean exit."""
        self.stop(drain=exc_type is None)

    # -- submission --------------------------------------------------------

    def submit(
        self,
        model: str,
        prompt: Any,
        *,
        max_new_tokens: int = 16,
        tenant: str = "",
        on_complete: Optional[Callable[[str, Any], None]] = None,
    ) -> Future:
        """Enqueue a request; returns a ``Future`` resolving to the finished
        ``Request`` (tokens in ``.generated``).

        Raises ``QueueFullError`` synchronously at capacity (backpressure
        belongs on the submitter, not inside the future), and raises
        ``RuntimeError`` when the loop is dead or was never started — new
        traffic is never silently queued behind a loop that will not serve
        it.  SLO admission control
        (:class:`~repro_torch.dispatch.slo.AdmissionRejected`: the lane's
        deadline is provably unmeetable) FAILS THE FUTURE instead — the
        refusal is per-request scheduling state callers poll like any
        other completion, and the stepping threads never see it.
        """
        fut = self._new_future()
        try:
            self.dispatcher.submit(
                model,
                prompt,
                max_new_tokens=max_new_tokens,
                tenant=tenant,
                on_complete=self._completion(fut, on_complete),
            )
        except AdmissionRejected as exc:
            self._forget(fut)
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)
            return fut
        except BaseException:
            self._forget(fut)
            raise
        self._kick(model)
        return fut

    def submit_request(self, model: str, req: Any) -> Future:
        """Enqueue a caller-constructed ``Request``; returns its ``Future``.

        Chains (does not replace) any ``on_complete`` already on the
        request.  As with :meth:`submit`, SLO admission refusals fail the
        returned future rather than raising.
        """
        fut = self._new_future()
        original_cb = getattr(req, "on_complete", None)
        req.on_complete = self._completion(fut, original_cb)
        try:
            self.dispatcher.submit_request(model, req)
        except AdmissionRejected as exc:
            req.on_complete = original_cb
            self._forget(fut)
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)
            return fut
        except BaseException:
            # a rejected request must come back unchanged, or a retry would
            # chain the dead future's wrapper under its own
            req.on_complete = original_cb
            self._forget(fut)
            raise
        self._kick(model)
        return fut

    # -- introspection -----------------------------------------------------

    def _count_builds_of(self, ident: Optional[int], baseline: int) -> int:
        if ident is None:
            return 0
        raw = sum(
            c.stats.builds_by_thread.get(ident, 0) for c in self._caches()
        )
        return max(0, raw - baseline)

    @property
    def builds_on_thread(self) -> int:
        """Schedule-cache builds performed BY any stepper thread (should
        stay 0 when engines are warmed — the paper's pure-submission
        invariant).  Attribution is by builder thread ident, so concurrent
        foreground compiles (late registrations, Nimble.prepare on a shared
        cache) are never miscounted against a stepper."""
        return sum(self.builds_by_stepper.values())

    @property
    def builds_by_stepper(self) -> dict:
        """Per-stepper build counts (label → builds): the per-engine view
        of the invariant — every value should be 0.  Labels are model
        names in per-engine mode, ``"loop"`` in single mode."""
        # snapshot frozen+live atomically, count outside _cv (counting
        # walks the dispatcher, which must never happen while holding _cv)
        with self._cv:
            frozen = dict(self._frozen)
            live = dict(self._live)
        out = dict(frozen)
        for label, (ident, baseline) in live.items():
            out[label] = out.get(label, 0) + self._count_builds_of(ident, baseline)
        return out

    def snapshot(self) -> dict:
        """Dispatcher snapshot plus the async layer's lifecycle state."""
        snap = self.dispatcher.snapshot()
        by_stepper = self.builds_by_stepper
        arbiter = self._arbiter
        arb_stats = arbiter.stats() if arbiter is not None else None
        plane_snap = self.plane.snapshot() if self.plane is not None else None
        with self._cv:
            snap["async"] = {
                "running": self.running,
                "stepping": self.stepping,
                "steppers": len(self._threads),
                "max_concurrent_steps": self.max_concurrent_steps,
                "pool_size": (
                    self.pool_size if self.stepping == "pool" else None
                ),
                "futures_pending": len(self._pending),
                "builds_on_thread": sum(by_stepper.values()),
                "builds_by_stepper": by_stepper,
                "arbiter": arb_stats,
                "workers": plane_snap,
                "failed": self._error is not None,
            }
        return snap

    # -- draining ----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted future has resolved.

        Raises :class:`DrainTimeoutError` on timeout and re-raises a
        stepper thread's exception if one died.
        """
        if not self.running:
            self._ensure_alive()
            if self.dispatcher.idle and not self._pending:
                return
            raise RuntimeError("cannot drain: dispatcher is not running")
        deadline = None if timeout is None else (_now() + timeout)
        # never touch the dispatcher (its locks) while holding _cv: the
        # steppers publish into _cv-guarded state instead
        with self._cv:
            while True:
                if self._error is not None:
                    raise RuntimeError(
                        "stepping thread failed"
                    ) from self._error
                if not self._busy and not self._pending:
                    return
                remaining = self.idle_wait if deadline is None else deadline - _now()
                if remaining <= 0:
                    unresolved = len(self._pending)
                    break
                self._cv.wait(min(remaining, self.idle_wait))
        raise DrainTimeoutError(
            f"drain timed out with {unresolved} futures unresolved "
            f"({self.dispatcher.pending()} requests pending)"
        )

    # -- internals ---------------------------------------------------------

    def _new_future(self) -> Future:
        fut: Future = Future()
        with self._cv:
            # the liveness checks and the pending-set insert must share one
            # critical section: checked-then-added across two would let a
            # concurrent _fail() miss this future and leave it unresolvable
            if self._error is not None:
                raise RuntimeError(
                    "stepping thread failed; no new submissions accepted"
                ) from self._error
            if not self.running:
                raise RuntimeError(
                    "dispatcher is not running; call start() before submit"
                )
            self._pending.add(fut)
        return fut

    def _forget(self, fut: Future) -> None:
        with self._cv:
            self._pending.discard(fut)

    def _ensure_alive(self) -> None:
        with self._cv:
            if self._error is not None:
                raise RuntimeError(
                    "stepping thread failed; no new submissions accepted"
                ) from self._error

    def _completion(
        self, fut: Future, user_cb: Optional[Callable[[str, Any], None]]
    ) -> Callable[[str, Any], None]:
        # runs on a stepper thread, outside all dispatcher locks; taking
        # _cv here is therefore nesting-free.  The future resolves BEFORE
        # the user callback runs: a raising callback poisons the dispatcher
        # (loudly, via _fail) but must never leave an already-completed
        # request's future unresolvable.
        def done(model: str, req: Any) -> None:
            self._forget(fut)
            if fut.set_running_or_notify_cancel():
                # a load-shed request completes with a typed admission
                # error attached: its future FAILS with that error, so
                # backpressure surfaces exactly where submit's does.  A
                # worker-plane casualty (crash/timeout/setup failure on
                # the lane's device) arrives the same way — typed error on
                # the request, scoped to the affected lanes, never _fail()
                fail_exc = (
                    getattr(req, "_admission_error", None)
                    or getattr(req, "_failure_exc", None)
                )
                if fail_exc is not None:
                    fut.set_exception(fail_exc)
                else:
                    fut.set_result(req)
            if user_cb is not None:
                user_cb(model, req)

        return done

    def _kick(self, model: str) -> None:
        with self._cv:
            # mark the submitted lane busy so drain cannot observe "all
            # idle" between this append and a stepper noticing the work
            # (per-engine and pool track per lane; single tracks the loop).
            # The mark is CONDITIONAL on the lane still having work, under
            # _cv: a pool worker may have been handed the request by the
            # dispatcher's lane-event hook and fully served it before this
            # kick runs — an unconditional add would then strand a stale
            # busy entry no pool worker ever revisits (pool workers, unlike
            # per-engine steppers, do not poll idle lanes), wedging drain.
            if self.stepping == "single":
                if not self.dispatcher.idle:
                    self._busy.add(_SINGLE)
            elif self.dispatcher.lane_active(model):
                self._busy.add(model)
            if self.stepping != "pool":
                # single/per-engine: wake the idle-parked stepper.  Pool
                # workers are woken by the dispatcher's ready-delta hook
                # through the arbiter — notifying _cv here would only add
                # submitter-side contention for nobody.
                self._cv.notify_all()

    def _caches(self) -> list:
        # only queried off the hot loop (builds_on_thread / snapshot), so a
        # fresh walk per call is fine and always sees late registrations
        seen: dict[int, Any] = {}
        for name in self.dispatcher.models:
            cache = getattr(self.dispatcher.engine(name), "schedule_cache", None)
            if cache is not None:
                seen.setdefault(id(cache), cache)
        return list(seen.values())

    def _run_guarded(self, label: str, body: Callable[[str], None]) -> None:
        """Stepper entry: build attribution bracketing around ``body``."""
        ident = threading.get_ident()
        # the OS recycles idents of dead threads: any counts already tagged
        # with ours belong to a previous occupant, not this stepper
        baseline = sum(
            c.stats.builds_by_thread.get(ident, 0) for c in self._caches()
        )
        with self._cv:
            self._live[label] = (ident, baseline)
        try:
            body(label)
        finally:
            # freeze this stepper's build count: once the thread is dead
            # its ident may be recycled by an unrelated foreground thread.
            # The count happens before taking _cv (lock ordering), and the
            # swap is atomic under _cv so builds_by_stepper readers never
            # see the live count both frozen and still live
            live = self._count_builds_of(ident, baseline)
            with self._cv:
                self._frozen[label] = self._frozen.get(label, 0) + live
                self._live.pop(label, None)

    def _should_exit(self) -> bool:
        with self._cv:
            return self._stop_flag or self._error is not None

    def _co_claim(self, arbiter: _QuantumArbiter, lane: str) -> list:
        # widen a held grant to the lane's compose group (no-op for
        # uncomposed lanes): the returned claim list rides the release=
        # callback so all quanta free together after the shared step
        comp = self.dispatcher.composer
        if comp is None:
            return [lane]
        members = comp.members(lane)
        if len(members) <= 1:
            return [lane]
        return arbiter.acquire_group(lane, members)

    @staticmethod
    def _release_claimed(arbiter: _QuantumArbiter, claimed: list) -> None:
        if len(claimed) > 1:
            arbiter.release_group(claimed)
        else:
            arbiter.release(claimed[0])

    def _run_lane(self, name: str) -> None:
        """Per-engine stepper: pull quanta for one lane through the
        arbiter; never touches any other lane's engine.  Exits on shutdown
        or once its lane is unregistered."""
        arbiter = self._arbiter
        while True:
            if self._should_exit():
                return
            if not self.dispatcher.has_model(name):
                # lane unregistered: retire, clearing any busy mark this
                # loop added after unregister's own discard (a stale entry
                # would wedge drain forever)
                with self._cv:
                    self._busy.discard(name)
                    self._cv.notify_all()
                return
            if not self.dispatcher.lane_active(name):
                with self._cv:
                    if self._stop_flag or self._error is not None:
                        return
                    # re-check activity UNDER _cv: a submit appends to the
                    # lane before its kick takes _cv, so either we see the
                    # work here, or the kick's notify is still to come and
                    # lands in the wait below — no lost wakeup either way
                    if not self.dispatcher.lane_active(name):
                        self._busy.discard(name)
                        self._cv.notify_all()  # drain may be waiting on us
                        self._cv.wait(self.idle_wait)
                continue
            with self._cv:
                self._busy.add(name)
            if not arbiter.acquire(name):
                continue                        # closed: re-check exit flags
            # composed lane: widen the grant to the whole group so this
            # stepper drives ONE shared step for every co-member
            claimed = self._co_claim(arbiter, name)
            try:
                # the grant is returned via release= BEFORE completion
                # callbacks run, so a slow user callback never holds a
                # scheduling quantum hostage; releasing twice on the error
                # path is a harmless set-discard
                self.dispatcher.step_lane(
                    name,
                    release=lambda: self._release_claimed(arbiter, claimed),
                )
            except BaseException as exc:  # noqa: BLE001 - fail all futures
                self._release_claimed(arbiter, claimed)
                self._fail(exc)
                return
            with self._cv:
                self._cv.notify_all()

    def _run_pool(self, label: str) -> None:
        """Pool worker: pull the policy's next ready lane from the arbiter
        and step it — any worker serves any lane, so the thread count
        stays at ``pool_size`` no matter how many tenants register.

        Blocking happens inside ``acquire_any`` (woken by readiness events
        and the fallback tick), so an idle pool costs no polling loop; the
        busy-lane set is published for ``drain`` exactly as per-engine
        steppers do, with the same under-``_cv`` re-check that closes the
        lost-wakeup window against a racing submit."""
        arbiter = self._arbiter
        while True:
            if self._should_exit():
                return
            lane = arbiter.acquire_any()
            if lane is None:
                continue                    # closed: re-check exit flags
            # composed lane: claim the co-members too — one worker, one
            # shared step, no second worker granted a co-member mid-step
            claimed = self._co_claim(arbiter, lane)
            with self._cv:
                self._busy.update(claimed)
            try:
                # grant returned before completion callbacks (release=), so
                # a slow user callback never holds a scheduling quantum
                self.dispatcher.step_lane(
                    lane,
                    release=lambda: self._release_claimed(arbiter, claimed),
                )
            except BaseException as exc:  # noqa: BLE001 - fail all futures
                self._release_claimed(arbiter, claimed)
                self._fail(exc)
                return
            with self._cv:
                # only clear busy if the lane is REALLY idle under _cv: a
                # submit appends before its kick takes _cv, so either we
                # see the work here or the kick re-adds busy after us.
                # Notify only on that drain transition: it is the signal
                # drain/stop wait for, and every other quantum boundary
                # has nothing to tell them (drain also re-polls on
                # idle_wait, so a skipped notify costs at most one poll)
                drained = False
                for member in claimed:
                    if not self.dispatcher.lane_active(member):
                        self._busy.discard(member)
                        drained = True
                if drained:
                    self._cv.notify_all()

    def _run_single(self, label: str) -> None:
        """Legacy single-thread loop: steps all lanes in policy order."""
        while True:
            if self._should_exit():
                return
            if self.dispatcher.idle:
                with self._cv:
                    if self._stop_flag or self._error is not None:
                        return
                    # same lost-wakeup discipline as _run_lane: only go
                    # idle if the dispatcher is still idle under _cv
                    if self.dispatcher.idle:
                        self._busy.discard(label)
                        self._cv.notify_all()
                        self._cv.wait(self.idle_wait)
                continue
            with self._cv:
                self._busy.add(label)
            try:
                self.dispatcher.step()
            except BaseException as exc:  # noqa: BLE001 - fail all futures
                self._fail(exc)
                return
            with self._cv:
                self._cv.notify_all()

    def _fail(self, exc: BaseException) -> None:
        tracer = self.dispatcher.tracer
        if tracer.enabled:
            # in-flight requests' async tracks stay open in the trace: the
            # failure killed them mid-lifecycle, and the export shows it
            tracer.instant(
                "failed", cat="dispatch", args={"error": repr(exc)}
            )
        with self._cv:
            self._error = exc
            victims, self._pending = self._pending, set()
            self._cv.notify_all()
        if self._arbiter is not None:
            self._arbiter.close()      # other steppers must not block forever
        for fut in victims:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)


def _now() -> float:
    return time.monotonic()
