"""SLO-aware control plane: priority classes, admission control, shedding.

Every tenant used to be best-effort: under overload, interactive lanes
queued behind batch lanes and tail latency exploded with nothing watching.
This module is the policy layer that changes that (the separation the
GPU-datacenter scheduling survey calls out as table stakes for production
serving):

* **priority classes** — each lane carries an integer class; *lower is
  more important* (class 0 preempts class 1 at quantum granularity via
  :class:`~repro_torch.dispatch.fairness.ClassedFairness` — the arbiter simply
  does not renew a lower-class lane's grant while a higher class has
  ready work, so preemption never interrupts an in-flight device step);
* **latency targets** — ``register_model(latency_target_ms=...)`` gives a
  lane a per-request deadline (``t_submit + target``).  Completions feed
  the per-class :class:`AdaptiveController` (utilization moving-average,
  spike detection, cooldown) so overload is a tracked state, not a vibe;
* **admission control** — :meth:`SLOPolicy.admit` rejects a request whose
  deadline is *provably unmeetable* (estimated queue wait already exceeds
  the target) with the typed :class:`AdmissionRejected` backpressure
  error, on the submitter — the stepping threads never fail;
* **load shedding** — when the controller reports overload, queued
  requests that can no longer meet their deadlines are shed; the victim
  choice (:meth:`SLOPolicy.pick_shed`) is always the lowest class with
  the latest deadline, so interactive work is the last to go.

The policy object is deliberately lock-free: the owning
:class:`~repro_torch.dispatch.dispatcher.Dispatcher` serializes registration
(registry lock) and feeds observations from whichever thread stepped the
lane — all mutated state is per-key dict writes, safe under CPython for
the tolerances estimation cares about.  ``clock`` is injectable so every
decision in this file is deterministic under a test's fake clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from .errors import DispatchError


class AdmissionRejected(DispatchError):
    """Typed backpressure: a request's deadline is provably unmeetable.

    Raised by :meth:`SLOPolicy.admit` on the submitting thread (sync
    ``Dispatcher.submit``) and carried by the future for
    ``AsyncDispatcher.submit`` — the stepping threads never see it.  The
    ``lane``, ``priority_class``, and ``deadline`` attributes identify
    what was refused so callers can back off per class.
    """

    def __init__(
        self,
        message: str,
        *,
        lane: str = "",
        priority_class: int = 0,
        deadline: float = 0.0,
    ) -> None:
        super().__init__(message)
        self.lane = lane
        self.priority_class = priority_class
        self.deadline = deadline


class AdaptiveController:
    """Per-class overload detector: moving average + spike trip + cooldown.

    The ``scheduler/policy.py`` pattern: each class keeps a bounded window
    of recent latency observations and an exponentially-weighted moving
    average (the *utilization* proxy — how far realized latency sits from
    its target).  A class **trips into overload** only after ``window``
    *consecutive* observations exceed ``spike_factor × target`` — a lone
    slow request is noise, a full window is a spike.  Once tripped, the
    class stays overloaded for at least ``cooldown_s`` (measured on the
    injectable monotonic ``clock``) even if latencies recover — the
    cooldown is what prevents admission/shedding decisions from flapping
    on the boundary.  After the cooldown, the first in-target observation
    clears the state.

    Thread-safety: one internal lock serializes ``observe`` against
    ``overloaded``/``snapshot`` readers (observations arrive from stepper
    threads, decisions from submitters).
    """

    def __init__(
        self,
        *,
        window: int = 8,
        spike_factor: float = 2.0,
        cooldown_s: float = 1.0,
        alpha: float = 0.25,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if spike_factor <= 0 or cooldown_s < 0 or not (0 < alpha <= 1):
            raise ValueError(
                f"bad controller params: spike_factor={spike_factor} "
                f"cooldown_s={cooldown_s} alpha={alpha}"
            )
        self.window = window
        self.spike_factor = spike_factor
        self.cooldown_s = cooldown_s
        self.alpha = alpha
        self._clock = clock
        self._mu = threading.Lock()
        self._recent: dict[int, deque] = {}       # cls -> latency ring
        self._avg: dict[int, float] = {}          # cls -> EWMA latency
        self._breach: dict[int, int] = {}         # cls -> consecutive spikes
        self._overloaded: dict[int, bool] = {}
        self._tripped_at: dict[int, float] = {}
        self.trips = 0                            # total overload entries

    def observe(self, cls: int, latency_s: float, target_s: float) -> None:
        """Fold one completed-request latency for class ``cls`` against its
        ``target_s``: updates the moving average, advances or resets the
        consecutive-spike count, trips overload after a full breached
        window, and clears it once the cooldown has elapsed *and* the
        latest observation is back within the spike threshold."""
        now = self._clock()
        over = latency_s > self.spike_factor * target_s
        with self._mu:
            ring = self._recent.get(cls)
            if ring is None:
                ring = self._recent[cls] = deque(maxlen=self.window)
            ring.append(float(latency_s))
            prev = self._avg.get(cls)
            self._avg[cls] = (
                latency_s if prev is None
                else (1 - self.alpha) * prev + self.alpha * latency_s
            )
            if over:
                self._breach[cls] = self._breach.get(cls, 0) + 1
                if (
                    not self._overloaded.get(cls, False)
                    and self._breach[cls] >= self.window
                ):
                    self._overloaded[cls] = True
                    self._tripped_at[cls] = now
                    self.trips += 1
            else:
                self._breach[cls] = 0
                if (
                    self._overloaded.get(cls, False)
                    and now - self._tripped_at.get(cls, now)
                    >= self.cooldown_s
                ):
                    self._overloaded[cls] = False

    def overloaded(self, cls: int) -> bool:
        """Whether class ``cls`` is currently in the tripped overload
        state (sticky for at least ``cooldown_s`` after the trip)."""
        with self._mu:
            return self._overloaded.get(cls, False)

    def any_overloaded(self) -> bool:
        """Whether *any* class is currently overloaded — the O(classes)
        cheap gate submit paths use before walking queues to shed."""
        with self._mu:
            return any(self._overloaded.values())

    def snapshot(self) -> dict:
        """Controller state per class: EWMA latency, consecutive-breach
        count, overload flag, and total trips."""
        with self._mu:
            return {
                "window": self.window,
                "spike_factor": self.spike_factor,
                "cooldown_s": self.cooldown_s,
                "trips": self.trips,
                "classes": {
                    cls: {
                        "avg_latency_s": self._avg.get(cls, 0.0),
                        "breach_streak": self._breach.get(cls, 0),
                        "overloaded": self._overloaded.get(cls, False),
                    }
                    for cls in sorted(self._recent)
                },
            }


class SLOPolicy:
    """Per-lane SLO registry + admission control + shed-victim selection.

    Owned by a :class:`~repro_torch.dispatch.dispatcher.Dispatcher`: lanes are
    (un)registered with their ``priority_class`` (lower = more important)
    and optional latency target; engine quanta feed a per-class
    service-time estimate (EWMA of observed step durations, or an
    explicit :meth:`set_service_estimate` for deterministic tests);
    request completions feed the :class:`AdaptiveController`.

    The admission rule is conservative on purpose: a request is refused
    only when it is *provably* unmeetable — the estimated wait for the
    work already ahead of it, plus its own service, exceeds its deadline:
    ``(queued_ahead + 1) × service_estimate > target``.  With no target
    or no estimate yet, everything admits (best-effort is the default,
    exactly as before this layer existed).
    """

    def __init__(
        self,
        *,
        controller: Optional[AdaptiveController] = None,
        clock: Callable[[], float] = time.perf_counter,
        alpha: float = 0.25,
    ) -> None:
        if not (0 < alpha <= 1):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self._clock = clock
        self.controller = (
            controller if controller is not None
            else AdaptiveController(clock=clock)
        )
        self._alpha = alpha
        self._class: dict[str, int] = {}
        self._target: dict[str, Optional[float]] = {}      # seconds
        self._step_est: dict[int, float] = {}              # cls -> EWMA step s
        self._est_pinned: set[int] = set()                 # test-injected

    # -- registry ----------------------------------------------------------

    def register_lane(
        self,
        lane: str,
        *,
        priority_class: int = 0,
        latency_target_ms: Optional[float] = None,
    ) -> None:
        """Admit ``lane`` at ``priority_class`` (lower = more important)
        with an optional per-request latency target in milliseconds
        (``None``: best-effort, never rejected or shed)."""
        if priority_class < 0:
            raise ValueError(
                f"priority_class must be >= 0, got {priority_class}"
            )
        if latency_target_ms is not None and latency_target_ms <= 0:
            raise ValueError(
                f"latency_target_ms must be > 0, got {latency_target_ms}"
            )
        self._class[lane] = int(priority_class)
        self._target[lane] = (
            None if latency_target_ms is None else latency_target_ms / 1e3
        )

    def unregister_lane(self, lane: str) -> None:
        """Forget ``lane``'s class and target (idempotent) — the SLO half
        of the scrub ``Dispatcher.unregister_model`` performs."""
        self._class.pop(lane, None)
        self._target.pop(lane, None)

    def lane_class(self, lane: str) -> int:
        """``lane``'s priority class (0 — the most important — when the
        lane was never registered here)."""
        return self._class.get(lane, 0)

    def target_s(self, lane: str) -> Optional[float]:
        """``lane``'s latency target in seconds, or ``None`` (best-effort)."""
        return self._target.get(lane)

    def classes(self) -> list[int]:
        """Distinct registered priority classes, most important first."""
        return sorted(set(self._class.values()))

    # -- feedback ----------------------------------------------------------

    def on_step(self, lane: str, seconds: float) -> None:
        """Fold one engine-quantum duration into the lane's class
        service-time estimate (EWMA) — the number admission multiplies by
        queue depth.  A class pinned by :meth:`set_service_estimate`
        keeps its pinned value (deterministic tests)."""
        cls = self._class.get(lane)
        if cls is None or cls in self._est_pinned:
            return
        prev = self._step_est.get(cls)
        self._step_est[cls] = (
            seconds if prev is None
            else (1 - self._alpha) * prev + self._alpha * seconds
        )

    def set_service_estimate(self, cls: int, seconds: Optional[float]) -> None:
        """Pin class ``cls``'s service-time estimate (``None`` unpins and
        resumes the observed EWMA) — the injection point that makes
        admission decisions exactly reproducible under a fake clock."""
        if seconds is None:
            self._est_pinned.discard(cls)
            self._step_est.pop(cls, None)
        else:
            self._est_pinned.add(cls)
            self._step_est[cls] = float(seconds)

    def service_estimate(self, cls: int) -> Optional[float]:
        """Current per-quantum service estimate for class ``cls`` (or
        ``None`` before any observation — admission then never rejects)."""
        return self._step_est.get(cls)

    def on_complete(self, lane: str, e2e_s: float) -> bool:
        """Feed one completed request's end-to-end latency to the
        overload controller; returns True when the lane has a target and
        this request missed it (the deadline-miss series' input)."""
        target = self._target.get(lane)
        if target is None:
            return False
        self.controller.observe(self._class.get(lane, 0), e2e_s, target)
        return e2e_s > target

    def overloaded(self, cls: int) -> bool:
        """Whether class ``cls`` is in the controller's overload state."""
        return self.controller.overloaded(cls)

    def any_overloaded(self) -> bool:
        """Whether any class is overloaded (the cheap shed gate)."""
        return self.controller.any_overloaded()

    # -- admission + shedding ----------------------------------------------

    def deadline_for(self, lane: str, now: Optional[float] = None) -> float:
        """``lane``'s deadline for a request submitted now (``0.0`` when
        the lane has no latency target)."""
        target = self._target.get(lane)
        if target is None:
            return 0.0
        return (self._clock() if now is None else now) + target

    def unmeetable(
        self,
        lane: str,
        deadline: float,
        queued_ahead: int,
        now: Optional[float] = None,
    ) -> bool:
        """Whether a request with ``deadline`` and ``queued_ahead``
        requests in front of it provably cannot finish in time, given the
        class's current service estimate.  ``False`` whenever the claim
        cannot be proven (no deadline, no estimate yet)."""
        if deadline <= 0:
            return False
        est = self._step_est.get(self._class.get(lane, 0))
        if est is None:
            return False
        t = self._clock() if now is None else now
        return t + (queued_ahead + 1) * est > deadline

    def admit(
        self,
        lane: str,
        queued_ahead: int,
        *,
        deadline: Optional[float] = None,
        now: Optional[float] = None,
    ) -> float:
        """Admission check for one request landing on ``lane`` behind
        ``queued_ahead`` queued requests: returns the request's deadline
        (``0.0`` — no target) or raises :class:`AdmissionRejected` when
        that deadline is provably unmeetable.  ``deadline`` overrides the
        computed ``now + target`` when the caller pre-stamped one."""
        t = self._clock() if now is None else now
        dl = self.deadline_for(lane, now=t) if deadline is None else deadline
        if self.unmeetable(lane, dl, queued_ahead, now=t):
            cls = self._class.get(lane, 0)
            est = self._step_est.get(cls, 0.0)
            raise AdmissionRejected(
                f"deadline unmeetable for {lane!r} (class {cls}): "
                f"{queued_ahead} queued ahead x ~{est * 1e3:.2f} ms/quantum "
                f"exceeds the {max(dl - t, 0.0) * 1e3:.2f} ms budget",
                lane=lane, priority_class=cls, deadline=dl,
            )
        return dl

    @staticmethod
    def pick_shed(candidates: Sequence[tuple]) -> int:
        """Choose the shed victim among ``(lane, priority_class,
        deadline)`` candidates: always the **lowest class** (largest
        class number), and within it the **latest deadline** — the
        request that costs the least SLO damage to drop.  Returns the
        winning index; raises ``ValueError`` on an empty candidate list.
        """
        if not candidates:
            raise ValueError("pick_shed needs at least one candidate")
        return max(
            range(len(candidates)),
            key=lambda i: (candidates[i][1], candidates[i][2]),
        )

    def snapshot(self) -> dict:
        """Registry + controller state: per-lane class/target, per-class
        service estimates, and the controller's overload view."""
        return {
            "lanes": {
                lane: {
                    "priority_class": cls,
                    "latency_target_ms": (
                        None if self._target.get(lane) is None
                        else self._target[lane] * 1e3
                    ),
                }
                for lane, cls in sorted(self._class.items())
            },
            "service_estimate_ms": {
                cls: est * 1e3 for cls, est in sorted(self._step_est.items())
            },
            "controller": self.controller.snapshot(),
        }
