"""Explicit request/lane lifecycle state machines with enforced transitions.

Request bookkeeping kept only as implicit flags —
``req.done``, ``req.error``, ``lane.retired``, ``lane.finalizing`` — which
is fine until the control plane has to be *restartable*: a journal can
only replay what was recorded as a well-defined state, and recovery can
only requeue work whose progress it can classify.  This module makes the
states explicit and the transitions enforced:

Request lifecycle::

    SUBMITTED ──► QUEUED ──► GRANTED ──► STEPPING ──► COMPLETED
        │            │           │            │
        │            ├──► SHED   │            ├──► FAILED
        └──► FAILED  └──► FAILED └──► FAILED  └──► INTERRUPTED ─┐
                     ▲           └──► PREEMPTED ─┐              │
                     └───────────────────────────┴──────────────┘
                                  (both re-enter QUEUED on recovery)

* ``SUBMITTED`` — constructed and charged against backpressure; not yet
  durable.  An admission rejection fails it here (never journaled).
* ``QUEUED`` — appended to a lane FIFO; this is the durability point
  (the journal writes the full request record).
* ``GRANTED`` — a scheduling quantum popped it from the FIFO.
* ``STEPPING`` — handed to the engine; tokens may exist from here on.
* ``COMPLETED`` / ``FAILED`` / ``SHED`` — terminal.
* ``PREEMPTED`` — its grant was revoked before the engine saw it (today:
  only by a crash between grant and seat); re-enters ``QUEUED``.
* ``INTERRUPTED`` — it was ``STEPPING`` when the process died; recovery
  marks it so resubmission is explicit and idempotent (deterministic
  engines regenerate the same tokens from a fresh seat), then requeues.

Lane lifecycle: ``REGISTERED → ACTIVE → RETIRING → RETIRED`` (a lane may
retire straight from ``REGISTERED`` if it never served work).

:class:`LifecycleTracker` is the enforcement point the dispatcher calls
on every transition: it validates the move against the tables above
(raising :class:`~repro_torch.dispatch.errors.IllegalTransition` on a violation),
stamps the new state onto the request/lane, gives an attached
:class:`~repro_torch.dispatch.journal.FaultInjector` its crash-at-transition
hook, and enqueues a journal record.  The tracker itself never touches
SQLite — journal appends are O(1) in-memory handoffs to the journal's
writer thread, so transitions are safe to perform near (though by
convention still outside) the dispatcher's hot locks.
"""

from __future__ import annotations

from typing import Any, Optional

from .errors import IllegalTransition


class RequestState:
    """Request lifecycle state names (plain strings, journal-friendly)."""

    SUBMITTED = "submitted"
    QUEUED = "queued"
    GRANTED = "granted"
    STEPPING = "stepping"
    COMPLETED = "completed"
    FAILED = "failed"
    SHED = "shed"
    PREEMPTED = "preempted"
    INTERRUPTED = "interrupted"


class LaneState:
    """Lane lifecycle state names."""

    REGISTERED = "registered"
    ACTIVE = "active"
    RETIRING = "retiring"
    RETIRED = "retired"


#: Terminal request states: no transition leaves them.
TERMINAL_STATES = frozenset(
    {RequestState.COMPLETED, RequestState.FAILED, RequestState.SHED}
)

#: Legal request transitions: ``{src: allowed dst set}``.
REQUEST_TRANSITIONS: dict = {
    RequestState.SUBMITTED: frozenset(
        {RequestState.QUEUED, RequestState.FAILED}
    ),
    RequestState.QUEUED: frozenset(
        {RequestState.GRANTED, RequestState.SHED, RequestState.FAILED}
    ),
    RequestState.GRANTED: frozenset(
        {RequestState.STEPPING, RequestState.PREEMPTED, RequestState.FAILED}
    ),
    RequestState.STEPPING: frozenset(
        {
            RequestState.COMPLETED,
            RequestState.FAILED,
            RequestState.INTERRUPTED,
        }
    ),
    RequestState.PREEMPTED: frozenset({RequestState.QUEUED}),
    RequestState.INTERRUPTED: frozenset({RequestState.QUEUED}),
    RequestState.COMPLETED: frozenset(),
    RequestState.FAILED: frozenset(),
    RequestState.SHED: frozenset(),
}

#: Legal lane transitions: ``{src: allowed dst set}``.
LANE_TRANSITIONS: dict = {
    LaneState.REGISTERED: frozenset({LaneState.ACTIVE, LaneState.RETIRING}),
    LaneState.ACTIVE: frozenset({LaneState.RETIRING}),
    LaneState.RETIRING: frozenset({LaneState.RETIRED}),
    LaneState.RETIRED: frozenset(),
}


def check_request_transition(src: str, dst: str, *, rid: Any = None) -> None:
    """Validate one request transition, raising
    :class:`~repro_torch.dispatch.errors.IllegalTransition` if the state machine
    forbids it.  Unknown source states are illegal by definition."""
    allowed = REQUEST_TRANSITIONS.get(src)
    if allowed is None or dst not in allowed:
        raise IllegalTransition("request", rid, src, dst)


def check_lane_transition(src: str, dst: str, *, name: str = "") -> None:
    """Validate one lane transition (same contract as
    :func:`check_request_transition`)."""
    allowed = LANE_TRANSITIONS.get(src)
    if allowed is None or dst not in allowed:
        raise IllegalTransition("lane", name, src, dst)


class LifecycleTracker:
    """The dispatcher's transition enforcement point.

    One instance per dispatcher.  ``journal`` (a
    :class:`~repro_torch.dispatch.journal.RequestJournal`) and ``faults`` (a
    :class:`~repro_torch.dispatch.journal.FaultInjector`) are both optional;
    with neither attached a transition costs a dict probe and an
    attribute store.  Requests the dispatcher never admitted (work
    submitted straight to an engine) carry no state and are ignored —
    enforcement covers exactly the requests the control plane owns.
    """

    def __init__(
        self, *, journal: Optional[Any] = None, faults: Optional[Any] = None
    ) -> None:
        self.journal = journal
        self.faults = faults

    # -- requests ----------------------------------------------------------

    def begin(self, req: Any) -> None:
        """Stamp a freshly admitted request as ``SUBMITTED`` (the state
        machine's origin; no legality check — a request begins once)."""
        req.state = RequestState.SUBMITTED

    def advance(self, req: Any, dst: str, *, lane: str = "") -> bool:
        """Move ``req`` to state ``dst``, enforcing legality.

        Returns ``False`` (a silent no-op) for untracked requests (no
        ``state``) and for same-state re-entries; raises
        :class:`~repro_torch.dispatch.errors.IllegalTransition` for a forbidden
        move.  On success: stamps ``req.state``, fires the fault
        injector's crash-at-transition hook, and appends the journal
        record (full request row at ``QUEUED`` — the durability point —
        a bare transition row for every later state)."""
        src = getattr(req, "state", "")
        if not src:
            return False
        if src == dst:
            return False
        check_request_transition(src, dst, rid=getattr(req, "rid", None))
        req.state = dst
        if self.faults is not None:
            self.faults.on_transition("request", getattr(req, "rid", None), dst)
        if self.journal is not None:
            if dst == RequestState.QUEUED and not getattr(
                req, "_journaled", False
            ):
                self.journal.record_request(req, lane)
                req._journaled = True
            elif getattr(req, "_journaled", False):
                self.journal.record_transition(req.rid, dst)
        return True

    def is_terminal(self, req: Any) -> bool:
        """Whether ``req`` has reached a terminal state (untracked
        requests report ``False``)."""
        return getattr(req, "state", "") in TERMINAL_STATES

    # -- lanes -------------------------------------------------------------

    def lane_begin(
        self,
        lane: Any,
        *,
        spec: Optional[Any] = None,
        weight: float = 1.0,
        priority_class: int = 0,
        latency_target_ms: Optional[float] = None,
    ) -> None:
        """Stamp a fresh lane ``REGISTERED`` and journal its registration
        (with the picklable engine recipe, when one was provided — that
        recipe is what :meth:`Dispatcher.recover` rebuilds the engine
        from)."""
        lane.lc_state = LaneState.REGISTERED
        if self.faults is not None:
            self.faults.on_transition("lane", lane.name, LaneState.REGISTERED)
        if self.journal is not None:
            self.journal.record_lane(
                lane.name,
                LaneState.REGISTERED,
                spec=spec,
                weight=weight,
                priority_class=priority_class,
                latency_target_ms=latency_target_ms,
            )

    def lane_advance(self, lane: Any, dst: str) -> bool:
        """Move a lane to state ``dst`` (same contract as
        :meth:`advance`; lanes created before a tracker was attached are
        untracked and ignored)."""
        src = getattr(lane, "lc_state", "")
        if not src:
            return False
        if src == dst:
            return False
        check_lane_transition(src, dst, name=lane.name)
        lane.lc_state = dst
        if self.faults is not None:
            self.faults.on_transition("lane", lane.name, dst)
        if self.journal is not None:
            self.journal.record_lane(lane.name, dst)
        return True
