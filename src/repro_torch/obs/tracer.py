"""Span tracer: lock-light per-thread ring-buffer event recorder.

The paper's own method, turned into infrastructure: Nimble had to *measure*
the scheduling gap (Fig. 2) before it could remove it, and every dispatch
claim this repo makes (multi-worker overlap, sub-tick grant latency, flat
per-grant CPU) is currently proven only by counters buried in tests.  The
tracer records the full request lifecycle — ``submit → queued → granted →
step[i] → complete`` — plus arbiter events (grant, park, wake, timed
tick), schedule-cache events (build spans, hits, byte-evictions), and
stepper-pool occupancy transitions, correlated by request id + lane +
recording thread, so an exporter (the JAX package's ``obs/export.py``;
not ported yet) can render the overlap
``chrome://tracing`` / Perfetto actually shows.

Design constraints (DESIGN.md §observability):

* **Disabled is a no-op.**  Every instrumented hot path guards with one
  branch — ``if tracer.enabled: tracer.instant(...)`` — so a disabled
  tracer costs a single attribute load + comparison and never builds the
  event's arguments.  The emit methods *also* re-check ``enabled``, so an
  unguarded call site is still safe, just marginally slower.
* **Thread-owned ring buffers.**  Each recording thread appends to its
  own bounded ring (``collections.deque(maxlen=...)``) reached through
  ``threading.local`` — the only shared lock is taken once per thread,
  at first emit, to register the ring for draining.  No emit ever
  contends with another thread's emit.
* **Bounded and honest.**  Rings drop the oldest events once full;
  per-ring ``emitted`` counters make the drop count visible
  (:meth:`SpanTracer.stats`), mirroring the metrics layer's windowed
  ``dropped`` accounting.
* **Draining is cooperative.**  :meth:`SpanTracer.drain` snapshots every
  ring; a ring owned by a live, still-emitting thread is copied with a
  bounded retry (a concurrent append can invalidate one copy attempt).
  Rings of dead threads stay registered so their events survive into the
  export.

Event phases follow the Chrome trace-event vocabulary so the exporter is
a near-passthrough: ``X`` complete spans, ``i`` instants, ``b``/``e``
async begin/end (one async track per request id), ``C`` counters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional


class TraceEvent(NamedTuple):
    """One drained trace event, stamped with its recording thread.

    ``ts`` is the tracer clock's reading at the event (span start for
    ``X`` events), ``dur`` the span duration in the same unit (0.0 for
    non-spans), ``ph`` the Chrome trace-event phase (``X``/``i``/``b``/
    ``e``/``C``), ``rid`` the request id for request-correlated events
    (``None`` otherwise), ``lane`` the tenant lane (``""`` otherwise),
    and ``tid``/``thread`` the recording thread's ident and name.
    ``pid`` identifies the recording *process* for multi-process traces
    (worker-plane spans merge under their worker's OS pid; the parent's
    own events default to 1), giving the Perfetto export one track group
    per process."""

    ts: float
    ph: str
    cat: str
    name: str
    dur: float
    rid: Optional[int]
    lane: str
    args: Optional[dict]
    tid: int
    thread: str
    pid: int = 1


class _Ring:
    """One thread's event ring: owned (appended) by exactly one thread,
    registered once so drains can find it.  ``emitted`` counts every
    append, so ``emitted - len(buf)`` is the drop count."""

    __slots__ = ("ident", "name", "buf", "emitted")

    def __init__(self, ident: int, name: str, cap: int) -> None:
        self.ident = ident
        self.name = name
        self.buf: deque = deque(maxlen=cap)
        self.emitted = 0


class SpanTracer:
    """Per-thread ring-buffer recorder for dispatch-plane trace events.

    One instance is typically shared by a whole dispatch stack (the
    module-level tracer from :func:`get_tracer` is the default everywhere)
    and starts **disabled**: instrumented code runs at production speed
    until :meth:`enable` is called.  All methods are safe from any
    thread; emits never take a shared lock (see the module docstring for
    the ownership contract).
    """

    def __init__(
        self,
        *,
        buffer_size: int = 65536,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self.enabled = False
        self.buffer_size = buffer_size
        self.clock = clock
        self._local = threading.local()
        self._mu = threading.Lock()          # ring registry only
        self._rings: list[_Ring] = []

    # -- lifecycle ---------------------------------------------------------

    def enable(self) -> "SpanTracer":
        """Start recording (idempotent); returns ``self`` for chaining."""
        self.enabled = True
        return self

    def disable(self) -> "SpanTracer":
        """Stop recording (idempotent); buffered events stay drainable."""
        self.enabled = False
        return self

    def clear(self) -> None:
        """Drop every buffered event and reset drop counters.  Rings stay
        registered (their owning threads hold thread-local references)."""
        with self._mu:
            for ring in self._rings:
                ring.buf.clear()
                ring.emitted = 0

    # -- recording (each thread appends only to its own ring) --------------

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            ring = _Ring(t.ident or 0, t.name, self.buffer_size)
            self._local.ring = ring
            with self._mu:                   # once per (thread, tracer)
                self._rings.append(ring)
        return ring

    def instant(
        self,
        name: str,
        *,
        cat: str = "dispatch",
        lane: str = "",
        rid: Optional[int] = None,
        args: Optional[dict] = None,
    ) -> None:
        """Record a point-in-time event (Chrome phase ``i``)."""
        if not self.enabled:
            return
        ring = self._ring()
        ring.emitted += 1
        ring.buf.append((self.clock(), "i", cat, name, 0.0, rid, lane, args))

    def complete(
        self,
        name: str,
        ts: float,
        dur: float,
        *,
        cat: str = "dispatch",
        lane: str = "",
        rid: Optional[int] = None,
        args: Optional[dict] = None,
    ) -> None:
        """Record a finished span (Chrome phase ``X``): ``ts`` is the span
        start on this tracer's clock, ``dur`` its duration.  Callers
        already hold both timestamps (they bracketed the work for
        metrics), so no begin/end pairing state is needed — a span is one
        append, recorded at its end."""
        if not self.enabled:
            return
        ring = self._ring()
        ring.emitted += 1
        ring.buf.append((ts, "X", cat, name, max(0.0, dur), rid, lane, args))

    def async_begin(
        self,
        name: str,
        rid: int,
        *,
        cat: str = "request",
        lane: str = "",
        args: Optional[dict] = None,
    ) -> None:
        """Open the async span for request ``rid`` (Chrome phase ``b``) —
        one async track per request in the exported trace."""
        if not self.enabled:
            return
        ring = self._ring()
        ring.emitted += 1
        ring.buf.append((self.clock(), "b", cat, name, 0.0, rid, lane, args))

    def async_end(
        self,
        name: str,
        rid: int,
        *,
        cat: str = "request",
        lane: str = "",
        args: Optional[dict] = None,
    ) -> None:
        """Close request ``rid``'s async span (Chrome phase ``e``).  The
        ``name``/``cat`` must match the opening :meth:`async_begin`."""
        if not self.enabled:
            return
        ring = self._ring()
        ring.emitted += 1
        ring.buf.append((self.clock(), "e", cat, name, 0.0, rid, lane, args))

    def counter(
        self,
        name: str,
        value: float,
        *,
        cat: str = "dispatch",
        series: str = "value",
    ) -> None:
        """Record a counter-track sample (Chrome phase ``C``) — e.g. the
        stepper pool's busy-worker count at an occupancy transition."""
        if not self.enabled:
            return
        ring = self._ring()
        ring.emitted += 1
        ring.buf.append(
            (self.clock(), "C", cat, name, 0.0, None, "", {series: value})
        )

    # -- draining ----------------------------------------------------------

    @staticmethod
    def _snapshot(buf: deque) -> list:
        # a live owner may append mid-copy (deques forbid mutation during
        # iteration); retry a few times, then trade one drop-window of
        # accuracy for progress by pop-free best effort
        for _ in range(8):
            try:
                return list(buf)
            except RuntimeError:
                continue
        return []

    def drain(self) -> list[TraceEvent]:
        """Snapshot every thread's ring into one time-sorted event list.

        Non-destructive: buffers keep their contents (use :meth:`clear`
        between capture windows).  Safe while recording threads are live —
        each ring is copied with a bounded retry against concurrent
        appends."""
        with self._mu:
            rings = list(self._rings)
        out: list[TraceEvent] = []
        for ring in rings:
            for ev in self._snapshot(ring.buf):
                out.append(TraceEvent(*ev, tid=ring.ident, thread=ring.name))
        out.sort(key=lambda e: e.ts)
        return out

    def stats(self) -> dict:
        """Recorder state: enabled flag, per-thread ring count, buffered
        and emitted event totals, and how many events the bounded rings
        have dropped (``emitted - buffered``, summed)."""
        with self._mu:
            rings = list(self._rings)
        buffered = sum(len(r.buf) for r in rings)
        emitted = sum(r.emitted for r in rings)
        return {
            "enabled": self.enabled,
            "threads": len(rings),
            "buffered": buffered,
            "emitted": emitted,
            "dropped": emitted - buffered,
            "buffer_size": self.buffer_size,
        }


_GLOBAL = SpanTracer()


def get_tracer() -> SpanTracer:
    """The process-wide default tracer every dispatch component falls back
    to when constructed without an explicit ``tracer=``.  Starts disabled;
    ``get_tracer().enable()`` turns on capture for the whole stack."""
    return _GLOBAL
