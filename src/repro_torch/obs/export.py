"""Trace export: serialize tracer rings to Chrome trace-event / Perfetto JSON.

``chrome://tracing`` and https://ui.perfetto.dev both consume the Chrome
trace-event JSON object format (a ``traceEvents`` array plus metadata).
The mapping from :class:`repro_torch.obs.tracer.TraceEvent`:

* one **thread track per recording thread** — stepper workers appear as
  ``repro-dispatch-step[pool-N]`` rows, so the multi-worker overlap that
  ``test_stepper_pool`` proves numerically becomes *visible*: ``X``
  (complete) span events carry ``ts``/``dur`` on their recording
  thread's track, with lane and request id in ``args``;
* one **async track per request** — ``b``/``e`` pairs share
  ``id == rid`` (and category ``request``), so each request renders as
  one submit→complete bar regardless of which worker threads served it;
* **counter tracks** (``C``) for stepper-pool occupancy;
* ``M`` metadata events name each thread track;
* one **process track group per recording process** — each
  :class:`TraceEvent` carries a ``pid`` (the parent's events default to
  1; worker-plane spans arrive stamped with their worker's OS pid and a
  parent-clock timestamp via the spawn-time clock-offset handshake), and
  ``process_name`` metadata labels each group, so a multi-process
  serving plane renders as one merged Perfetto trace with per-process
  tracks.  Pass the plane's collected spans as ``extra_events=``.

Timestamps are exported in microseconds relative to the earliest drained
event, which is what both viewers expect.

:func:`validate_trace` is the structural gate ``make trace-smoke`` and
the tests run over every exported trace: phase-specific required fields,
non-negative durations, and balanced async begin/end pairs — a trace that
fails it would load blank (or not at all) in the viewers.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Optional, Union

from .tracer import SpanTracer, TraceEvent

_PARENT_PID = 1              # default pid: the dispatching (parent) process


def _args(ev: TraceEvent) -> dict:
    out = dict(ev.args) if ev.args else {}
    if ev.lane:
        out.setdefault("lane", ev.lane)
    if ev.rid is not None:
        out.setdefault("rid", ev.rid)
    return out


def to_chrome_trace(
    events_or_tracer: Union[SpanTracer, Iterable[TraceEvent]],
    *,
    extra_events: Optional[Iterable[TraceEvent]] = None,
) -> dict:
    """Convert drained events (or a tracer, drained here) into a Chrome
    trace-event JSON object — ``json.dump`` the result and load it in
    ``chrome://tracing`` or ui.perfetto.dev.

    Deterministic given the events: microsecond timestamps rebased to the
    earliest event, one metadata-named track per recording thread, one
    async track per request id.  ``extra_events`` merges a second event
    stream — ``WorkerPlane.trace_events()``, already parent-clock and
    pid-stamped — into the same trace; events sort together by timestamp
    and each distinct pid gets its own ``process_name``-labelled track
    group."""
    if isinstance(events_or_tracer, SpanTracer):
        events = events_or_tracer.drain()
    else:
        events = list(events_or_tracer)
    if extra_events is not None:
        events = sorted(
            list(events) + list(extra_events), key=lambda e: e.ts
        )
    origin = min((e.ts for e in events), default=0.0)
    # label process tracks only when the trace actually spans processes —
    # a single-process trace keeps its metadata to thread names alone
    multi_pid = len({getattr(e, "pid", _PARENT_PID) for e in events}) > 1
    out: list[dict] = []
    threads_seen: set[tuple[int, int]] = set()
    pids_seen: set[int] = set()
    for ev in events:
        pid = getattr(ev, "pid", _PARENT_PID)
        if multi_pid and pid not in pids_seen:
            pids_seen.add(pid)
            label = (
                "dispatcher (parent)" if pid == _PARENT_PID
                else f"worker pid={pid}"
            )
            out.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": label},
            })
        if (pid, ev.tid) not in threads_seen:
            threads_seen.add((pid, ev.tid))
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": ev.tid,
                "args": {"name": ev.thread},
            })
        ts_us = (ev.ts - origin) * 1e6
        rec: dict[str, Any] = {
            "ph": ev.ph, "name": ev.name, "cat": ev.cat,
            "pid": pid, "tid": ev.tid, "ts": ts_us,
        }
        if ev.ph == "X":
            rec["dur"] = ev.dur * 1e6
            rec["args"] = _args(ev)
        elif ev.ph == "i":
            rec["s"] = "t"               # instant scope: thread
            rec["args"] = _args(ev)
        elif ev.ph in ("b", "e"):
            rec["id"] = str(ev.rid)
            rec["args"] = _args(ev)
        elif ev.ph == "C":
            rec["args"] = dict(ev.args or {})
        else:                            # unknown phase: keep args, let the
            rec["args"] = _args(ev)      # validator flag it
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str,
    events_or_tracer: Union[SpanTracer, Iterable[TraceEvent]],
    *,
    extra_events: Optional[Iterable[TraceEvent]] = None,
) -> dict:
    """Export to ``path`` as JSON; returns the trace object written.
    ``extra_events`` merges a worker plane's collected spans (see
    :func:`to_chrome_trace`)."""
    trace = to_chrome_trace(events_or_tracer, extra_events=extra_events)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


_KNOWN_PHASES = ("X", "i", "b", "e", "C", "M")


def validate_trace(trace: Any) -> list[str]:
    """Structural validation against the trace-event schema; returns one
    error string per violation (empty list == loadable).

    Checks: top-level shape, JSON-serializability, required per-phase
    fields (``ts``/``pid``/``tid`` everywhere but metadata, ``dur >= 0``
    on complete events, ``id`` on async events), known phases only, and
    balanced async begin/end pairs per ``(cat, id)``."""
    errors: list[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["trace must be a dict with a 'traceEvents' list"]
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:
        errors.append(f"trace is not JSON-serializable: {exc}")
    opens: dict[tuple, int] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event[{i}]: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            errors.append(f"event[{i}]: unknown phase {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            errors.append(f"event[{i}] ({ph}): missing name/pid/tid")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event[{i}] ({ph} {ev.get('name')!r}): missing ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event[{i}] (X {ev.get('name')!r}): bad dur {dur!r}"
                )
        if ph in ("b", "e"):
            if "id" not in ev:
                errors.append(f"event[{i}] ({ph} {ev.get('name')!r}): no id")
            else:
                key = (ev.get("cat"), ev["id"])
                opens[key] = opens.get(key, 0) + (1 if ph == "b" else -1)
    for key, depth in opens.items():
        if depth != 0:
            errors.append(
                f"async track {key}: unbalanced begin/end (depth {depth})"
            )
    return errors


def step_spans(trace: dict, cat: str = "step") -> list[tuple]:
    """Every ``X`` span of category ``cat`` as ``(tid, start_us, end_us,
    name)`` tuples — the raw material for overlap analysis."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") == cat:
            out.append(
                (ev["tid"], ev["ts"], ev["ts"] + ev.get("dur", 0.0),
                 ev.get("name", ""))
            )
    return out


def composed_spans(trace: dict) -> list[tuple]:
    """Composed-step decode spans and their per-tenant share fan-out, as
    ``(name, start_us, dur_us, args)`` tuples: every ``X`` span named
    ``composed:<host>`` (one shared device step serving N tenants — the
    batch composer emits one per group quantum, with occupancy and lane
    count in ``args``) followed in emission order by its
    ``composed_share`` instants (``cat="composer"``, one per tenant with
    that step's token count).  The raw material for per-tenant share and
    coalesce-rate analysis straight from a trace."""
    out = []
    for ev in trace.get("traceEvents", []):
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith("composed:"):
            out.append(
                (name, ev["ts"], ev.get("dur", 0.0), ev.get("args", {}))
            )
        elif ev.get("ph") == "i" and name == "composed_share":
            out.append((name, ev["ts"], 0.0, ev.get("args", {})))
    return out


def worker_overlap(trace: dict, cat: str = "step") -> tuple[int, bool]:
    """``(worker_tracks, overlapped)``: how many distinct threads recorded
    ``cat`` spans, and whether any two spans on *different* threads
    overlap in time — the visual claim (≥2 workers stepping
    concurrently) reduced to a checkable boolean.  Linear sweep over the
    spans sorted by start time."""
    spans = sorted(step_spans(trace, cat), key=lambda s: s[1])
    tids = {s[0] for s in spans}
    # best_end: latest span end seen; other_end: latest end on any thread
    # OTHER than best's — a new span overlapping either of the right one
    # proves two threads were mid-span at once
    best_end, best_tid = float("-inf"), None
    other_end = float("-inf")
    overlapped = False
    for tid, start, end, _name in spans:
        if (tid != best_tid and start < best_end) or start < other_end:
            overlapped = True
            break
        if end > best_end:
            if tid != best_tid:
                other_end = best_end
            best_end, best_tid = end, tid
        elif tid != best_tid and end > other_end:
            other_end = end
    return len(tids), overlapped
