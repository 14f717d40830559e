"""Unified observability plane: spans, trace export, metrics registry.

Three pieces, one import surface:

* :mod:`repro_torch.obs.tracer` — :class:`SpanTracer`, a lock-light per-thread
  ring-buffer recorder for the request lifecycle (submit → queued →
  granted → step → complete/failed), arbiter, cache, and pool events.
  :func:`get_tracer` returns the process-wide default instance every
  dispatch component falls back to.
* :mod:`repro_torch.obs.export` — Chrome trace-event / Perfetto JSON export
  (:func:`to_chrome_trace` / :func:`write_chrome_trace`), structural
  validation (:func:`validate_trace`), and analysis helpers
  (:func:`step_spans`, :func:`worker_overlap`, :func:`composed_spans` —
  the latter extracts the batch composer's shared-decode spans and their
  per-tenant share fan-out).
* :mod:`repro_torch.obs.registry` — :class:`MetricsRegistry`, a typed
  pull-based registry with JSON and Prometheus text exposition, plus
  adapters (:func:`register_dispatch`, :func:`register_cache`,
  :func:`register_tracer`, :func:`register_worker_plane`) over the
  dispatch layer's snapshot dicts.

Multi-process traces: :class:`TraceEvent` carries a ``pid`` (1 for the
parent), and ``to_chrome_trace(..., extra_events=plane.trace_events())``
merges a worker plane's parent-clock, pid-stamped spans into one
Perfetto trace with per-process track groups.

This package imports nothing from :mod:`repro_torch.dispatch` or
:mod:`repro_torch.serving` — those layers depend on this one, never the
reverse.
"""

from .export import (
    composed_spans,
    step_spans,
    to_chrome_trace,
    validate_trace,
    worker_overlap,
    write_chrome_trace,
)
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Sample,
    register_cache,
    register_dispatch,
    register_tracer,
    register_worker_plane,
    samples_from_dict,
)
from .tracer import SpanTracer, TraceEvent, get_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Sample",
    "SpanTracer",
    "TraceEvent",
    "composed_spans",
    "get_tracer",
    "register_cache",
    "register_dispatch",
    "register_tracer",
    "register_worker_plane",
    "samples_from_dict",
    "step_spans",
    "to_chrome_trace",
    "validate_trace",
    "worker_overlap",
    "write_chrome_trace",
]
