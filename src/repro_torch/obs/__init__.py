"""Observability for the port: the span tracer the engine and the schedule
cache emit to.  Export and the metrics registry are not ported yet."""

from .tracer import SpanTracer, TraceEvent, get_tracer

__all__ = ["SpanTracer", "TraceEvent", "get_tracer"]
