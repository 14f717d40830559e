"""Pull-based metrics registry: one collector protocol over every series.

The dispatch plane already *has* the numbers — ``DispatchMetrics``
snapshots, ``ScheduleCache.snapshot()``, ``FairnessPolicy.snapshot()``,
the arbiter's wakeup/grant counters — but each lives behind its own
ad-hoc dict shape, so "what is the system doing right now" means knowing
four APIs.  :class:`MetricsRegistry` unifies them behind one **pull**
model: nothing is pushed at record time; each registered collector is
invoked at :meth:`MetricsRegistry.collect` time and returns typed
:class:`Sample` values (counter / gauge / summary / histogram), which the
registry exposes as JSON (:meth:`MetricsRegistry.to_json`) or
Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus`).

Three layers:

* **Typed instruments** — :class:`Counter`, :class:`Gauge`,
  :class:`Histogram`: thread-safe primitives for new code that wants to
  record directly into the registry model.
* **Adapters** — :func:`register_dispatch` / :func:`register_cache`
  translate the existing snapshot dicts into samples at collect time, so
  a dispatcher + cache stack is fully exposed without changing how it
  records: the ``dispatcher``, ``fairness``, ``arbiter``, ``pool``, and
  ``schedule_cache`` groups all come out of one ``collect()``.
* **Escape hatch** — :meth:`MetricsRegistry.register` takes any callable
  returning samples (or any object with a ``samples()`` method), so new
  subsystems join the plane without touching this module.

Everything is stdlib-only and duck-typed against the dispatch layer (no
imports from ``repro_torch.dispatch``), so ``repro_torch.dispatch`` may depend on
``repro_torch.obs`` without a cycle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
import threading
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional, Union

COUNTER = "counter"      #: monotonically increasing total
GAUGE = "gauge"          #: point-in-time value
SUMMARY = "summary"      #: precomputed quantiles dict (count/mean/p50/…)
HISTOGRAM = "histogram"  #: cumulative bucket counts + sum + count


@dataclasses.dataclass(frozen=True)
class Sample:
    """One exposed metric sample.

    ``kind`` is one of :data:`COUNTER` / :data:`GAUGE` / :data:`SUMMARY` /
    :data:`HISTOGRAM`.  ``value`` is a number for counters and gauges, a
    dict of precomputed aggregates for summaries (the metrics layer's
    ``summary_ms`` shape: count/mean/p50/p90/p95/p99/max, optionally
    ``dropped``), and for histograms a dict with ``buckets`` (upper-bound
    → cumulative count), ``sum`` and ``count``.  ``labels`` is a sorted
    tuple of ``(key, value)`` pairs."""

    name: str
    kind: str
    value: Any
    labels: tuple = ()

    def as_dict(self) -> dict:
        """Plain-dict view (JSON exposition unit)."""
        out: dict[str, Any] = {"name": self.name, "kind": self.kind,
                               "value": self.value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class Counter:
    """Thread-safe monotonically increasing counter instrument."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._v = 0.0
        self._mu = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0 — counters only go up)."""
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._mu:
            self._v += n

    @property
    def value(self) -> float:
        """Current total."""
        with self._mu:
            return self._v

    def samples(self) -> list[Sample]:
        """This counter as a one-sample collector."""
        return [Sample(self.name, COUNTER, self.value)]


class Gauge:
    """Thread-safe point-in-time gauge; either set explicitly or backed
    by a callable evaluated at collect time (pull semantics)."""

    def __init__(
        self, name: str, help: str = "",
        fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.name = name
        self.help = help
        self._fn = fn
        self._v = 0.0
        self._mu = threading.Lock()

    def set(self, v: float) -> None:
        """Set the gauge (ignored at collect time if a ``fn`` backs it)."""
        with self._mu:
            self._v = float(v)

    @property
    def value(self) -> float:
        """Current value (evaluates the backing callable, if any)."""
        if self._fn is not None:
            return float(self._fn())
        with self._mu:
            return self._v

    def samples(self) -> list[Sample]:
        """This gauge as a one-sample collector."""
        return [Sample(self.name, GAUGE, self.value)]


class Histogram:
    """Thread-safe cumulative-bucket histogram instrument.

    ``buckets`` are the upper bounds (sorted ascending; a ``+Inf`` bucket
    is implicit).  ``observe`` is O(log buckets)."""

    DEFAULT_BUCKETS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(
        self, name: str, help: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> None:
        self.name = name
        self.help = help
        self._bounds = sorted(float(b) for b in buckets)
        if not self._bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self._bounds) + 1)   # +Inf at the end
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, v: float) -> None:
        """Record one observation into its bucket."""
        i = bisect.bisect_left(self._bounds, v)
        with self._mu:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def samples(self) -> list[Sample]:
        """This histogram as a one-sample collector (cumulative buckets)."""
        with self._mu:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, buckets = 0, OrderedDict()
        for bound, c in zip(self._bounds, counts):
            cum += c
            buckets[str(bound)] = cum
        buckets["+Inf"] = total
        return [Sample(
            self.name, HISTOGRAM,
            {"buckets": buckets, "sum": s, "count": total},
        )]


CollectorLike = Union[Callable[[], Iterable[Sample]], Any]


class MetricsRegistry:
    """Named groups of pull collectors with JSON + Prometheus exposition.

    ``register(group, collector)`` accepts a callable returning samples,
    an object with a ``samples()`` method (the typed instruments), or an
    iterable of either.  ``collect()`` pulls every group once and returns
    ``{group: [sample dicts]}`` — one coherent snapshot across
    dispatcher, fairness, arbiter, and cache series.  A collector that
    raises contributes an ``up == 0`` gauge for its group instead of
    poisoning the whole scrape (the Prometheus convention).  Thread-safe.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._groups: "OrderedDict[str, list]" = OrderedDict()

    def register(self, group: str, collector: CollectorLike) -> None:
        """Add ``collector`` under ``group`` (multiple collectors may
        share a group; their samples concatenate)."""
        with self._mu:
            self._groups.setdefault(group, []).append(collector)

    def unregister(self, group: str) -> None:
        """Drop every collector registered under ``group``."""
        with self._mu:
            self._groups.pop(group, None)

    @property
    def groups(self) -> tuple:
        """Registered group names, in registration order."""
        with self._mu:
            return tuple(self._groups)

    @staticmethod
    def _pull(collector: CollectorLike) -> list[Sample]:
        if hasattr(collector, "samples"):
            return list(collector.samples())
        return list(collector())

    def collect(self) -> dict:
        """Pull every collector once: ``{group: [sample dicts]}``."""
        with self._mu:
            groups = {g: list(cs) for g, cs in self._groups.items()}
        out: dict[str, list] = {}
        for group, collectors in groups.items():
            samples: list[dict] = []
            for c in collectors:
                try:
                    samples.extend(s.as_dict() for s in self._pull(c))
                except Exception as exc:  # noqa: BLE001 - scrape isolation
                    samples.append(Sample(
                        "up", GAUGE, 0.0, (("error", repr(exc)),)
                    ).as_dict())
            out[group] = samples
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        """One :meth:`collect` snapshot as a JSON document."""
        return json.dumps(self.collect(), indent=indent, default=str)

    def to_prometheus(self) -> str:
        """One :meth:`collect` snapshot in Prometheus text exposition
        format (version 0.0.4): ``repro_<group>_<name>`` metric names,
        ``# TYPE`` headers, quantile-labelled summaries, cumulative
        ``_bucket`` histogram series."""
        lines: list[str] = []
        for group, samples in self.collect().items():
            for s in samples:
                name = _prom_name(f"repro_{group}_{s['name']}")
                labels = s.get("labels", {})
                kind = s["kind"]
                if kind in (COUNTER, GAUGE):
                    lines.append(f"# TYPE {name} {kind}")
                    lines.append(f"{name}{_prom_labels(labels)} "
                                 f"{_prom_num(s['value'])}")
                elif kind == SUMMARY:
                    lines.extend(_prom_summary(name, s["value"], labels))
                elif kind == HISTOGRAM:
                    lines.extend(_prom_histogram(name, s["value"], labels))
        return "\n".join(lines) + "\n"


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _PROM_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(labels: dict, extra: tuple = ()) -> str:
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(
        f'{_prom_name(str(k))}="{_prom_escape(v)}"' for k, v in items
    )
    return "{" + body + "}"


def _prom_escape(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _prom_num(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p95", "0.95"), ("p99", "0.99"))


def _prom_summary(name: str, value: dict, labels: dict) -> list[str]:
    lines = [f"# TYPE {name} summary"]
    for key, q in _QUANTILES:
        if key in value:
            lines.append(
                f"{name}{_prom_labels(labels, (('quantile', q),))} "
                f"{_prom_num(value[key])}"
            )
    if "count" in value:
        lines.append(f"{name}_count{_prom_labels(labels)} "
                     f"{_prom_num(value['count'])}")
    for aux in ("mean", "max", "dropped"):
        if aux in value:
            lines.append(f"{name}_{aux}{_prom_labels(labels)} "
                         f"{_prom_num(value[aux])}")
    return lines


def _prom_histogram(name: str, value: dict, labels: dict) -> list[str]:
    lines = [f"# TYPE {name} histogram"]
    for bound, cum in value.get("buckets", {}).items():
        lines.append(
            f"{name}_bucket{_prom_labels(labels, (('le', bound),))} "
            f"{_prom_num(cum)}"
        )
    lines.append(f"{name}_sum{_prom_labels(labels)} "
                 f"{_prom_num(value.get('sum', 0.0))}")
    lines.append(f"{name}_count{_prom_labels(labels)} "
                 f"{_prom_num(value.get('count', 0))}")
    return lines


# -- adapters over the dispatch layer's snapshot dicts ---------------------

def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_summary(v: Any) -> bool:
    return isinstance(v, dict) and "count" in v and (
        "p50" in v or "mean" in v
    )


def samples_from_dict(
    d: dict, *, prefix: str = "", labels: tuple = (), counters: tuple = (),
) -> list[Sample]:
    """Generic snapshot-dict → samples translation.

    Numeric leaves become gauges (or counters, when their dotted path is
    listed in ``counters``); ``summary_ms``-shaped dicts become summaries;
    a dict of ``str → number`` (e.g. per-lane ``served_steps``) becomes
    one labelled sample per key; other nested dicts recurse with a dotted
    prefix.  Non-numeric leaves (policy names, flags) are skipped —
    exposition formats carry numbers, not strings."""
    out: list[Sample] = []
    for key, v in d.items():
        name = f"{prefix}{key}"
        kind = COUNTER if name in counters else GAUGE
        if _is_num(v):
            out.append(Sample(name, kind, v, labels))
        elif isinstance(v, bool):
            out.append(Sample(name, GAUGE, float(v), labels))
        elif _is_summary(v):
            out.append(Sample(name, SUMMARY, dict(v), labels))
        elif isinstance(v, dict):
            if v and all(_is_num(x) for x in v.values()):
                for sub, x in v.items():
                    out.append(Sample(
                        name, kind, x, labels + (("key", str(sub)),)
                    ))
            else:
                out.extend(samples_from_dict(
                    v, prefix=f"{name}.", labels=labels, counters=counters,
                ))
    return out


_DISPATCH_COUNTERS = (
    "requests_done", "tokens_out", "rejected", "grants",
)
_ARBITER_COUNTERS = (
    "grants", "timed_grants", "timed_wakeups", "notify_wakeups",
)


def register_dispatch(registry: MetricsRegistry, dispatcher: Any) -> None:
    """Expose a (sync or async) dispatcher through ``registry``.

    Registers pull collectors over ``dispatcher.snapshot()`` split into
    the groups operators actually dashboard separately: ``dispatcher``
    (request/latency/throughput/grant series, per-engine breakdown with
    ``lane`` labels), ``fairness`` (the policy's own snapshot),
    ``arbiter`` (wakeup/grant counters + parking state, async only), and
    ``pool`` (occupancy, pool mode only).  Everything is pulled at
    collect time — one ``snapshot()`` call per scrape."""

    def _snap() -> dict:
        return dispatcher.snapshot()

    def dispatch_samples() -> list[Sample]:
        snap = _snap()
        out = samples_from_dict(
            {k: v for k, v in snap.items()
             if k not in ("fairness", "engines", "async", "schedule_cache",
                          "models", "pool")},
            counters=_DISPATCH_COUNTERS,
        )
        for lane, rec in snap.get("engines", {}).items():
            out.extend(samples_from_dict(
                rec, prefix="engine.", labels=(("lane", lane),),
                counters=("engine.steps", "engine.tokens"),
            ))
        return out

    def fairness_samples() -> list[Sample]:
        return samples_from_dict(_snap().get("fairness", {}))

    def arbiter_samples() -> list[Sample]:
        snap = _snap()
        arb = (snap.get("async") or {}).get("arbiter") or {}
        out = samples_from_dict(arb, counters=_ARBITER_COUNTERS)
        async_snap = snap.get("async") or {}
        for key in ("steppers", "futures_pending", "builds_on_thread"):
            if key in async_snap:
                out.append(Sample(key, GAUGE, async_snap[key]))
        return out

    def pool_samples() -> list[Sample]:
        return samples_from_dict(_snap().get("pool", {}))

    registry.register("dispatcher", dispatch_samples)
    registry.register("fairness", fairness_samples)
    if hasattr(dispatcher, "builds_by_stepper"):      # async front door
        registry.register("arbiter", arbiter_samples)
    registry.register("pool", pool_samples)


_CACHE_COUNTERS = (
    "hits", "misses", "evictions", "bytes_evicted", "builds",
)


def register_cache(
    registry: MetricsRegistry, cache: Any, *, group: str = "schedule_cache",
) -> None:
    """Expose a ``ScheduleCache`` through ``registry`` under ``group``:
    hit/miss/eviction/build counters, build-time totals, entry count and
    resident arena bytes against the configured budget — pulled from
    ``cache.snapshot()`` at collect time."""

    def cache_samples() -> list[Sample]:
        snap = cache.snapshot()
        out = samples_from_dict(
            {k: v for k, v in snap.items() if k not in ("entries", "stats")},
        )
        out.extend(samples_from_dict(
            snap.get("stats", {}), counters=_CACHE_COUNTERS,
        ))
        return out

    registry.register(group, cache_samples)


def register_worker_plane(
    registry: MetricsRegistry, plane: Any, *, group: str = "workers",
) -> None:
    """Expose a ``WorkerPlane`` through ``registry`` under ``group``: one
    ``up`` gauge plus per-worker serving/dead/abandoned state, restart
    counts, heartbeat age, lane census, and the worker-reported
    step/token counters (shipped back with each heartbeat), labelled by
    worker index and device — pulled from ``plane.snapshot()`` at
    collect time."""

    def plane_samples() -> list[Sample]:
        snap = plane.snapshot()
        out = [
            Sample("n_workers", GAUGE, snap.get("n_workers", 0)),
        ]
        for rec in snap.get("workers", ()):
            labels = (
                ("worker", str(rec.get("index", ""))),
                ("device", str(rec.get("device", ""))),
            )
            out.append(Sample(
                "up", GAUGE,
                1.0 if rec.get("status") == "serving" else 0.0, labels,
            ))
            out.append(Sample(
                "restarts", COUNTER, rec.get("restarts", 0), labels,
            ))
            out.append(Sample(
                "lanes", GAUGE, len(rec.get("lanes", ())), labels,
            ))
            hb = rec.get("heartbeat_age_s")
            if _is_num(hb):
                out.append(Sample("heartbeat_age_s", GAUGE, hb, labels))
            stats = rec.get("stats") or {}
            out.extend(samples_from_dict(
                stats, labels=labels,
                counters=tuple(stats),   # worker counters only grow
            ))
        return out

    registry.register(group, plane_samples)


def register_tracer(
    registry: MetricsRegistry, tracer: Any, *, group: str = "tracer",
) -> None:
    """Expose a ``SpanTracer``'s own health (buffered/emitted/dropped
    event counts, ring census) under ``group`` — the observability plane
    watching itself, so silent ring-buffer truncation shows up on the
    same dashboard as the series it would bias."""

    def tracer_samples() -> list[Sample]:
        return samples_from_dict(
            tracer.stats(), counters=("emitted", "dropped"),
        )

    registry.register(group, tracer_samples)
