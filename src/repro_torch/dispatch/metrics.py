"""Serving metrics: latency percentiles, throughput, cache snapshots.

The quantities a dispatch layer is judged by (GPU-datacenter scheduling
survey, Gao et al.): time-to-first-token (prefill + queueing), per-token
decode latency, end-to-end request latency, aggregate token throughput —
plus the schedule-cache hit statistics that show the AoT pre-run actually
amortizing.  Everything exports as a plain dict so benchmarks and examples
can print or JSON-dump a snapshot.

Thread-safety contract: :class:`DispatchMetrics` is safe to feed from any
number of threads — a background stepping thread observing completions races
foreground submitters calling ``on_submit``/``on_reject`` and monitoring
threads calling ``snapshot`` — one internal lock serializes every
mutation and every aggregate read.  Bare :class:`LatencySeries` objects are
*not* internally locked; they are only mutated under their owner's lock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile; 0.0 on empty input."""
    if not len(values):
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class LatencySeries:
    """One latency distribution, recorded in seconds.

    ``window`` bounds retention: percentiles are computed over the most
    recent observations (a deque ring, O(1) per record), so a long-running
    service reports current behavior instead of leaking memory linearly
    with traffic.  ``dropped`` counts observations the ring has evicted —
    a windowed p95 over a series that has silently shed most of its
    history is a different claim than one over everything recorded, and
    the summary says which it is."""

    name: str
    values: Any = dataclasses.field(default_factory=list)
    window: int = 65536
    dropped: int = 0

    def __post_init__(self) -> None:
        self.values = deque(self.values, maxlen=self.window)

    def record(self, seconds: float) -> None:
        """Append one observation (in seconds), counting the eviction when
        the bounded window is already full."""
        if len(self.values) == self.window:
            self.dropped += 1
        self.values.append(float(seconds))

    @property
    def count(self) -> int:
        """Observations currently retained (≤ ``window``)."""
        return len(self.values)

    def summary_ms(self) -> dict:
        """Count/mean/p50/p90/p95/p99/max over the retained window (in ms),
        plus ``dropped``: observations the window has evicted."""
        vals = np.asarray(self.values, dtype=np.float64) * 1e3
        if not len(vals):
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                    "p95": 0.0, "p99": 0.0, "max": 0.0,
                    "dropped": self.dropped}
        return {
            "count": int(len(vals)),
            "mean": float(vals.mean()),
            "p50": percentile(vals, 50),
            "p90": percentile(vals, 90),
            "p95": percentile(vals, 95),
            "p99": percentile(vals, 99),
            "max": float(vals.max()),
            "dropped": self.dropped,
        }


@dataclasses.dataclass
class _EngineSeries:
    """Per-engine stepping record: quantum count, tokens, step latency.

    Internal to :class:`DispatchMetrics`; mutated only under its lock."""

    steps: int = 0
    tokens: int = 0
    step_latency: LatencySeries = None

    def __post_init__(self) -> None:
        if self.step_latency is None:
            self.step_latency = LatencySeries("engine_step", window=8192)


class DispatchMetrics:
    """Aggregates per-request observations into a serving-level snapshot.

    Thread-safe: any number of stepper threads may feed
    :meth:`observe_request` / :meth:`on_engine_step` while submitters call
    :meth:`on_submit` / :meth:`on_reject` and monitors call
    :meth:`snapshot` — one internal lock serializes everything.  Per-engine
    stepping makes the per-model breakdown matter: the ``engines`` section
    of the snapshot shows each stepper's quantum count and step-latency
    distribution, so a slow tenant is visible as *its* p99, not a blur in
    the aggregate.
    """

    def __init__(self) -> None:
        self.ttft = LatencySeries("ttft")            # submit -> first token
        self.per_token = LatencySeries("per_token")  # decode time / token
        self.e2e = LatencySeries("e2e")              # submit -> done
        self.requests_done = 0
        self.tokens_out = 0
        self.rejected = 0                             # backpressure refusals
        self.truncated = 0           # finished early: context window filled
        self.failed = 0              # completed with error (never served)
        self._engines: dict = {}                      # model -> _EngineSeries
        self._dropped: set = set()                    # unregistered tombstones
        # quantum-grant latency: lane became grantable -> arbiter granted it
        # (the event-driven hand-off's figure of merit: under contention the
        # p95 must sit below the old 10 ms fallback tick)
        self.grant_latency = LatencySeries("grant", window=65536)
        self._grants = 0
        # per-grant CPU cost: arbiter time spent selecting + bookkeeping
        # per grant issued — the O(1)-grant-path figure of merit (must stay
        # flat as the registered-tenant count grows)
        self.grant_cost = LatencySeries("grant_cost", window=65536)
        # ready-set size samples (indexed ready set, recorded per granting
        # pump): how much of the fleet is actually contending
        self._ready_sizes = deque(maxlen=8192)
        self._ready_peak = 0
        self._ready_dropped = 0          # samples the bounded ring evicted
        # stepper-pool occupancy: busy-worker samples, recorded per grant
        # and — so idle periods appear at all — per fallback tick by the
        # arbiter's designated ticker
        self._pool_size = 0
        self._pool_busy = deque(maxlen=8192)
        self._pool_busy_peak = 0
        self._pool_busy_dropped = 0      # samples the bounded ring evicted
        # batch-composer series: shared cross-tenant decode steps — how
        # full the shared batch ran (slot occupancy), how often a step
        # actually served >1 tenant (coalesce rate), and each tenant's
        # token share of the composed traffic
        self._comp_steps = 0
        self._comp_coalesced = 0         # composed steps serving >= 2 lanes
        self._comp_capacity = 0
        self._comp_occ = deque(maxlen=8192)
        self._comp_occ_peak = 0
        self._comp_occ_dropped = 0
        self._comp_lane_tokens: dict = {}
        self.composed_step_latency = LatencySeries("composed_step", window=8192)
        # SLO / priority-class plane: per-class grant + e2e distributions
        # and the preemption / shed / admission / deadline counters that
        # make overload behavior per class observable (a priority scheme
        # you can't see is one you can't trust)
        self._lane_class: dict = {}          # lane -> priority class
        self._class_grant: dict = {}         # cls -> LatencySeries
        self._class_e2e: dict = {}           # cls -> LatencySeries
        self.preemptions = 0                 # grants not renewed for class
        self._preempt_by_class: dict = {}
        self.shed = 0                        # queued requests load-shed
        self._shed_by_class: dict = {}
        self.admission_rejected = 0          # AdmissionRejected at submit
        self._admission_by_class: dict = {}
        self._deadline_miss: dict = {}       # cls -> completions past target
        self._deadline_total: dict = {}      # cls -> completions with target
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self._mu = threading.Lock()

    def on_submit(self, t_submit: Optional[float] = None) -> None:
        """Record one accepted submission (its timestamp anchors wall time)."""
        t = time.perf_counter() if t_submit is None else t_submit
        with self._mu:
            if self._t_first_submit is None or t < self._t_first_submit:
                self._t_first_submit = t

    def on_reject(self) -> None:
        """Record one backpressure refusal."""
        with self._mu:
            self.rejected += 1

    def on_engine_step(
        self, model: str, seconds: float, *, tokens: int = 0
    ) -> None:
        """Record one engine stepping quantum for ``model``: its wall time
        and the tokens it produced.  Fed by ``Dispatcher.step_lane`` from
        whichever thread stepped the lane.  Tombstoned (unregistered)
        models are ignored — a straggler quantum racing the unregister
        must not resurrect the dropped series."""
        with self._mu:
            if model in self._dropped:
                return
            rec = self._engines.get(model)
            if rec is None:
                rec = self._engines[model] = _EngineSeries()
            rec.steps += 1
            rec.tokens += tokens
            rec.step_latency.record(seconds)

    def on_grant(self, seconds: float, *, lane: Optional[str] = None) -> None:
        """Record one quantum grant: ``seconds`` is the arbiter's reaction
        time — from the latest of the lane becoming ready, its executor
        (blocked stepper / idle pool worker) becoming free, and the last
        grant-enabling event the arbiter processed, to the grant.  Backlog
        behind busy executors and a policy's own rationing (stride holding
        for its top pick) are scheduling decisions, not hand-off delay,
        and are excluded.  Fed by the async layer's arbiter on every
        grant, in every arbitrated stepping mode.  When ``lane`` is given
        and carries a priority class (:meth:`set_lane_class`), the sample
        also lands in that class's grant series — the per-class tail the
        SLO plane is judged by."""
        with self._mu:
            self._grants += 1
            self.grant_latency.record(seconds)
            if lane is not None and lane in self._lane_class:
                cls = self._lane_class[lane]
                series = self._class_grant.get(cls)
                if series is None:
                    series = self._class_grant[cls] = LatencySeries(
                        f"grant_class_{cls}", window=65536
                    )
                series.record(seconds)

    def set_lane_class(self, lane: str, cls: int) -> None:
        """Bind ``lane`` to priority class ``cls`` so grant and e2e
        samples route into per-class series — called by the dispatcher at
        registration (:func:`drop_engine` unbinds)."""
        with self._mu:
            self._lane_class[lane] = int(cls)

    def on_preemption(self, cls: int, n: int = 1) -> None:
        """Count ``n`` quantum-boundary preemptions (grants not renewed)
        suffered by class ``cls`` lanes in favor of a higher class."""
        with self._mu:
            self.preemptions += n
            self._preempt_by_class[cls] = (
                self._preempt_by_class.get(cls, 0) + n
            )

    def on_shed(self, cls: int) -> None:
        """Count one queued class-``cls`` request load-shed because its
        deadline became unmeetable."""
        with self._mu:
            self.shed += 1
            self._shed_by_class[cls] = self._shed_by_class.get(cls, 0) + 1

    def on_admission_reject(self, cls: int) -> None:
        """Count one class-``cls`` submission refused at admission
        (``AdmissionRejected``: the deadline was provably unmeetable)."""
        with self._mu:
            self.admission_rejected += 1
            self._admission_by_class[cls] = (
                self._admission_by_class.get(cls, 0) + 1
            )

    def on_deadline(self, cls: int, missed: bool) -> None:
        """Record one completed class-``cls`` request that carried a
        latency target: ``missed`` says whether it finished past its
        deadline (the deadline-miss series is the ratio of these)."""
        with self._mu:
            self._deadline_total[cls] = self._deadline_total.get(cls, 0) + 1
            if missed:
                self._deadline_miss[cls] = (
                    self._deadline_miss.get(cls, 0) + 1
                )

    def on_grant_cost(self, seconds: float) -> None:
        """Record the arbiter CPU cost attributed to one grant: selection
        plus grant bookkeeping time, divided over the grants the pump
        issued.  This is the per-event cost the indexed grant path keeps
        O(active): flat as registered tenants grow, because neither the
        pump nor the policy walks the registry."""
        with self._mu:
            self.grant_cost.record(seconds)

    def on_ready_size(self, size: int) -> None:
        """Record one indexed-ready-set size sample (taken by the arbiter
        per granting pump): the number of lanes actually contending for
        quanta, as opposed to merely registered."""
        with self._mu:
            if len(self._ready_sizes) == self._ready_sizes.maxlen:
                self._ready_dropped += 1
            self._ready_sizes.append(int(size))
            if size > self._ready_peak:
                self._ready_peak = int(size)

    def drop_engine(self, model: str) -> None:
        """Forget ``model``'s per-engine series (the tenant was
        unregistered): a dead tenant must stop occupying snapshot space
        and per-engine walks forever.  The name is tombstoned so a
        straggler step racing the unregister cannot resurrect the entry
        (:meth:`on_engine_step` ignores tombstoned models);
        :meth:`track_engine` lifts the tombstone on re-registration."""
        with self._mu:
            self._engines.pop(model, None)
            self._comp_lane_tokens.pop(model, None)
            self._lane_class.pop(model, None)
            self._dropped.add(model)

    def track_engine(self, model: str) -> None:
        """(Re-)admit ``model`` to per-engine tracking, lifting any
        tombstone a previous :meth:`drop_engine` left — called by the
        dispatcher at registration so a reused tenant name records
        again."""
        with self._mu:
            self._dropped.discard(model)

    def on_pool_occupancy(self, busy: int, size: int) -> None:
        """Record one stepper-pool occupancy sample: ``busy`` of ``size``
        workers currently executing a granted quantum.  Sampled at each
        grant AND from the arbiter's designated ticker on every fallback
        tick expiry, so the series reflects wall-clock occupancy — an idle
        or parked pool shows up as zeros instead of freezing the series at
        whatever the last grant recorded."""
        with self._mu:
            self._pool_size = size
            if len(self._pool_busy) == self._pool_busy.maxlen:
                self._pool_busy_dropped += 1
            self._pool_busy.append(int(busy))
            if busy > self._pool_busy_peak:
                self._pool_busy_peak = int(busy)

    def on_composed_step(
        self,
        seconds: float,
        *,
        occupied: int,
        capacity: int,
        tokens_by_lane: Any,
    ) -> None:
        """Record one composed (cross-tenant batched) decode step: its wall
        time, how many of the shared batch's ``capacity`` slots were live
        (``occupied``), and the tokens each occupant lane's slots produced.
        Fed by ``Dispatcher.step_group``; the snapshot's ``composer``
        section derives slot occupancy, coalesce rate (fraction of
        composed steps that actually served ≥ 2 tenants), and per-tenant
        shares from these samples."""
        with self._mu:
            self._comp_steps += 1
            self._comp_capacity = capacity
            lanes_served = sum(1 for t in tokens_by_lane.values() if t > 0)
            if lanes_served >= 2:
                self._comp_coalesced += 1
            if len(self._comp_occ) == self._comp_occ.maxlen:
                self._comp_occ_dropped += 1
            self._comp_occ.append(int(occupied))
            if occupied > self._comp_occ_peak:
                self._comp_occ_peak = int(occupied)
            for lane, toks in tokens_by_lane.items():
                if toks and lane not in self._dropped:
                    self._comp_lane_tokens[lane] = (
                        self._comp_lane_tokens.get(lane, 0) + int(toks)
                    )
            self.composed_step_latency.record(seconds)

    def observe_request(self, req: Any) -> None:
        """Fold one finished request (serving ``Request`` timestamps) in,
        counting truncations (context window filled before
        ``max_new_tokens``) and failures (completed with ``error`` set)
        so neither outcome is invisible in the aggregate."""
        ntok = len(req.generated)
        with self._mu:
            self.requests_done += 1
            self.tokens_out += ntok
            if getattr(req, "truncated", False):
                self.truncated += 1
            if getattr(req, "error", None):
                self.failed += 1
            if req.t_first and req.t_submit:
                self.ttft.record(req.t_first - req.t_submit)
            if req.t_done and req.t_submit:
                self.e2e.record(req.t_done - req.t_submit)
                cls = self._lane_class.get(getattr(req, "model", None))
                if cls is not None:
                    series = self._class_e2e.get(cls)
                    if series is None:
                        series = self._class_e2e[cls] = LatencySeries(
                            f"e2e_class_{cls}"
                        )
                    series.record(req.t_done - req.t_submit)
                if ntok > 1 and req.t_first:
                    # decode tokens exclude the one produced by prefill
                    self.per_token.record(
                        (req.t_done - req.t_first) / (ntok - 1)
                    )
            if self._t_last_done is None or req.t_done > self._t_last_done:
                self._t_last_done = req.t_done

    def _wall_locked(self) -> float:
        if self._t_first_submit is None or self._t_last_done is None:
            return 0.0
        return max(0.0, self._t_last_done - self._t_first_submit)

    def _tokens_per_second_locked(self) -> float:
        wall = self._wall_locked()
        return self.tokens_out / wall if wall else 0.0

    def _requests_per_second_locked(self) -> float:
        wall = self._wall_locked()
        return self.requests_done / wall if wall else 0.0

    @property
    def wall_seconds(self) -> float:
        """First submit to last completion, in seconds (0.0 before both)."""
        with self._mu:
            return self._wall_locked()

    @property
    def tokens_per_second(self) -> float:
        """Aggregate decode+prefill token throughput over the wall window."""
        with self._mu:
            return self._tokens_per_second_locked()

    @property
    def requests_per_second(self) -> float:
        """Completed-request throughput over the wall window."""
        with self._mu:
            return self._requests_per_second_locked()

    def snapshot(self, cache_stats: Optional[dict] = None) -> dict:
        """One coherent dict of every aggregate this object tracks,
        including the per-engine ``engines`` breakdown."""
        with self._mu:
            snap = {
                "requests_done": self.requests_done,
                "tokens_out": self.tokens_out,
                "rejected": self.rejected,
                "truncated": self.truncated,
                "failed": self.failed,
                "wall_seconds": self._wall_locked(),
                "tokens_per_second": self._tokens_per_second_locked(),
                "requests_per_second": self._requests_per_second_locked(),
                "ttft_ms": self.ttft.summary_ms(),
                "per_token_ms": self.per_token.summary_ms(),
                "e2e_ms": self.e2e.summary_ms(),
                "grants": self._grants,
                "grant_ms": self.grant_latency.summary_ms(),
                "grant_cost_ms": self.grant_cost.summary_ms(),
                "ready_size": {
                    "mean": (
                        float(np.mean(np.asarray(self._ready_sizes)))
                        if self._ready_sizes else 0.0
                    ),
                    "peak": self._ready_peak,
                    "samples": len(self._ready_sizes),
                    "dropped": self._ready_dropped,
                },
                "engines": {
                    model: {
                        "steps": rec.steps,
                        "tokens": rec.tokens,
                        "step_ms": rec.step_latency.summary_ms(),
                    }
                    for model, rec in self._engines.items()
                },
            }
            snap["preemptions"] = self.preemptions
            snap["shed"] = self.shed
            snap["admission_rejected"] = self.admission_rejected
            if self._lane_class:
                all_classes = sorted(
                    set(self._lane_class.values())
                    | set(self._class_grant)
                    | set(self._class_e2e)
                    | set(self._preempt_by_class)
                    | set(self._shed_by_class)
                    | set(self._admission_by_class)
                    | set(self._deadline_total)
                )
                snap["classes"] = {
                    cls: {
                        "lanes": sorted(
                            l for l, c in self._lane_class.items()
                            if c == cls
                        ),
                        "grant_ms": (
                            self._class_grant[cls].summary_ms()
                            if cls in self._class_grant
                            else LatencySeries("empty").summary_ms()
                        ),
                        "e2e_ms": (
                            self._class_e2e[cls].summary_ms()
                            if cls in self._class_e2e
                            else LatencySeries("empty").summary_ms()
                        ),
                        "preemptions": self._preempt_by_class.get(cls, 0),
                        "shed": self._shed_by_class.get(cls, 0),
                        "admission_rejected": (
                            self._admission_by_class.get(cls, 0)
                        ),
                        "deadline_total": self._deadline_total.get(cls, 0),
                        "deadline_miss": self._deadline_miss.get(cls, 0),
                    }
                    for cls in all_classes
                }
            if self._comp_steps:
                occ = np.asarray(self._comp_occ, dtype=np.float64)
                total_tok = sum(self._comp_lane_tokens.values())
                snap["composer"] = {
                    "steps": self._comp_steps,
                    "coalesced_steps": self._comp_coalesced,
                    "coalesce_rate": self._comp_coalesced / self._comp_steps,
                    "capacity": self._comp_capacity,
                    "occupancy_mean": float(occ.mean()) if len(occ) else 0.0,
                    "occupancy_peak": self._comp_occ_peak,
                    "occupancy_dropped": self._comp_occ_dropped,
                    "step_ms": self.composed_step_latency.summary_ms(),
                    "lane_tokens": dict(self._comp_lane_tokens),
                    "lane_share": {
                        lane: toks / total_tok
                        for lane, toks in self._comp_lane_tokens.items()
                    } if total_tok else {},
                }
            if self._pool_size:
                busy = np.asarray(self._pool_busy, dtype=np.float64)
                snap["pool"] = {
                    "size": self._pool_size,
                    "busy_mean": float(busy.mean()) if len(busy) else 0.0,
                    "busy_peak": self._pool_busy_peak,
                    "samples": int(len(busy)),
                    "dropped": self._pool_busy_dropped,
                }
        if cache_stats is not None:
            snap["schedule_cache"] = dict(cache_stats)
        return snap
