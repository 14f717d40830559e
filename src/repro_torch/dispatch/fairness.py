"""Fairness policies: who gets the next scheduling quantum.

The dispatcher's serving loop is a sequence of *quanta*: each
``Dispatcher.step()`` asks its policy which lanes (models) to serve and in
what order, serves them, then reports what each lane consumed.  The policy
is the only place scheduling preference lives — engines and the dispatcher
itself stay policy-free, which is what lets the same implementations back
both the synchronous ``Dispatcher`` and the threaded ``AsyncDispatcher``.

Six implementations:

* :class:`RoundRobinFairness` — serve every active lane each quantum,
  rotating which goes first (the original ``Dispatcher`` behavior);
* :class:`WeightedFairness` — stride scheduling (weighted fair queueing):
  one lane per quantum, the one with the smallest virtual *pass*; a lane of
  weight ``w`` advances its pass by ``1/w`` per quantum served, so under
  saturation lane shares converge to the weight ratio (a 3:1 lane gets ~3×
  the decode steps) while no active lane is ever starved — the pass gap is
  bounded by ``ceil(W/w) + n`` quanta.  Exact, but serial by construction:
  one lane per quantum;
* :class:`DeficitRoundRobinFairness` — weighted **deficit round-robin**:
  each active lane accrues ``weight`` step-credits per refill round and
  every funded lane is grantable *at once*, so proportional shares finally
  compose with ``max_concurrent_steps > 1`` and multi-worker overlap (a
  3:1 pair realizes ~3:1 decode quanta while both lanes step
  concurrently) — the concurrent counterpart to stride's exact-but-serial
  schedule;
* :class:`LotteryFairness` — lottery scheduling: each quantum draws one
  winner with probability proportional to weight.  Shares converge to the
  weight ratio only in expectation, but selection is O(active) with no
  per-lane bookkeeping and no hold semantics — the cheap secondary when
  probabilistic shares are enough;
* :class:`QuotaFairness` — token-rate quotas: each lane owns a token bucket
  refilled by ``rate`` tokens **per wall-clock second** (monotonic clock)
  up to ``burst``; lanes with credit are served richest-first and debited
  what they produce.  Work-conserving by default (if nobody has credit, the
  least-indebted lane still runs);
* :class:`ClassedFairness` — strict priority classes
  (``register_model(priority_class=...)``, lower = more important)
  composing any of the above *within* each class: the most important
  class with eligible lanes takes every quantum, which realizes
  quantum-granularity preemption as grant **non-renewal** — see
  ``repro_torch.dispatch.slo`` for the admission/SLO half of that plane.

Policies are NOT internally locked: the owning dispatcher serializes all
calls (``Dispatcher._fair_mu`` — one dedicated mutex, shared with the
async layer's quantum arbiter).  Mutating a policy from two dispatchers at
once is a usage error.  Because per-engine steppers may call ``select``
at an uneven cadence, policies must not treat "one select call" as a unit
of time — which is exactly why :class:`QuotaFairness` refills from the
wall clock rather than per quantum.
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable, Mapping, Optional, Sequence, Union

_MIN_WEIGHT = 1e-6      # stride floor: weight 0 means "background", not "never"


class FairnessPolicy:
    """Decides the service order of lanes, one scheduling quantum at a time."""

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane`` to the schedule (called once per model).

        ``priority_class`` is part of the registration protocol so the
        dispatcher can pass it unconditionally; only
        :class:`ClassedFairness` acts on it — the single-class policies
        ignore it (every lane is one flat class to them).
        """
        raise NotImplementedError

    def unregister(self, lane: str) -> None:
        """Forget ``lane`` entirely: drop its weight, credit, and service
        counters so a retired tenant stops costing every later ``select``
        walk (``Dispatcher.unregister_model`` calls this after draining
        the lane).  Unknown lanes are ignored — unregister is idempotent.
        """

    def select(self, active: Sequence[str]) -> list[str]:
        """Lanes to serve this quantum, in order.

        ``active`` holds the lanes that currently have work (queued requests
        or live slots), in registration order.  The result is a subset of
        ``active``; lanes not returned are skipped this quantum.
        """
        raise NotImplementedError

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Account actual consumption after ``lane`` was served.

        ``steps`` may be fractional: a composed (cross-tenant batched)
        decode step is ONE device step shared by several lanes, and
        :meth:`charge_composed` splits it by slot share — charging every
        tenant a whole step for a shared step would bill the group N×
        the hardware it used."""

    def charge_composed(
        self, tokens_by_lane: Mapping[str, int], *, steps: float = 1.0
    ) -> None:
        """Account one shared (composed) step across its occupant lanes.

        ``tokens_by_lane`` maps each lane to the tokens its slots produced
        in the shared step; ``steps`` is the device-step cost of the whole
        composed quantum (normally 1).  The default splits ``steps``
        proportionally to each lane's token share — a tenant occupying 3
        of 4 live slots pays 3/4 of the step — and delegates to
        :meth:`charge` per lane, so every policy's existing accounting
        (stride passes, DRR deficits, quota debits) prices shared steps
        correctly without policy-specific code."""
        total = sum(tokens_by_lane.values())
        for lane, toks in tokens_by_lane.items():
            if total > 0:
                share = toks / total
            else:
                share = 1.0 / max(len(tokens_by_lane), 1)
            self.charge(lane, steps=steps * share, tokens=toks)

    def peek_ready(self, active: Sequence[str], ready: Sequence[str]) -> list[str]:
        """Grantable lanes for an event-driven arbiter, in policy order.

        ``active`` is the TRUE active set (every lane with work — executing,
        waiting, or mid-bookkeeping); ``ready`` is the subset a grant could
        reach *right now* (a stepper or pool worker is free to serve it).
        The policy sees ``active`` so its internal state stays exactly what
        the synchronous loop would build, but the result is restricted to
        ``ready`` — and when the policy's top pick is active-but-not-ready,
        returning ``[]`` tells the arbiter to HOLD the quantum for it
        rather than hand it to a less-deserving lane (this is what keeps
        stride ratios exact).  The default filters :meth:`select`'s picks,
        which preserves each policy's semantics: round-robin/quota serve
        every eligible ready lane, stride serves its top pick or holds.
        """
        ready_set = set(ready)
        return [lane for lane in self.select(active) if lane in ready_set]

    def snapshot(self) -> dict:
        """Policy state for metrics/debugging (plain dict)."""
        return {"policy": type(self).__name__}


class RoundRobinFairness(FairnessPolicy):
    """Serve every active lane each quantum; the head rotates per quantum."""

    def __init__(self) -> None:
        self._turn = 0
        self._served: dict[str, int] = {}

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane``; round-robin ignores weights and classes."""
        self._served[lane] = 0

    def unregister(self, lane: str) -> None:
        """Drop ``lane``'s served-quantum counter."""
        self._served.pop(lane, None)

    def select(self, active: Sequence[str]) -> list[str]:
        """All active lanes, head rotated by one position per quantum."""
        if not active:
            return []
        k = self._turn % len(active)
        self._turn += 1
        return list(active[k:]) + list(active[:k])

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Count served quanta (rotation itself needs no accounting).
        Unknown lanes are ignored — a straggler step racing an unregister
        must not resurrect the lane's counters."""
        if lane in self._served:
            self._served[lane] += steps

    def snapshot(self) -> dict:
        """Per-lane served-quantum counts."""
        return {"policy": "round_robin", "served_steps": dict(self._served)}


class WeightedFairness(FairnessPolicy):
    """Stride scheduling: one lane per quantum, smallest virtual pass first.

    ``weights`` presets per-lane weights by name; ``register(weight=...)``
    covers lanes not preset.  Weights must be ≥ 0 and normalize over the
    registered set (all-zero → uniform); a zero weight is clamped to a tiny
    stride floor so the lane still progresses (starvation-freedom).
    """

    def __init__(self, weights: Optional[Mapping[str, float]] = None) -> None:
        self._preset = dict(weights or {})
        self._order: list[str] = []
        self._weight: dict[str, float] = {}
        self._pass: dict[str, float] = {}
        self._served: dict[str, int] = {}
        self._last_active: frozenset = frozenset()

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane`` at ``weight`` (preset mapping wins if present;
        ``priority_class`` is ignored — stride is single-class)."""
        w = float(self._preset.get(lane, weight))
        if w < 0:
            raise ValueError(f"weight must be >= 0, got {w} for {lane!r}")
        self._order.append(lane)
        self._weight[lane] = w
        self._pass[lane] = 0.0
        self._served[lane] = 0

    def unregister(self, lane: str) -> None:
        """Drop ``lane``'s weight, virtual pass, and counters."""
        if lane in self._weight:
            self._order.remove(lane)
        self._weight.pop(lane, None)
        self._pass.pop(lane, None)
        self._served.pop(lane, None)
        self._last_active = self._last_active - {lane}

    def normalized(self) -> dict[str, float]:
        """Weights normalized to sum 1 (uniform when all weights are 0)."""
        total = sum(self._weight.values())
        if total <= 0:
            n = len(self._weight)
            return {lane: 1.0 / n for lane in self._weight} if n else {}
        return {lane: w / total for lane, w in self._weight.items()}

    def _stride(self, lane: str) -> float:
        return 1.0 / max(self._weight[lane], _MIN_WEIGHT)

    def select(self, active: Sequence[str]) -> list[str]:
        """The single active lane with the smallest virtual pass (ties
        break by registration order)."""
        if not active:
            self._last_active = frozenset()
            return []
        # a lane re-joining after idleness must not burst through its backlog
        # of unspent quanta: lift its pass to the continuing lanes' floor
        continuing = [l for l in active if l in self._last_active]
        if continuing and len(continuing) < len(active):
            floor = min(self._pass[l] for l in continuing)
            for lane in active:
                if lane not in self._last_active:
                    self._pass[lane] = max(self._pass[lane], floor)
        self._last_active = frozenset(active)
        rank = {lane: i for i, lane in enumerate(self._order)}
        return [min(active, key=lambda l: (self._pass[l], rank[l]))]

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Advance ``lane``'s pass by ``steps``/weight (stride update).
        Unknown lanes (a straggler step racing an unregister) are
        ignored."""
        if lane not in self._pass:
            return
        self._pass[lane] += steps * self._stride(lane)
        self._served[lane] = self._served.get(lane, 0) + steps

    def snapshot(self) -> dict:
        """Normalized weights, served quanta, and virtual passes."""
        return {
            "policy": "weighted",
            "weights": self.normalized(),
            "served_steps": dict(self._served),
            "virtual_pass": dict(self._pass),
        }


class QuotaFairness(FairnessPolicy):
    """Token-rate quotas refilled from the wall clock: each lane's bucket
    gains ``rate`` tokens per elapsed **second** (monotonic clock, capped
    at ``burst``); serving debits tokens actually produced.

    Refill is time-based, not per-quantum: two ``select`` calls a
    microsecond apart grant ~nothing, a call after a long idle gap grants
    up to one full ``burst`` — so a lane's realized token rate tracks its
    configured quota regardless of how often the dispatcher (or each
    per-engine stepper) happens to ask.  ``clock`` is injectable for
    deterministic tests; it must be monotonic and is read only inside
    ``select``, under the owning dispatcher's fairness lock.

    ``work_conserving=True`` (default) never idles hardware: when no lane
    has credit, the least-indebted active lane runs anyway.  With it off,
    ``select`` may return nothing — callers see an idle quantum, and a
    drain over a permanently-broke lane raises ``DrainTimeoutError``
    instead of looping forever.
    """

    def __init__(
        self,
        rate: float = 8.0,
        burst: float = 64.0,
        *,
        rates: Optional[Mapping[str, float]] = None,
        work_conserving: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, got {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._rates = dict(rates or {})
        self.work_conserving = work_conserving
        self._clock = clock
        self._last_refill: Optional[float] = None
        self._budget: dict[str, float] = {}
        self._rate_of: dict[str, float] = {}
        self._served: dict[str, int] = {}
        self._tokens: dict[str, int] = {}

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane`` with a full burst of credit.  ``weight`` scales
        the base refill rate, so ``register_model(weight=3)`` means the
        same thing under quota as under weighted fairness
        (``priority_class`` is ignored — quota is single-class)."""
        rate = float(self._rates.get(lane, self.rate * max(weight, 0.0)))
        self._rate_of[lane] = rate
        self._budget[lane] = self.burst
        self._served[lane] = 0
        self._tokens[lane] = 0

    def unregister(self, lane: str) -> None:
        """Drop ``lane``'s bucket, refill rate, and service totals."""
        self._budget.pop(lane, None)
        self._rate_of.pop(lane, None)
        self._served.pop(lane, None)
        self._tokens.pop(lane, None)

    def _refill(self) -> None:
        now = self._clock()
        if self._last_refill is None:
            self._last_refill = now
            return
        dt = now - self._last_refill
        if dt <= 0:
            return
        self._last_refill = now
        for lane, rate in self._rate_of.items():
            self._budget[lane] = min(self.burst, self._budget[lane] + rate * dt)

    def select(self, active: Sequence[str]) -> list[str]:
        """Refill every bucket from the elapsed wall time, then serve
        funded lanes richest-first (or the least-indebted lane when
        work-conserving and everyone is broke)."""
        if not active:
            return []
        self._refill()
        funded = [l for l in active if self._budget[l] > 0]
        if funded:
            return sorted(funded, key=lambda l: -self._budget[l])
        if self.work_conserving:
            return [max(active, key=lambda l: self._budget[l])]
        return []

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Debit ``lane``'s bucket by the tokens it actually produced.
        Unknown lanes (a straggler step racing an unregister) are
        ignored."""
        if lane not in self._budget:
            return
        self._budget[lane] -= tokens
        self._served[lane] = self._served.get(lane, 0) + steps
        self._tokens[lane] = self._tokens.get(lane, 0) + tokens

    def snapshot(self) -> dict:
        """Budgets, refill rates, and service totals per lane."""
        return {
            "policy": "quota",
            "budget": dict(self._budget),
            "rate_per_s": dict(self._rate_of),
            "served_steps": dict(self._served),
            "served_tokens": dict(self._tokens),
        }


class DeficitRoundRobinFairness(FairnessPolicy):
    """Weighted deficit round-robin: every funded lane is grantable at once.

    Each lane carries a *deficit counter* of step-credits.  When no ready
    lane can afford a quantum (cost 1), every **active** lane is refilled
    by ``weight × quantum`` credits in one batch (several rounds at once if
    small weights need them), and every lane whose counter covers a step is
    returned — in registration-ring order — as grantable **simultaneously**.
    Serving debits one credit per quantum (:meth:`charge`).

    This is the concurrency-compatible counterpart to stride scheduling:
    stride's one-lane-per-quantum rationing keeps ratios exact but
    serializes decode; DRR's per-round credit batching keeps the same
    proportional shares over any window of full rounds (a 3:1 pair
    realizes 3:1 quanta) while an arbiter may grant all funded lanes to
    different workers in the same pump.  The round is also the starvation
    bound: a lane that spent its quantum waits at most the rest of the
    round (the largest weight's worth of steps) before the next refill
    funds it again.  Deficits are zeroed when a lane leaves the active set
    (a returning idler must not burst through banked credit) and capped at
    one round plus one quantum of carry, the classic DRR bound.
    """

    _CARRY = 1.0        # max credit carried past a round (DRR packet bound)

    def __init__(
        self,
        weights: Optional[Mapping[str, float]] = None,
        quantum: float = 1.0,
    ) -> None:
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self._preset = dict(weights or {})
        self._quantum = float(quantum)
        self._order: list[str] = []
        self._weight: dict[str, float] = {}
        self._deficit: dict[str, float] = {}
        self._served: dict[str, int] = {}
        self._rounds = 0
        self._last_active: frozenset = frozenset()

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane`` at ``weight`` (preset mapping wins if present;
        ``priority_class`` is ignored — DRR is single-class)."""
        w = float(self._preset.get(lane, weight))
        if w < 0:
            raise ValueError(f"weight must be >= 0, got {w} for {lane!r}")
        self._order.append(lane)
        self._weight[lane] = w
        self._deficit[lane] = 0.0
        self._served[lane] = 0

    def unregister(self, lane: str) -> None:
        """Drop ``lane``'s weight, deficit, and counters."""
        if lane in self._weight:
            self._order.remove(lane)
        self._weight.pop(lane, None)
        self._deficit.pop(lane, None)
        self._served.pop(lane, None)
        self._last_active = self._last_active - {lane}

    def _refill_share(self, lane: str) -> float:
        return max(self._weight[lane], _MIN_WEIGHT) * self._quantum

    def _refill(self, active: Sequence[str], ready: Sequence[str]) -> None:
        # batch as many rounds as the richest ready lane needs to afford
        # one quantum, so a tiny-weight lane costs O(1) arithmetic instead
        # of O(1/weight) refill iterations
        rounds = min(
            math.ceil(max(0.0, 1.0 - self._deficit[l]) / self._refill_share(l))
            for l in ready
        )
        rounds = max(1, rounds)
        self._rounds += rounds
        for lane in active:
            share = self._refill_share(lane)
            cap = share + self._CARRY
            self._deficit[lane] = min(
                cap, self._deficit[lane] + rounds * share
            )

    def _sync_active(self, active: Sequence[str]) -> None:
        # a lane re-joining after idleness starts from zero credit: banked
        # deficit from a stale round must not turn into a burst
        for lane in active:
            if lane not in self._last_active:
                self._deficit[lane] = 0.0
        self._last_active = frozenset(active)

    def select(self, active: Sequence[str]) -> list[str]:
        """Every funded active lane, ring order (refilling if none is)."""
        return self.peek_ready(active, active)

    def peek_ready(self, active: Sequence[str], ready: Sequence[str]) -> list[str]:
        """Funded ready lanes, in ring order, all grantable concurrently.

        The round is the proportionality unit: a new refill lands only
        when **no active lane** holds a step of credit — a lane that spent
        its quantum waits out the rest of the round (bounded by the
        largest weight's worth of steps), which is exactly what keeps the
        realized shares at the weight ratio even though funded lanes are
        granted concurrently.  Returning ``[]`` with a round in progress
        tells the arbiter to hold until the funded (executing) lanes
        release and either spend or finish the round.
        """
        # unknown lanes (a contender racing its own (un)registration) are
        # filtered, never resurrected into the deficit table
        active = [l for l in active if l in self._weight]
        ready = [l for l in ready if l in self._weight]
        if not active:
            self._last_active = frozenset()
            return []
        self._sync_active(active)
        if not ready:
            return []
        funded = [l for l in ready if self._deficit[l] >= 1.0]
        if not funded:
            if any(self._deficit[l] >= 1.0 for l in active):
                return []          # round in progress: hold for its owners
            self._refill(active, ready)
            funded = [l for l in ready if self._deficit[l] >= 1.0]
        rank = {lane: i for i, lane in enumerate(self._order)}
        return sorted(funded, key=lambda l: rank[l])

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Debit ``lane``'s deficit one credit per served quantum.
        Unknown lanes (a straggler step racing an unregister) are
        ignored."""
        if lane not in self._deficit:
            return
        self._deficit[lane] -= float(steps)
        self._served[lane] = self._served.get(lane, 0) + steps

    def snapshot(self) -> dict:
        """Weights, live deficits, refill rounds, and served quanta."""
        return {
            "policy": "drr",
            "weights": dict(self._weight),
            "deficit": dict(self._deficit),
            "rounds": self._rounds,
            "served_steps": dict(self._served),
        }


class LotteryFairness(FairnessPolicy):
    """Lottery scheduling: one weighted random winner per quantum.

    Each quantum holds a lottery over the eligible lanes with tickets
    proportional to weight; shares converge to the weight ratio in
    expectation with no per-lane credit state at all — the cheap
    probabilistic secondary to :class:`DeficitRoundRobinFairness`.
    ``seed`` makes the draw sequence reproducible (tests, benchmarks).
    :meth:`peek_ready` draws over the *ready* subset directly — lottery
    has no hold semantics, so an executing lane's tickets are simply out
    of this draw.
    """

    def __init__(
        self,
        weights: Optional[Mapping[str, float]] = None,
        seed: int = 0,
    ) -> None:
        self._preset = dict(weights or {})
        self._rng = random.Random(seed)
        self._weight: dict[str, float] = {}
        self._served: dict[str, int] = {}

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane`` with ``weight`` tickets (preset mapping wins;
        ``priority_class`` is ignored — lottery is single-class)."""
        w = float(self._preset.get(lane, weight))
        if w < 0:
            raise ValueError(f"weight must be >= 0, got {w} for {lane!r}")
        self._weight[lane] = w
        self._served[lane] = 0

    def unregister(self, lane: str) -> None:
        """Drop ``lane``'s tickets and counters."""
        self._weight.pop(lane, None)
        self._served.pop(lane, None)

    def _draw(self, lanes: Sequence[str]) -> list[str]:
        tickets = [max(self._weight.get(l, 1.0), _MIN_WEIGHT) for l in lanes]
        return [self._rng.choices(list(lanes), weights=tickets, k=1)[0]]

    def select(self, active: Sequence[str]) -> list[str]:
        """One weighted-random winner among the active lanes."""
        if not active:
            return []
        return self._draw(active)

    def peek_ready(self, active: Sequence[str], ready: Sequence[str]) -> list[str]:
        """One weighted-random winner among the *ready* lanes (no hold)."""
        if not ready:
            return []
        return self._draw(ready)

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Count served quanta (the lottery itself is stateless).
        Unknown lanes (a straggler step racing an unregister) are
        ignored."""
        if lane in self._served:
            self._served[lane] += steps

    def snapshot(self) -> dict:
        """Ticket weights and served quanta."""
        return {
            "policy": "lottery",
            "weights": dict(self._weight),
            "served_steps": dict(self._served),
        }


class ClassedFairness(FairnessPolicy):
    """Strict priority classes composed over per-class inner policies.

    Lanes register with a ``priority_class`` (**lower is more
    important**: class 0 is interactive, class 1+ batch tiers).  Each
    class owns its own inner fairness policy built from ``inner`` (any
    :data:`FairnessSpec` — ``"drr"``, ``"weighted"``, ``"lottery"``, a
    policy instance used as a template, ...), so weights and shares keep
    their meaning *within* a class while classes themselves are ordered
    strictly: a grant decision looks only at the most important class
    that has eligible lanes and delegates to that class's inner policy.

    This is what makes preemption quantum-granular and free: the
    dispatcher/arbiter consult the policy at every quantum boundary, so
    when a higher-class lane goes ready, the lower-class lane that held
    the last grant simply is **not renewed** — its in-flight device step
    always completes untouched (tokens stay identical to the sync
    reference), it just doesn't get the next quantum.  Each such
    displacement (a previously-granted lane passed over, while still
    having work, for a more important class) is counted; the dispatcher
    drains the events via :meth:`drain_preempted` into per-class metrics.

    Holds compose: when the top ready class's inner policy returns ``[]``
    (e.g. DRR holding for its round owners), the whole policy holds —
    lower classes do NOT leak through, which is exactly the strictness
    that keeps the interactive class's grant tail tight under overload.
    Work conservation across classes still holds where it matters: a
    class with no *ready* lanes (all executing) never blocks the classes
    below it.
    """

    def __init__(self, inner: "FairnessSpec" = None) -> None:
        self._spec = inner
        self._inner: dict[int, FairnessPolicy] = {}
        self._class_of: dict[str, int] = {}
        self._held: set = set()              # lanes picked by the last grant
        self._pending_preempted: list = []   # (lane, cls) since last drain
        self.preemptions = 0
        self._preempted_by_class: dict[int, int] = {}

    def _make_inner(self) -> FairnessPolicy:
        # a policy INSTANCE as spec is a template, not a shared schedule:
        # each class gets a fresh policy of the same type
        spec = self._spec
        if isinstance(spec, FairnessPolicy):
            return type(spec)()
        return make_fairness(spec)

    @classmethod
    def adopt(
        cls,
        policy: FairnessPolicy,
        spec: "FairnessSpec",
        lanes: Sequence[str],
    ) -> "ClassedFairness":
        """Wrap a live single-class ``policy`` as class 0 of a new
        classed schedule, carrying its accumulated state (passes,
        deficits, counters) so the upgrade is invisible to the lanes
        already registered.  ``spec`` seeds the inner policies of any
        further classes; ``lanes`` are the already-registered lane names
        (all class 0).  This is how the dispatcher upgrades lazily: the
        first ``register_model(priority_class=1)`` adopts, earlier
        tenants keep their schedule."""
        out = cls(inner=spec)
        out._inner[0] = policy
        for lane in lanes:
            out._class_of[lane] = 0
        return out

    def register(
        self, lane: str, *, weight: float = 1.0, priority_class: int = 0
    ) -> None:
        """Admit ``lane`` at ``weight`` inside class ``priority_class``
        (lower = more important), creating that class's inner policy on
        first use."""
        if priority_class < 0:
            raise ValueError(
                f"priority_class must be >= 0, got {priority_class}"
            )
        cls_id = int(priority_class)
        inner = self._inner.get(cls_id)
        if inner is None:
            inner = self._inner[cls_id] = self._make_inner()
        self._class_of[lane] = cls_id
        inner.register(lane, weight=weight)

    def unregister(self, lane: str) -> None:
        """Scrub ``lane`` from its class's inner policy AND from the
        preemption bookkeeping (held-grant set, undrained displacement
        events) — a retired tenant that was granted-then-not-renewed must
        not linger anywhere."""
        cls_id = self._class_of.pop(lane, None)
        self._held.discard(lane)
        if self._pending_preempted:
            self._pending_preempted = [
                ev for ev in self._pending_preempted if ev[0] != lane
            ]
        if cls_id is not None:
            inner = self._inner.get(cls_id)
            if inner is not None:
                inner.unregister(lane)

    def _split_top(self, lanes: Sequence[str]):
        # (top class id, lanes of that class) among the known subset
        known = [l for l in lanes if l in self._class_of]
        if not known:
            return None, []
        top = min(self._class_of[l] for l in known)
        return top, [l for l in known if self._class_of[l] == top]

    def _note_grant(self, picks: Sequence[str], candidates: Sequence[str], top: int) -> None:
        # displacement = a lane we granted last time, still wanting work,
        # passed over because a more important class took the quantum
        if not picks:
            return
        cand = set(candidates)
        for lane in self._held:
            if lane in cand and self._class_of.get(lane, top) > top:
                cls_id = self._class_of[lane]
                self._pending_preempted.append((lane, cls_id))
                self.preemptions += 1
                self._preempted_by_class[cls_id] = (
                    self._preempted_by_class.get(cls_id, 0) + 1
                )
        self._held = set(picks)

    def select(self, active: Sequence[str]) -> list[str]:
        """Serve the most important class with active lanes, delegating
        the order within it to that class's inner policy."""
        top, subset = self._split_top(active)
        if top is None:
            return []
        picks = self._inner[top].select(subset)
        self._note_grant(picks, [l for l in active if l in self._class_of], top)
        return picks

    def peek_ready(self, active: Sequence[str], ready: Sequence[str]) -> list[str]:
        """Grantable lanes: the most important class with **ready** lanes
        wins the quantum; its inner policy picks (and may hold) within
        the class.  A class whose lanes are all executing does not block
        the classes below it — but a top class whose inner policy holds
        does, which is the strict-priority contract."""
        top, ready_top = self._split_top(ready)
        if top is None:
            return []
        active_top = [
            l for l in active if self._class_of.get(l) == top
        ]
        picks = self._inner[top].peek_ready(active_top, ready_top)
        self._note_grant(picks, [l for l in ready if l in self._class_of], top)
        return picks

    def charge(self, lane: str, *, steps: float = 1, tokens: int = 0) -> None:
        """Route consumption accounting to ``lane``'s class's inner
        policy (unknown lanes — stragglers racing an unregister — are
        ignored, matching every single-class policy)."""
        cls_id = self._class_of.get(lane)
        if cls_id is None:
            return
        inner = self._inner.get(cls_id)
        if inner is not None:
            inner.charge(lane, steps=steps, tokens=tokens)

    def drain_preempted(self) -> list:
        """Return and clear the ``(lane, priority_class)`` displacement
        events recorded since the last drain — the dispatcher forwards
        them to per-class preemption counters outside the fairness lock.
        """
        out = self._pending_preempted
        self._pending_preempted = []
        return out

    def lane_class(self, lane: str) -> int:
        """``lane``'s priority class (0 when unknown)."""
        return self._class_of.get(lane, 0)

    def snapshot(self) -> dict:
        """Per-class inner snapshots plus the preemption counters and a
        merged ``served_steps`` view across classes."""
        served: dict = {}
        classes = {}
        for cls_id, inner in sorted(self._inner.items()):
            snap = inner.snapshot()
            classes[cls_id] = snap
            served.update(snap.get("served_steps", {}))
        return {
            "policy": "priority",
            "class_of": dict(self._class_of),
            "classes": classes,
            "preemptions": self.preemptions,
            "preempted_by_class": dict(self._preempted_by_class),
            "served_steps": served,
        }


FairnessSpec = Union[FairnessPolicy, str, Mapping[str, float], None]

#: Registered spec keywords -> policy class.  ``tools/check_docs.py``
#: cross-checks every key here against the :func:`make_fairness` docstring
#: and DESIGN.md, so adding a policy without documenting it fails CI.
FAIRNESS_POLICIES: dict = {
    "round_robin": RoundRobinFairness,
    "weighted": WeightedFairness,
    "quota": QuotaFairness,
    "drr": DeficitRoundRobinFairness,
    "lottery": LotteryFairness,
    "priority": ClassedFairness,
}


def make_fairness(spec: FairnessSpec) -> FairnessPolicy:
    """Coerce user-facing specs into a policy.

    ``None`` / ``"round_robin"`` → rotation; ``"weighted"`` → stride
    scheduling (weights from ``register``); a ``{lane: weight}`` mapping →
    stride scheduling with preset weights; ``"drr[:QUANTUM]"`` → weighted
    deficit round-robin (concurrent proportional shares, QUANTUM credits
    per weight unit per round); ``"lottery[:SEED]"`` → lottery scheduling
    (probabilistic shares, reproducible under SEED);
    ``"quota[:RATE[:BURST]]"`` → token-rate quotas (RATE tokens per
    wall-clock second, BURST cap); ``"priority[:INNER]"`` → strict
    priority classes (``register_model(priority_class=...)``, lower =
    more important) composing an INNER policy spec per class — e.g.
    ``"priority:drr"`` is strict classes with weighted deficit
    round-robin within each class (INNER defaults to round-robin and may
    itself carry arguments: ``"priority:drr:0.5"``).
    """
    if spec is None:
        return RoundRobinFairness()
    if isinstance(spec, FairnessPolicy):
        return spec
    if isinstance(spec, Mapping):
        return WeightedFairness(weights=spec)
    if isinstance(spec, str):
        name, _, rest = spec.partition(":")
        if name == "round_robin":
            return RoundRobinFairness()
        if name == "weighted":
            return WeightedFairness()
        if name == "drr":
            return DeficitRoundRobinFairness(
                quantum=float(rest) if rest else 1.0
            )
        if name == "lottery":
            return LotteryFairness(seed=int(rest) if rest else 0)
        if name == "quota":
            if rest:
                rate, _, burst = rest.partition(":")
                return QuotaFairness(float(rate), float(burst or 64.0))
            return QuotaFairness()
        if name == "priority":
            return ClassedFairness(inner=rest or None)
        raise ValueError(f"unknown fairness policy {spec!r}")
    raise TypeError(f"cannot build a fairness policy from {spec!r}")
