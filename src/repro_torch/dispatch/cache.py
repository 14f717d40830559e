"""Schedule cache: amortize the AoT pre-run across tenants and requests.

The port's copy of the JAX package's ``dispatch/cache.py``.  It caches what
the serving engine seals (a captured CUDA graph on the card, an eager
callable on the CPU) and, through ``get_or_schedule``, the ``TaskSchedule``
that ``Nimble`` seals.

Nimble (paper §4.1) pays the pre-run once per (function, shape) and replays
forever after.  Under multi-tenant traffic the same (function, shape)
arrives from many callers, so the sealed step must live in a shared,
bounded cache:

* keyed by :class:`~repro_torch.core.aot.ScheduleKey` — (fn identity, flattened
  arg shapes/dtypes, scheduler options) — the exact reuse condition of a
  shape-specialized executable;
* LRU-bounded (sealed executables hold device code and reserved arenas;
  unbounded growth is a memory leak under shape churn);
* optionally **byte-budgeted**: each entry carries the ``arena_bytes`` its
  sealed schedule statically reserves, and a configured ``byte_budget``
  caps the sum — LRU entries are evicted until the total fits, so the
  reserved-arena footprint of the cache never exceeds the budget.  The
  bytes come from the caller's ``arena_bytes=`` (the serving engine
  derives them from its buffer shapes) or a ``TaskSchedule``'s
  ``stats.arena_bytes``; the entry-count ``capacity`` stays as a fallback
  ceiling for artifacts that report 0;
* build-coalescing: concurrent callers that miss on the same key wait on one
  per-key build lock, so a pre-run is never duplicated;
* optionally **budget-pooled**: a :class:`MemoryBudget` shared by several
  caches bounds their *summed* executable bytes process-wide (and, under
  the worker plane, per worker process — each worker reports its budget
  up to the parent).  When the pool overflows, the globally
  least-recently-touched cache evicts one LRU entry at a time until the
  total fits; per-cache ``byte_budget`` limits still apply on top.

Thread-safety contract: every public method is safe from any thread.  One
internal lock guards the entry map and stats; builds run *outside* it (so
different keys compile in parallel) under per-key locks.  A failed build
leaves its key retryable: the next caller (still coalescing on the same
per-key lock) performs a fresh build.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from repro_torch.core.aot import AoTScheduler, ScheduleKey, TaskSchedule
from repro_torch.obs.tracer import get_tracer


@dataclasses.dataclass
class CacheStats:
    """Counters for one :class:`ScheduleCache`.

    Only mutated under the owning cache's lock; reading a snapshot through
    :meth:`as_dict` (or ``ScheduleCache.snapshot``) is safe from any thread.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_evicted: int = 0        # arena bytes released by evictions
    builds: int = 0               # actual pre-runs (== misses that compiled)
    build_seconds: float = 0.0    # total time spent inside builders
    # builds attributed to the thread that ran them (ident -> count): lets a
    # stepping thread prove it never compiled (AsyncDispatcher's §4.3
    # invariant) without guessing from racy before/after deltas
    builds_by_thread: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served from cache (0.0 before any lookup)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        """Plain-dict view for metrics snapshots and JSON dumps."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "bytes_evicted": self.bytes_evicted,
            "builds": self.builds,
            "build_seconds": self.build_seconds,
            "hit_rate": self.hit_rate,
        }


@dataclasses.dataclass
class _Entry:
    value: Any
    pin: Any = None               # keeps fn objects alive while cached, so
    build_seconds: float = 0.0    # id(fn) in the key cannot be recycled
    arena_bytes: int = 0          # reserved-memory estimate (0 if unknown)
    touched: float = 0.0          # last hit/insert time (global-LRU victim
                                  # selection across budget-pooled caches)


class MemoryBudget:
    """Process-wide accountant bounding total executable bytes across
    every attached :class:`ScheduleCache`.

    Per-cache ``byte_budget``\\ s bound each cache alone; a serving plane
    with one cache per tenant group can still exceed device memory in
    aggregate.  Attach the same ``MemoryBudget`` to all of them and the
    *sum* of their reserved arena bytes is bounded too: each byte-total
    change is charged here (exactly — the charge happens under the
    owning cache's lock, mirroring its own accounting), and inserts that
    overflow the pool trigger a rebalance that evicts one LRU entry at a
    time from whichever cache holds the globally least-recently-touched
    entry.  An entry larger than the whole pool is rejected at insert
    exactly like a per-cache oversized entry (counted eviction, exact
    ``bytes_evicted``), never cached.

    Locking: the budget's mutex is a **leaf** — caches charge it while
    holding their own lock, but the budget never calls into a cache while
    holding it.  The rebalance loop runs with *no* cache lock held,
    taking each victim's lock only inside its single-entry eviction, so
    two caches inserting concurrently can never deadlock through the
    shared pool.  Under the worker plane each worker process owns one
    budget and reports :meth:`snapshot` to the parent with its heartbeat.
    """

    def __init__(self, limit_bytes: int) -> None:
        if limit_bytes < 1:
            raise ValueError(f"limit_bytes must be >= 1, got {limit_bytes}")
        self.limit_bytes = int(limit_bytes)
        self._mu = threading.Lock()          # leaf: counters + membership
        self._caches: list["ScheduleCache"] = []
        self._charged: dict[int, int] = {}   # id(cache) -> bytes charged
        self.rebalance_evictions = 0         # entries evicted cross-cache
        self.bytes_evicted = 0               # bytes those evictions released

    def attach(self, cache: "ScheduleCache") -> None:
        """Register ``cache`` with the pool (its bytes are charged from
        now on; done automatically by ``ScheduleCache(budget=...)``)."""
        with self._mu:
            if all(c is not cache for c in self._caches):
                self._caches.append(cache)
                self._charged.setdefault(id(cache), 0)

    def charge(self, cache: "ScheduleCache", delta: int) -> None:
        """Fold one cache's byte-total delta into the pool (called by the
        cache under its own lock; this lock is a leaf below it)."""
        with self._mu:
            self._charged[id(cache)] = (
                self._charged.get(id(cache), 0) + int(delta)
            )

    def total_bytes(self) -> int:
        """Summed reserved arena bytes across every attached cache."""
        with self._mu:
            return sum(self._charged.values())

    def over_bytes(self) -> int:
        """How far the pool currently exceeds ``limit_bytes`` (0 if not)."""
        return max(0, self.total_bytes() - self.limit_bytes)

    def rebalance(self) -> int:
        """Evict LRU entries — globally oldest-touched cache first, one
        entry per round — until the pool fits; returns bytes released.
        Runs with no cache lock held (see the class docstring)."""
        released = 0
        with self._mu:
            caches = list(self._caches)
        # bounded: every round either frees bytes or finds nothing to free
        for _ in range(1_000_000):
            if self.over_bytes() <= 0:
                break
            victim = None
            oldest = None
            for cache in caches:
                if cache.arena_bytes_total == 0:
                    continue                 # nothing chargeable to free
                age = cache.lru_age()
                if age is None:
                    continue
                if oldest is None or age < oldest:
                    oldest = age
                    victim = cache
            if victim is None:
                break                        # nothing evictable remains
            freed = victim._evict_one_for_budget()
            if freed > 0:
                released += freed
                with self._mu:
                    self.rebalance_evictions += 1
                    self.bytes_evicted += freed
        return released

    def snapshot(self) -> dict:
        """Pool state for metrics / worker heartbeats: limit, usage, and
        cross-cache eviction counters."""
        with self._mu:
            total = sum(self._charged.values())
            return {
                "limit_bytes": self.limit_bytes,
                "total_bytes": total,
                "caches": len(self._caches),
                "rebalance_evictions": self.rebalance_evictions,
                "bytes_evicted": self.bytes_evicted,
            }


def _arena_bytes(value: Any, explicit: Optional[int] = None) -> int:
    """Reserved arena estimate of a cached artifact.

    Resolution order: an ``explicit`` caller-provided estimate (the serving
    engine derives one from its buffer shapes); then a ``TaskSchedule``'s
    ``stats``: the larger of its planned ``arena_bytes`` and the
    ``device_bytes`` its seal holds on the card (the CUDA graph pool keeps
    every intermediate, so there it is the larger); else 0.  Artifacts
    reporting 0 remain governed by the entry-count ``capacity`` ceiling
    rather than the byte budget."""
    if explicit is not None:
        return max(0, int(explicit))
    stats = getattr(value, "stats", None)
    return max(0, int(getattr(stats, "arena_bytes", 0)), int(getattr(stats, "device_bytes", 0)))


class ScheduleCache:
    """LRU cache of sealed schedules/executables with build coalescing.

    Two entry points:

    * :meth:`get_or_schedule` — the Nimble path: key derived from
      ``(fn, example_args, scheduler.options_key())``, value a
      :class:`~repro_torch.core.aot.TaskSchedule` produced by the
      scheduler's pre-run.
    * :meth:`get_or_build` — the generic path: any hashable key, any builder
      producing a sealed artifact (the serving engine caches its sealed
      decode step and prefill buckets this way).

    Bounded two ways: ``capacity`` caps the entry count (always), and
    ``byte_budget`` — when set — caps the summed ``arena_bytes`` of the
    cached artifacts, evicting LRU-first until the total fits.  Fully
    thread-safe; see the module docstring for the locking contract.
    """

    def __init__(
        self,
        capacity: int = 64,
        *,
        byte_budget: Optional[int] = None,
        budget: Optional[MemoryBudget] = None,
        tracer: Optional[Any] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if byte_budget is not None and byte_budget < 1:
            raise ValueError(f"byte_budget must be >= 1, got {byte_budget}")
        self.capacity = capacity
        self.byte_budget = byte_budget
        # shared cross-cache pool (MemoryBudget): every byte-total change
        # is charged to it, and inserts trigger a pool rebalance
        self.budget = budget
        self.tracer = tracer if tracer is not None else get_tracer()
        self.stats = CacheStats()
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._bytes_total = 0                     # sum of entry arena_bytes
        self._mu = threading.Lock()               # guards entries + stats
        self._build_locks: dict[Any, threading.Lock] = {}
        if budget is not None:
            budget.attach(self)

    # -- inspection --------------------------------------------------------

    def __len__(self) -> int:
        """Number of cached entries."""
        with self._mu:
            return len(self._entries)

    def __contains__(self, key: Any) -> bool:
        """Membership check without touching hit/miss stats or LRU order."""
        with self._mu:
            return key in self._entries

    def keys(self) -> list:
        """Cached keys in LRU→MRU order."""
        with self._mu:
            return list(self._entries)

    @property
    def arena_bytes_total(self) -> int:
        """Sum of every cached entry's reserved ``arena_bytes`` — the number
        :attr:`byte_budget` is enforced against.  Never exceeds the budget
        when one is configured."""
        with self._mu:
            return self._bytes_total

    def lru_age(self) -> Optional[float]:
        """Last-touch timestamp of this cache's LRU entry (``None`` when
        empty) — the global-victim ordering key a shared
        :class:`MemoryBudget` rebalance compares across caches."""
        with self._mu:
            if not self._entries:
                return None
            return next(iter(self._entries.values())).touched

    # -- core paths --------------------------------------------------------

    def get(self, key: Any) -> Optional[Any]:
        """Lookup without building; counts a hit or a miss."""
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            entry.touched = time.monotonic()
            self.stats.hits += 1
            if self.tracer.enabled:
                # no repr(key): hits are the hot path
                self.tracer.instant("cache.hit", cat="cache")
            return entry.value

    def put(
        self, key: Any, value: Any, *, pin: Any = None,
        arena_bytes: Optional[int] = None,
    ) -> None:
        """Insert (or replace) ``key`` as the MRU entry, then evict as
        needed to honor ``capacity`` and ``byte_budget``.  ``arena_bytes``
        is the artifact's reserved-memory estimate (callers that know
        their artifact's footprint — e.g. the serving engine's
        buffer-shape estimate — pass it here; 0 otherwise)."""
        nbytes = _arena_bytes(value, arena_bytes)
        with self._mu:
            self._insert_locked(
                key, _Entry(value=value, pin=pin, arena_bytes=nbytes)
            )
        if self.budget is not None:
            self.budget.rebalance()       # outside _mu: see MemoryBudget

    def get_or_build(
        self,
        key: Any,
        build: Callable[[], Any],
        *,
        pin: Any = None,
        arena_bytes: Optional[int] = None,
    ) -> Any:
        """Return the cached value for ``key``, building it at most once.

        Concurrent callers missing on the same key coalesce on a per-key
        lock: one performs the build, the rest wait and receive the cached
        result — a pre-run is never duplicated.
        ``arena_bytes`` overrides the derived reserved-memory estimate for
        the inserted entry (see :meth:`put`).
        """
        with self._mu:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.touched = time.monotonic()
                self.stats.hits += 1
                if self.tracer.enabled:
                    self.tracer.instant("cache.hit", cat="cache")
                return entry.value
            self.stats.misses += 1
            lock = self._build_locks.setdefault(key, threading.Lock())

        with lock:
            # double-check: another caller may have built while we waited —
            # served from cache, so reclassify the provisional miss as a hit
            with self._mu:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    entry.touched = time.monotonic()
                    self.stats.hits += 1
                    self.stats.misses -= 1
                    if self.tracer.enabled:
                        self.tracer.instant("cache.hit", cat="cache")
                    return entry.value
            t0 = time.perf_counter()
            # on failure the per-key lock stays in _build_locks: waiters and
            # later callers coalesce on it for the retry.  Popping it here
            # would let a fresh caller mint a second lock and duplicate the
            # build a waiter is already retrying.
            try:
                value = build()
            except BaseException:
                if self.tracer.enabled:
                    self.tracer.instant(
                        "cache.build_failed", cat="cache",
                        args={"key": repr(key)},
                    )
                raise
            dt = time.perf_counter() - t0
            if self.tracer.enabled:
                # build spans are rare and slow; repr(key) is affordable
                self.tracer.complete(
                    "cache.build", t0, dt, cat="cache",
                    args={"key": repr(key)},
                )
            tid = threading.get_ident()
            nbytes = _arena_bytes(value, arena_bytes)
            with self._mu:
                self.stats.builds += 1
                self.stats.build_seconds += dt
                self.stats.builds_by_thread[tid] = (
                    self.stats.builds_by_thread.get(tid, 0) + 1
                )
                self._insert_locked(key, _Entry(
                    value=value, pin=pin, build_seconds=dt,
                    arena_bytes=nbytes,
                ))
                self._build_locks.pop(key, None)
            if self.budget is not None:
                self.budget.rebalance()   # outside _mu: see MemoryBudget
            return value

    def get_or_schedule(
        self,
        fn: Callable,
        *example_args: Any,
        scheduler: AoTScheduler,
        key: ScheduleKey,
    ) -> TaskSchedule:
        """The Nimble path: one shared pre-run per (fn, shapes, options).

        ``key`` is ``scheduler.schedule_key(fn, *example_args)``, which
        ``Nimble.prepare`` has already derived to detect no-op re-prepares."""
        return self.get_or_build(
            key, lambda: scheduler.schedule(fn, *example_args), pin=fn
        )

    def snapshot(self) -> dict:
        """Cache state for metrics: stats plus per-entry memory accounting.

        ``entries`` lists (LRU→MRU) each cached artifact's ``arena_bytes``
        (the memory the sealed step reserves, as its caller estimated it; 0
        when none was given) and
        build time;
        ``arena_bytes_total`` is their sum — the quantity byte-budget
        eviction keeps at or below ``byte_budget``.
        """
        with self._mu:
            entries = [
                {
                    "key": repr(key),
                    "arena_bytes": e.arena_bytes,
                    "build_seconds": e.build_seconds,
                }
                for key, e in self._entries.items()
            ]
            snap = {
                "capacity": self.capacity,
                "byte_budget": self.byte_budget,
                "size": len(entries),
                "arena_bytes_total": self._bytes_total,
                "entries": entries,
                "stats": self.stats.as_dict(),
            }
            if self.budget is not None:
                snap["budget"] = self.budget.snapshot()
            return snap

    def invalidate(self, key: Any) -> bool:
        """Drop ``key`` if cached; returns whether anything was removed."""
        with self._mu:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._bytes_total -= entry.arena_bytes
            self._charge_budget(-entry.arena_bytes)
            return True

    def clear(self) -> None:
        """Drop every entry (stats are kept)."""
        with self._mu:
            self._entries.clear()
            self._charge_budget(-self._bytes_total)
            self._bytes_total = 0

    # -- internals ---------------------------------------------------------

    def _charge_budget(self, delta: int) -> None:
        """Mirror a ``_bytes_total`` delta into the shared pool.  Called
        under ``_mu``; the budget's lock is a leaf below it."""
        if self.budget is not None and delta:
            self.budget.charge(self, delta)

    def _insert_locked(self, key: Any, entry: _Entry) -> None:
        before = self._bytes_total
        try:
            self._insert_inner_locked(key, entry)
        finally:
            self._charge_budget(self._bytes_total - before)

    def _insert_inner_locked(self, key: Any, entry: _Entry) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes_total -= old.arena_bytes
        if (
            self.byte_budget is not None
            and entry.arena_bytes > self.byte_budget
        ) or (
            self.budget is not None
            and entry.arena_bytes > self.budget.limit_bytes
        ):
            # an artifact larger than the whole budget (per-cache or shared
            # pool) can never be resident: reject it deterministically
            # (counted as an immediate eviction) instead of churning every
            # resident entry out only to evict the newcomer too.  The
            # caller still gets the built value — it just isn't cached.
            self.stats.evictions += 1
            self.stats.bytes_evicted += entry.arena_bytes
            if self.tracer.enabled:
                self.tracer.instant(
                    "cache.evict", cat="cache",
                    args={"bytes": entry.arena_bytes, "oversized": True},
                )
            return
        entry.touched = time.monotonic()
        self._entries[key] = entry
        self._bytes_total += entry.arena_bytes
        self._evict_locked()

    def _evict_one_for_budget(self) -> int:
        """Evict this cache's single LRU entry on behalf of a shared
        :class:`MemoryBudget` rebalance; returns the bytes released.
        Takes only this cache's lock — the pool holds none while calling."""
        with self._mu:
            if not self._entries:
                return 0
            _, entry = self._entries.popitem(last=False)
            self._bytes_total -= entry.arena_bytes
            self.stats.evictions += 1
            self.stats.bytes_evicted += entry.arena_bytes
            self._charge_budget(-entry.arena_bytes)
            if self.tracer.enabled:
                self.tracer.instant(
                    "cache.evict", cat="cache",
                    args={"bytes": entry.arena_bytes, "budget": True},
                )
            return entry.arena_bytes

    def _evict_locked(self) -> None:
        """Evict LRU-first until both limits hold: entry count ≤ capacity
        and (when a ``byte_budget`` is set) total arena bytes ≤ budget."""
        while self._entries and (
            len(self._entries) > self.capacity
            or (self.byte_budget is not None
                and self._bytes_total > self.byte_budget)
        ):
            _, entry = self._entries.popitem(last=False)
            self._bytes_total -= entry.arena_bytes
            self.stats.evictions += 1
            self.stats.bytes_evicted += entry.arena_bytes
            if self.tracer.enabled:
                self.tracer.instant(
                    "cache.evict", cat="cache",
                    args={"bytes": entry.arena_bytes},
                )
