"""repro_torch.dispatch: schedule cache + multi-tenant dispatch over sealed steps.

The port of the JAX package's ``repro.dispatch``, with the same public
names and behaviour (the worker plane's ``xla_host_devices`` aside); what
the card changes is at the seams: engines capture CUDA graphs under a
process-wide capture lock that replays honour, every engine step runs with
its engine's CUDA device current on the stepping thread, worker processes
start with ``spawn`` (``fork`` is refused once CUDA is initialised) and
make their device current before they build, and engine recipes draw their
weights from a seeded ``torch.Generator`` on the worker's device.

Turns the single-schedule ``Nimble`` wrapper into a serving layer: sealed
steps live in a shared :class:`ScheduleCache` (entry-count LRU plus a
reserved-arena byte budget) keyed by :class:`~repro_torch.core.aot.ScheduleKey`;
incoming shapes map onto cached shapes via :mod:`bucketing`; the
:class:`Dispatcher` multiplexes tenant requests over per-model engines
with pluggable :mod:`fairness` (round-robin rotation, weighted fair
queueing, concurrent weighted deficit round-robin, lottery scheduling,
wall-clock token-rate quotas), backpressure, and fine-grained
locking (submits never wait out an engine step); the
:class:`AsyncDispatcher` runs one stepper thread per engine — decode
overlaps across tenants — or a fixed stepper pool multiplexing hundreds
of tenants over ``pool_size`` threads, while an event-driven quantum
arbiter keeps the shared policy in charge (freed quanta are granted on
the ``charge``/submit event, not a poll tick) — behind a future-returning
``submit``; and :mod:`metrics` reports latency/throughput/cache numbers
down to per-engine step, grant-latency, and pool-occupancy series.

Cross-tenant batched decode (:mod:`batching`): hand the dispatcher a
:class:`BatchComposer` and lanes whose engines agree on a compatibility
key (same config, weights, device, slots, bucketing — witnessed by
``ServingEngine.compose_key()``) coalesce into a :class:`ComposeGroup`
sharing one host engine: one sealed decode step then serves every
member's sequences at once with per-slot tenancy, freed slots refill
from member queues in fairness order, and the policy is charged per
tenant by token share (``FairnessPolicy.charge_composed``).

Multi-process serving plane (:mod:`workers`): ``AsyncDispatcher(
stepping="workers", devices=N)`` ships granted quanta to per-device
:class:`DeviceWorker` processes over a :class:`WorkerPlane` — the parent
keeps the indexed ready set, fairness/SLO policy, admission control, and
futures; each worker owns its engines (rehydrated in-child from picklable
``EngineSpec`` recipes), its own :class:`ScheduleCache` under a
process-wide :class:`MemoryBudget`, and a tracer ring whose spans merge
into one multi-process Perfetto trace.  A worker crash fails only its own
lanes with typed errors (:class:`WorkerError` / :class:`WorkerCrashed` /
:class:`WorkerTimeout` / :class:`WorkerSetupError`) while the rest of the
fleet keeps serving; crashed workers respawn and replay queued work.

SLO plane (:mod:`slo`): lanes register with a ``priority_class`` (lower =
more important; strict class ordering composes with any fairness policy
within a class via :class:`ClassedFairness`) and an optional
``latency_target_ms``.  Preemption is quantum-granular and free — a
lower-class lane's grant simply is not renewed while a higher class has
ready work; in-flight device steps always complete.  Completions feed an
adaptive overload controller (:class:`AdaptiveController`), and requests
whose deadlines are provably unmeetable are refused with typed
:class:`AdmissionRejected` backpressure (or load-shed from the queue
under overload) — surfaced through ``AsyncDispatcher.submit`` futures.

Durable control plane (:mod:`lifecycle` + :mod:`journal`): requests move
through an explicit, enforced state machine (``SUBMITTED → QUEUED →
GRANTED → STEPPING → {COMPLETED, FAILED, SHED}`` with ``PREEMPTED`` /
``INTERRUPTED`` re-entering ``QUEUED`` on recovery; lanes ``REGISTERED →
ACTIVE → RETIRING → RETIRED``) — illegal moves raise the typed
:class:`IllegalTransition`.  Attach a :class:`RequestJournal` (SQLite,
WAL mode, batched writer thread, fsync on quantum boundaries) and every
lane registration (as a picklable ``EngineSpec`` recipe) and request
transition is recorded append-only off the hot path; after a crash,
``Dispatcher.recover(journal)`` / ``AsyncDispatcher.recover(journal)``
re-registers the lanes, marks crashed-in-flight requests ``INTERRUPTED``,
and requeues all non-terminal work in original admission order.  A
:class:`FaultInjector` threads deterministic crash/write/spawn faults
through the same paths for testing.  Every error the plane raises on
purpose derives from :class:`DispatchError`, so one ``except`` catches
the whole taxonomy.

Thread-safety: every class exported here is safe to use from multiple
threads; see DESIGN.md §locking-contract for exactly which lock protects
what and the ordering that keeps the whole layer deadlock-free.
"""

from .async_dispatcher import AsyncDispatcher
from .batching import BatchComposer, ComposeGroup
from .bucketing import (
    BucketingPolicy,
    ExactBucketing,
    ExplicitBuckets,
    PowerOfTwoBuckets,
    make_policy,
)
from .cache import CacheStats, MemoryBudget, ScheduleCache
from .dispatcher import Dispatcher, DrainTimeoutError, QueueFullError
from .errors import (
    DispatchError,
    FaultInjected,
    IllegalTransition,
    JournalCorrupt,
)
from .fairness import (
    FAIRNESS_POLICIES,
    ClassedFairness,
    DeficitRoundRobinFairness,
    FairnessPolicy,
    LotteryFairness,
    QuotaFairness,
    RoundRobinFairness,
    WeightedFairness,
    make_fairness,
)
from .journal import (
    FaultInjector,
    JournalState,
    LaneRecord,
    RequestJournal,
    RequestRecord,
)
from .lifecycle import (
    LANE_TRANSITIONS,
    REQUEST_TRANSITIONS,
    TERMINAL_STATES,
    LaneState,
    LifecycleTracker,
    RequestState,
    check_lane_transition,
    check_request_transition,
)
from .metrics import DispatchMetrics, LatencySeries, percentile
from .slo import AdaptiveController, AdmissionRejected, SLOPolicy
from .workers import (
    DeviceWorker,
    EngineWorker,
    WorkerCrashed,
    WorkerError,
    WorkerPlane,
    WorkerSetupError,
    WorkerTimeout,
    device_topology,
)

__all__ = [
    "BucketingPolicy", "ExactBucketing", "ExplicitBuckets",
    "PowerOfTwoBuckets", "make_policy",
    "CacheStats", "MemoryBudget", "ScheduleCache",
    "BatchComposer", "ComposeGroup",
    "Dispatcher", "AsyncDispatcher", "QueueFullError", "DrainTimeoutError",
    "FairnessPolicy", "RoundRobinFairness", "WeightedFairness",
    "DeficitRoundRobinFairness", "LotteryFairness",
    "QuotaFairness", "ClassedFairness", "FAIRNESS_POLICIES", "make_fairness",
    "DispatchMetrics", "LatencySeries", "percentile",
    "AdmissionRejected", "AdaptiveController", "SLOPolicy",
    "DeviceWorker", "EngineWorker", "WorkerPlane", "device_topology",
    "WorkerError", "WorkerSetupError", "WorkerCrashed", "WorkerTimeout",
    "DispatchError", "IllegalTransition", "JournalCorrupt", "FaultInjected",
    "RequestState", "LaneState", "LifecycleTracker",
    "REQUEST_TRANSITIONS", "LANE_TRANSITIONS", "TERMINAL_STATES",
    "check_request_transition", "check_lane_transition",
    "RequestJournal", "JournalState", "LaneRecord", "RequestRecord",
    "FaultInjector",
]
