"""Durable request journal (SQLite WAL) + deterministic fault injection.

The dispatcher's scheduling state — registered lanes, queued requests,
in-flight quanta — lives in process memory; a control-plane crash used
to lose every accepted request even though the worker plane survives
*worker* crashes.  :class:`RequestJournal` closes that gap: an
append-only record of lane registrations (as picklable
:class:`~repro_torch.serving.spec.EngineSpec` recipes) and request lifecycle
transitions, written to a SQLite database in WAL mode, that
:meth:`Dispatcher.recover` replays on restart.

Write path (the part that must not tax the schedulers):

* ``record_*`` calls are O(1) — they append a tuple to an in-memory
  deque and return.  No SQLite call ever runs on a dispatcher thread,
  so by construction no journal write happens inside ``_ready_mu``,
  ``step_mu``, or any other dispatcher lock.
* A single **writer thread** owns the SQLite connection.  It drains the
  deque in batches, executes each batch in one transaction, and commits.
  With ``synchronous="FULL"`` (the default) every commit fsyncs the WAL,
  so durability is batched, not per-record — group commit.
* :meth:`quantum_mark` is the fsync cadence: ``step_lane`` calls it once
  per scheduling quantum (outside all locks), nudging the writer to
  commit whatever has accumulated.  Between quanta, a small
  ``flush_interval`` timer bounds the window for submit-only traffic.
* Batched durability means a crash can lose the *tail* of the journal
  (records not yet committed).  Recovery is prefix-consistent: whatever
  the journal holds is replayed; a request whose ``QUEUED`` record was
  lost is simply a request the client never got an ack for.
  :meth:`sync` gives callers a barrier when they need one.

Compaction: terminal requests (``COMPLETED``/``FAILED``/``SHED``) and
superseded lane rows are deleted every ``compact_every`` commits, so the
journal's size tracks the *live* request set, not the lifetime total.

Recovery reading (:meth:`recover_state`) opens its own connection; a
database SQLite itself cannot read back consistently — torn beyond the
WAL checksum chain's automatic prefix recovery, or an unpicklable lane
spec — raises :class:`~repro_torch.dispatch.errors.JournalCorrupt`.

:class:`FaultInjector` makes the failure paths deterministic for tests:
crash-at-transition hooks (raise exactly at the Nth entry into a named
state), journal-write error injection (the writer's commit fails N
times), worker-spawn faults (the plane's respawn path fails on demand),
and torn-write simulation (truncate the ``-wal`` file mid-frame).
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from repro_torch.obs.tracer import get_tracer

from .errors import FaultInjected, JournalCorrupt
from .lifecycle import LaneState, RequestState, TERMINAL_STATES

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta(
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS lanes(
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    state TEXT NOT NULL,
    spec BLOB,
    weight REAL NOT NULL DEFAULT 1.0,
    priority_class INTEGER NOT NULL DEFAULT 0,
    latency_target_ms REAL
);
CREATE TABLE IF NOT EXISTS requests(
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    rid INTEGER NOT NULL,
    lane TEXT NOT NULL,
    prompt BLOB NOT NULL,
    max_new_tokens INTEGER NOT NULL,
    tenant TEXT NOT NULL DEFAULT '',
    deadline REAL NOT NULL DEFAULT 0.0
);
CREATE INDEX IF NOT EXISTS requests_rid ON requests(rid);
CREATE TABLE IF NOT EXISTS transitions(
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    rid INTEGER NOT NULL,
    state TEXT NOT NULL,
    t REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS transitions_rid ON transitions(rid);
"""

_TERMINAL_SQL = "('" + "','".join(sorted(TERMINAL_STATES)) + "')"


class LaneRecord:
    """One recovered lane: its latest journaled state plus the
    registration parameters needed to re-register it (``spec`` is the
    unpickled engine recipe, or ``None`` when the lane was registered
    without one — such lanes need a caller-provided engine to recover)."""

    __slots__ = (
        "name", "state", "spec", "weight", "priority_class",
        "latency_target_ms",
    )

    def __init__(
        self, name: str, state: str, spec: Any, weight: float,
        priority_class: int, latency_target_ms: Optional[float],
    ) -> None:
        self.name = name
        self.state = state
        self.spec = spec
        self.weight = weight
        self.priority_class = priority_class
        self.latency_target_ms = latency_target_ms


class RequestRecord:
    """One recovered request: its durable fields plus the latest
    journaled lifecycle state (always non-terminal — terminal requests
    are filtered out, and eventually compacted away)."""

    __slots__ = (
        "rid", "lane", "prompt", "max_new_tokens", "tenant", "deadline",
        "state",
    )

    def __init__(
        self, rid: int, lane: str, prompt: np.ndarray, max_new_tokens: int,
        tenant: str, deadline: float, state: str,
    ) -> None:
        self.rid = rid
        self.lane = lane
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant
        self.deadline = deadline
        self.state = state


class JournalState:
    """What :meth:`RequestJournal.recover_state` returns: live lanes (in
    original registration order), non-terminal requests (in original
    admission order), and the highest rid ever journaled (the recovered
    dispatcher's rid allocator must start above it)."""

    __slots__ = ("lanes", "requests", "max_rid")

    def __init__(
        self, lanes: "list[LaneRecord]", requests: "list[RequestRecord]",
        max_rid: int,
    ) -> None:
        self.lanes = lanes
        self.requests = requests
        self.max_rid = max_rid


class FaultInjector:
    """Deterministic fault hooks for the durability test harness.

    Threaded through the lifecycle tracker (crash-at-transition), the
    journal writer (write-error injection), and the worker plane
    (spawn faults) so recovery paths are testable without ``os.kill``
    timing races.  All methods are thread-safe; every fired fault is
    appended to :attr:`log` for assertions.  Production code never
    constructs one — a ``None`` injector costs nothing."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._crash_at: dict = {}      # (entity, state) -> remaining count
        self._journal_fails = 0
        self._spawn_faults: dict = {}  # worker index -> remaining failures
        #: fired faults, in order: ("transition"|"journal_write"|"spawn", key)
        self.log: list = []

    def crash_at(self, entity: str, state: str, *, count: int = 1) -> None:
        """Arm a crash on the ``count``-th transition of ``entity``
        (``"request"`` or ``"lane"``) into ``state`` — the hook raises
        :class:`~repro_torch.dispatch.errors.FaultInjected` there, once."""
        with self._mu:
            self._crash_at[(entity, state)] = count

    def on_transition(self, entity: str, key: Any, state: str) -> None:
        """Lifecycle-tracker hook: raises if an armed crash matches."""
        k = (entity, state)
        with self._mu:
            n = self._crash_at.get(k)
            if n is None:
                return
            n -= 1
            if n > 0:
                self._crash_at[k] = n
                return
            del self._crash_at[k]
            self.log.append(("transition", (entity, key, state)))
        raise FaultInjected(
            f"injected crash at {entity} transition -> {state!r} (key={key!r})"
        )

    def fail_journal_writes(self, n: int) -> None:
        """Arm the next ``n`` journal batch commits to fail."""
        with self._mu:
            self._journal_fails = n

    def check_journal_write(self) -> None:
        """Journal-writer hook: raises while armed write failures remain."""
        with self._mu:
            if self._journal_fails <= 0:
                return
            self._journal_fails -= 1
            self.log.append(("journal_write", None))
        raise FaultInjected("injected journal write failure")

    def fail_worker_spawns(self, index: int, n: int = 1) -> None:
        """Arm the next ``n`` spawn attempts of worker ``index`` to fail
        (the plane treats each as a transient crash, exercising the
        respawn/backoff path without real processes)."""
        with self._mu:
            self._spawn_faults[index] = n

    def on_worker_spawn(self, index: int) -> None:
        """Worker-plane hook: raises while armed spawn faults remain for
        worker ``index``."""
        with self._mu:
            n = self._spawn_faults.get(index, 0)
            if n <= 0:
                return
            self._spawn_faults[index] = n - 1
            self.log.append(("spawn", index))
        raise FaultInjected(f"injected spawn failure for worker {index}")

    @staticmethod
    def torn_write(path: str, keep: float = 0.5) -> bool:
        """Simulate a torn write: truncate the journal's ``-wal`` file to
        ``keep`` of its size (mid-frame, so the checksum chain breaks at
        the cut).  Returns ``False`` when there is no WAL content to
        tear (fully checkpointed journal)."""
        wal = path + "-wal"
        try:
            size = os.path.getsize(wal)
        except OSError:
            return False
        if size == 0:
            return False
        with open(wal, "r+b") as f:
            f.truncate(max(1, int(size * keep)))
        return True


class RequestJournal:
    """Append-only durability log for the dispatch control plane.

    ``path`` is the SQLite database file (parent directory must exist).
    ``synchronous`` maps to SQLite's pragma: ``"FULL"`` (default) fsyncs
    the WAL on every batch commit — the fsync-on-quantum-boundary
    contract; ``"NORMAL"`` trades the tail-loss window for speed.
    ``flush_interval`` bounds the writer's idle flush latency,
    ``batch_max`` bounds records per transaction, and ``compact_every``
    sets the compaction cadence in commits.  ``faults`` attaches a
    :class:`FaultInjector` to the write path.

    All ``record_*`` methods are thread-safe, non-blocking, and safe to
    call near dispatcher locks (they enqueue; the writer thread owns all
    SQLite I/O).  Use as a context manager or call :meth:`close`."""

    def __init__(
        self,
        path: str,
        *,
        synchronous: str = "FULL",
        flush_interval: float = 0.02,
        batch_max: int = 512,
        compact_every: int = 64,
        max_write_retries: int = 3,
        tracer: Optional[Any] = None,
        faults: Optional[FaultInjector] = None,
    ) -> None:
        self.path = path
        self.synchronous = synchronous
        self.flush_interval = flush_interval
        self.batch_max = batch_max
        self.compact_every = compact_every
        self.max_write_retries = max_write_retries
        self.tracer = tracer if tracer is not None else get_tracer()
        self.faults = faults
        self._q: deque = deque()
        self._wake = threading.Event()
        # quantum_mark wake rate limit: with microsecond quanta (tick
        # engines, hot pool), waking the fsync-ing writer on EVERY quantum
        # turns group commit into commit-per-step; one wake per
        # flush_interval keeps the durability window identical (the idle
        # timer commits anything the marks skip) at ~2 orders of magnitude
        # fewer fsyncs.  Plain float, racy on purpose: a lost update just
        # delays one wake by at most flush_interval.
        self._mark_gap = max(0.001, flush_interval)
        self._last_wake = 0.0
        self._stop = threading.Event()
        self._stats_mu = threading.Lock()
        self._records = 0
        self._commits = 0
        self._marks = 0
        self._max_batch = 0
        self._write_errors = 0
        self._dropped = 0
        self._compactions = 0
        self._degraded = False
        # the writer thread owns this connection; opening it here (on the
        # constructing thread) surfaces path errors synchronously
        self._conn = sqlite3.connect(path, check_same_thread=False)
        try:
            self._init_db(self._conn)
        except sqlite3.Error as exc:
            self._conn.close()
            raise JournalCorrupt(
                f"cannot initialize journal at {path!r}: {exc}", path=path
            ) from exc
        self._writer = threading.Thread(
            target=self._writer_loop, name="journal-writer", daemon=True
        )
        self._writer.start()

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def close(self, timeout: float = 5.0) -> None:
        """Flush everything queued, stop the writer, close the database.
        Idempotent."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._wake.set()
        self._writer.join(timeout)
        try:
            self._conn.close()
        except sqlite3.Error:
            pass

    # -- record API (hot path: O(1) enqueue, no I/O) -----------------------

    def record_lane(
        self,
        name: str,
        state: str,
        *,
        spec: Optional[Any] = None,
        weight: float = 1.0,
        priority_class: int = 0,
        latency_target_ms: Optional[float] = None,
    ) -> None:
        """Append a lane state row.  ``spec`` (an
        :class:`~repro_torch.serving.spec.EngineSpec`) is pickled HERE, on the
        registering thread — registration is not hot, and an unpicklable
        spec must fail with the registration stack attached."""
        blob = None
        if spec is not None:
            from repro_torch.serving.spec import pickle_spec  # lazy: avoid cycle

            blob = pickle_spec(spec)
        self._q.append(
            ("lane", name, state, blob, float(weight), int(priority_class),
             latency_target_ms)
        )

    def record_request(self, req: Any, lane: str) -> None:
        """Append the full durable record for a newly queued request (its
        prompt, limits, tenant, deadline) plus its ``QUEUED`` transition."""
        self._q.append(
            ("req", int(req.rid), lane,
             np.asarray(req.prompt, np.int32).tobytes(),
             int(req.max_new_tokens), getattr(req, "tenant", "") or "",
             float(getattr(req, "deadline", 0.0) or 0.0), time.time())
        )

    def record_transition(self, rid: int, state: str) -> None:
        """Append one lifecycle transition row for request ``rid``."""
        self._q.append(("tr", int(rid), state, time.time()))

    def quantum_mark(self) -> None:
        """Signal a scheduling-quantum boundary: if records are pending
        and the writer has not been nudged within ``flush_interval``,
        wake it to commit (and, under ``synchronous="FULL"``, fsync).
        Called by ``step_lane`` outside all locks; O(1), and deliberately
        rate-limited — see ``_mark_gap`` in ``__init__``."""
        self._marks += 1
        if not self._q or self._wake.is_set():
            return
        now = time.monotonic()
        if now - self._last_wake >= self._mark_gap:
            self._last_wake = now
            self._wake.set()

    def sync(self, timeout: float = 5.0) -> bool:
        """Block until everything recorded before this call is committed
        (or dropped after exhausted retries).  Returns ``False`` on
        timeout or after :meth:`close`."""
        if self._stop.is_set():
            return False
        ev = threading.Event()
        self._q.append(("barrier", ev))
        self._wake.set()
        return ev.wait(timeout)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Writer counters: records/commits/marks, batch high-water,
        write errors, dropped records, compactions, live queue depth, and
        the ``degraded`` flag (set once a batch was dropped)."""
        with self._stats_mu:
            return {
                "records": self._records,
                "commits": self._commits,
                "quantum_marks": self._marks,
                "max_batch": self._max_batch,
                "write_errors": self._write_errors,
                "dropped_records": self._dropped,
                "compactions": self._compactions,
                "queue_depth": len(self._q),
                "degraded": self._degraded,
            }

    # -- recovery read path ------------------------------------------------

    def recover_state(self) -> JournalState:
        """Read the journal back into a :class:`JournalState`.

        Opens an independent connection (safe while the writer runs,
        though recovery is meant to run before serving starts).  Lanes
        whose latest state is ``RETIRED`` and requests whose latest state
        is terminal are excluded.  Raises
        :class:`~repro_torch.dispatch.errors.JournalCorrupt` when SQLite cannot
        read the database or a lane spec fails to unpickle."""
        try:
            conn = sqlite3.connect(self.path)
            try:
                return self._read_state(conn)
            finally:
                conn.close()
        except sqlite3.Error as exc:
            raise JournalCorrupt(
                f"journal at {self.path!r} is unreadable: {exc}",
                path=self.path,
            ) from exc

    def _read_state(self, conn: sqlite3.Connection) -> JournalState:
        lanes: list = []
        latest: dict = {}
        first_seq: dict = {}
        for seq, name, state, blob, w, cls, tgt in conn.execute(
            "SELECT seq, name, state, spec, weight, priority_class,"
            " latency_target_ms FROM lanes ORDER BY seq"
        ):
            first_seq.setdefault(name, seq)
            prev = latest.get(name)
            # registration parameters live on the REGISTERED row; later
            # state rows only advance the lifecycle state
            if prev is None or blob is not None or state == LaneState.REGISTERED:
                latest[name] = (state, blob, w, cls, tgt)
            else:
                latest[name] = (state,) + prev[1:]
            if state == LaneState.REGISTERED:
                # a re-registered name restarts its admission ordering
                first_seq[name] = seq
        for name in sorted(latest, key=lambda n: first_seq[n]):
            state, blob, w, cls, tgt = latest[name]
            if state == LaneState.RETIRED:
                continue
            spec = None
            if blob is not None:
                try:
                    spec = pickle.loads(blob)
                except Exception as exc:
                    raise JournalCorrupt(
                        f"lane {name!r} spec failed to unpickle: {exc}",
                        path=self.path,
                    ) from exc
            lanes.append(LaneRecord(name, state, spec, w, cls, tgt))
        last_state: dict = {}
        for rid, state in conn.execute(
            "SELECT rid, state FROM transitions ORDER BY seq"
        ):
            last_state[rid] = state
        requests: list = []
        max_rid = -1
        for rid, lane, prompt, max_new, tenant, deadline in conn.execute(
            "SELECT rid, lane, prompt, max_new_tokens, tenant, deadline"
            " FROM requests ORDER BY seq"
        ):
            max_rid = max(max_rid, rid)
            state = last_state.get(rid, RequestState.QUEUED)
            if state in TERMINAL_STATES:
                continue
            requests.append(
                RequestRecord(
                    rid, lane,
                    np.frombuffer(prompt, np.int32).copy(),
                    max_new, tenant, deadline, state,
                )
            )
        if last_state:
            max_rid = max(max_rid, max(last_state))
        return JournalState(lanes, requests, max_rid)

    # -- writer thread -----------------------------------------------------

    def _init_db(self, conn: sqlite3.Connection) -> None:
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute(f"PRAGMA synchronous={self.synchronous}")
        conn.executescript(_SCHEMA)
        conn.commit()

    def _writer_loop(self) -> None:
        pending: list = []
        barriers: list = []
        attempts = 0
        while True:
            if not pending:
                self._wake.wait(self.flush_interval)
                self._wake.clear()
                while self._q and len(pending) < self.batch_max:
                    rec = self._q.popleft()
                    if rec[0] == "barrier":
                        barriers.append(rec[1])
                    else:
                        pending.append(rec)
            stopping = self._stop.is_set()
            if not pending:
                for ev in barriers:
                    ev.set()
                barriers = []
                if stopping and not self._q:
                    return
                continue
            try:
                if self.faults is not None:
                    self.faults.check_journal_write()
                t0 = time.perf_counter()
                self._write_batch(pending)
                dt = time.perf_counter() - t0
            except (sqlite3.Error, FaultInjected):
                attempts += 1
                with self._stats_mu:
                    self._write_errors += 1
                if attempts >= self.max_write_retries:
                    # exhausted: drop the batch, mark the journal degraded,
                    # keep serving — durability degrades, the dispatcher
                    # must not
                    with self._stats_mu:
                        self._dropped += len(pending)
                        self._degraded = True
                    pending = []
                    attempts = 0
                continue
            with self._stats_mu:
                self._records += len(pending)
                self._commits += 1
                self._max_batch = max(self._max_batch, len(pending))
            if self.tracer.enabled:
                self.tracer.complete(
                    "journal_commit", t0, dt, cat="journal",
                    args={"records": len(pending)},
                )
            pending = []
            attempts = 0
            if self.compact_every > 0 and self._commits % self.compact_every == 0:
                try:
                    self._compact()
                except sqlite3.Error:
                    with self._stats_mu:
                        self._write_errors += 1

    def _write_batch(self, batch: list) -> None:
        cur = self._conn.cursor()
        for rec in batch:
            kind = rec[0]
            if kind == "req":
                _, rid, lane, prompt, max_new, tenant, deadline, t = rec
                cur.execute(
                    "INSERT INTO requests(rid, lane, prompt, max_new_tokens,"
                    " tenant, deadline) VALUES (?,?,?,?,?,?)",
                    (rid, lane, prompt, max_new, tenant, deadline),
                )
                cur.execute(
                    "INSERT INTO transitions(rid, state, t) VALUES (?,?,?)",
                    (rid, RequestState.QUEUED, t),
                )
            elif kind == "tr":
                _, rid, state, t = rec
                cur.execute(
                    "INSERT INTO transitions(rid, state, t) VALUES (?,?,?)",
                    (rid, state, t),
                )
            elif kind == "lane":
                _, name, state, blob, weight, cls, tgt = rec
                cur.execute(
                    "INSERT INTO lanes(name, state, spec, weight,"
                    " priority_class, latency_target_ms) VALUES (?,?,?,?,?,?)",
                    (name, state, blob, weight, cls, tgt),
                )
        self._conn.commit()

    def _compact(self) -> None:
        """Fold the append-only log down to live state: delete terminal
        requests (and their transitions) and superseded lane rows.  Runs
        on the writer thread, in one transaction."""
        cur = self._conn.cursor()
        cur.execute(
            "CREATE TEMP TABLE IF NOT EXISTS _term(rid INTEGER PRIMARY KEY)"
        )
        cur.execute("DELETE FROM _term")
        cur.execute(
            "INSERT INTO _term SELECT rid FROM transitions t1 WHERE seq ="
            " (SELECT MAX(seq) FROM transitions t2 WHERE t2.rid = t1.rid)"
            f" AND state IN {_TERMINAL_SQL}"
        )
        cur.execute(
            "DELETE FROM transitions WHERE rid IN (SELECT rid FROM _term)"
        )
        cur.execute(
            "DELETE FROM requests WHERE rid IN (SELECT rid FROM _term)"
        )
        cur.execute(
            "DELETE FROM lanes WHERE seq NOT IN"
            " (SELECT MAX(seq) FROM lanes GROUP BY name)"
        )
        cur.execute("DELETE FROM _term")
        self._conn.commit()
        with self._stats_mu:
            self._compactions += 1
