"""Multi-process serving plane: per-device worker processes under the
parent's O(active) grant path.

Everything before this module lives in one Python process, so past ~8
steppers the GIL — not the devices — bounds aggregate steps/s, and one
engine fault poisons every tenant.  This module splits the plane the way
the GPU-datacenter schedulers do (and the related ``gpu_dispatch`` repo's
BaseWorker protocol models): the **parent** keeps everything that makes
scheduling decisions — the indexed ready set, ``ClassedFairness``/SLO
policy, admission control, futures, and metrics — while each **worker
process** owns one device's execution state: its ``ScheduleCache``, its
``ServingEngine``s, and its tracer ring.  Granted quanta ship over a
duplex pipe as small picklable payloads; finished tokens ship back and
resolve futures in the parent.

Ownership split (DESIGN.md §process-model):

====================  ==================================================
parent (dispatcher)   ready index, fairness/SLO/admission, futures,
                      request queues, metrics, trace merge
worker (per device)   engine build (AoT seal), ``ScheduleCache`` +
                      ``MemoryBudget``, ``engine.step()``, tracer ring
====================  ==================================================

The parent-side stand-in for a lane's engine is :class:`_LaneProxy`:
duck-typed to the dispatcher's engine contract (``submit`` / ``step`` /
``free_slots`` / ``idle``), so the whole existing grant path — arbiter,
pool steppers, fairness charging, completion callbacks — runs unchanged;
``proxy.step()`` is simply a blocking RPC into the worker that owns the
lane.  Crucially the proxy **never raises** from ``step()``: a worker
crash, setup failure, or timeout is converted into finished requests
carrying a typed :class:`WorkerError` (surfaced on their futures by the
async layer), so one device's death fails only its own lanes while the
rest of the fleet keeps granting.

Failure matrix (each result is a typed error on the affected lanes only):

* **setup failure** — the worker's ``setup()`` raised: deterministic
  config error, never respawned; submissions fail ``WorkerSetupError``.
* **crash** — the process died (signal, ``os._exit``): in-flight
  requests fail ``WorkerCrashed``; queued work replays on the respawned
  worker (lanes are re-registered automatically, bounded by
  ``max_restarts``).
* **timeout** — the process is alive but wedged (no heartbeat inside
  ``hb_timeout``, or a step RPC exceeding ``step_timeout``): the worker
  is killed and treated as a crash, with ``WorkerTimeout`` attached.
  While a worker unpickles a command (a spawned child imports the
  spec's module there) or builds a lane's engine, a side thread keeps
  heartbeating, so a slow build is bounded by ``setup_timeout`` and not
  by ``hb_timeout``; a step gets no such thread, and a wedged step goes
  silent.  The workers of a CPU plane split the parent's torch threads
  among them, so that a step under load is not held up by an
  oversubscribed CPU.
* **shutdown** — parent-initiated: workers drain their trace rings into
  a final ``bye`` message and exit; the plane joins then force-kills
  stragglers so no orphan processes outlive the parent.

Device assignment: :func:`device_topology` maps worker *i* to CUDA device
``i % torch.cuda.device_count()`` (a CUDA plane on a host with no card
raises; a CPU plane puts every worker on device 0), each worker makes its
device current with ``torch.cuda.set_device`` before it builds anything,
and worker spans merge into one Perfetto trace with per-process tracks
(``TraceEvent.pid`` + a clock offset handshake at setup).
``AsyncDispatcher(stepping="workers", devices=N)`` is the front door that
wires all of this together.

Where the port differs from the JAX package: workers start with ``spawn``
by default, and ``fork`` is refused (:class:`WorkerSetupError`) once CUDA
is initialised in the parent — a forked child inherits a CUDA context it
cannot use.  A forked child runs torch's CPU ops on one thread, since the
OpenMP team of its parent did not survive the fork.  The JAX plane's ``xla_host_devices`` parameter (host devices
faked through ``XLA_FLAGS``) has no torch counterpart and is gone.
"""

from __future__ import annotations

import contextlib
import inspect
import multiprocessing as mp
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import launch_counts
from repro_torch.obs.tracer import TraceEvent, get_tracer

from .errors import DispatchError


class WorkerError(DispatchError):
    """Base class for typed worker-plane failures (part of the unified
    :class:`~repro_torch.dispatch.errors.DispatchError` taxonomy).

    Carries the worker index and device index so callers (and tests) can
    assert the blast radius: a failure names exactly one worker, and only
    that worker's lanes ever see it."""

    def __init__(self, msg: str, *, worker: int = -1, device: int = -1):
        super().__init__(msg)
        self.worker = worker
        self.device = device


class WorkerSetupError(WorkerError):
    """The worker's ``setup()`` raised (or timed out) — a deterministic
    configuration error, so the worker is never respawned and every
    request routed to its lanes fails with this error."""


class WorkerCrashed(WorkerError):
    """The worker process died (signal, ``os._exit``, broken pipe) with
    work possibly in flight.  In-flight requests fail with this error;
    queued work replays once the worker respawns."""


class WorkerTimeout(WorkerError):
    """The worker process is alive but unresponsive: no heartbeat within
    ``hb_timeout``, or a step RPC exceeded ``step_timeout``.  The plane
    kills the process and treats it as a crash thereafter."""


class DeviceWorker:
    """Process-side protocol a worker subclass implements (the related
    ``gpu_dispatch`` repo's BaseWorker shape: setup / process / cleanup).

    The child loop (:func:`_worker_main`) instantiates the class **in the
    worker process**, stamps ``self.index`` (worker index in the plane),
    calls :meth:`setup` once, then :meth:`process` per parent command,
    and :meth:`cleanup` on the way out.  A raising ``setup`` is reported
    to the parent as a typed setup failure; a raising ``process`` is
    reported per-command and the worker keeps serving."""

    index: int = -1

    def setup(self, device_index: int, **kwargs: Any) -> None:
        """One-time per-process initialization on ``device_index``."""

    def process(self, command: str, payload: tuple) -> tuple:
        """Handle one parent command; returns the reply message tuple."""
        raise NotImplementedError

    def cleanup(self) -> None:
        """Final per-process teardown (best-effort, after shutdown)."""

    def stats(self) -> dict:
        """Heartbeat payload: cheap, picklable worker-side counters."""
        return {}


class EngineWorker(DeviceWorker):
    """The serving worker: owns this device's ``ScheduleCache`` (under a
    process-wide :class:`~repro_torch.dispatch.cache.MemoryBudget`) and one
    engine per registered lane, built in-process from the picklable
    :class:`~repro_torch.serving.spec.EngineSpec` the parent ships.

    Commands: ``register`` (build the spec's engine here — the AoT seal
    happens in the worker, so parent steppers still never compile),
    ``step`` (seat shipped payloads, run one engine step, ship finished
    tokens + per-step token counts back), ``unregister`` (retire the
    engine)."""

    def __init__(self) -> None:
        self.device_index = 0
        self.engines: dict[str, Any] = {}
        self.cache: Any = None
        self.budget: Any = None
        self.steps = 0
        self.tokens = 0
        # a forked worker starts with its parent's counts: report its own
        self.launches_before = launch_counts()

    def setup(self, device_index: int, **kwargs: Any) -> None:
        """Make ``device_index`` this process's current CUDA device (for a
        CUDA plane: ``device="cuda"``, the default), then build the
        per-worker cache + byte-budget accountant."""
        from .cache import MemoryBudget, ScheduleCache

        self.device_index = device_index
        if kwargs.get("device", "cuda") == "cuda":
            torch.cuda.set_device(device_index)
        budget_bytes = kwargs.get("budget_bytes")
        self.budget = MemoryBudget(budget_bytes) if budget_bytes else None
        self.cache = ScheduleCache(
            capacity=int(kwargs.get("cache_capacity", 64)),
            byte_budget=kwargs.get("cache_budget_bytes"),
            budget=self.budget,
        )

    def stats(self) -> dict:
        """Per-worker heartbeat counters, reported up to the parent."""
        out = {
            "device": self.device_index,
            "lanes": len(self.engines),
            "steps": self.steps,
            "tokens": self.tokens,
        }
        if self.cache is not None:
            out["cache_bytes"] = self.cache.snapshot()["arena_bytes_total"]
        if self.budget is not None:
            out["budget"] = self.budget.snapshot()
        # the wrappers' counts in this process since it became a worker:
        # which kernels the lanes' seals launched, read in the parent from
        # heartbeats and replies
        out["kernel_launches"] = {name: n - self.launches_before.get(name, 0)
                                  for name, n in launch_counts().items()}
        return out

    def process(self, command: str, payload: tuple) -> tuple:
        """Dispatch one parent command to its handler."""
        if command == "register":
            lane, spec = payload
            self.engines[lane] = self._build(spec)
            return ("registered", lane)
        if command == "unregister":
            (lane,) = payload
            engine = self.engines.pop(lane, None)
            retire = getattr(engine, "retire", None)
            if retire is not None:
                retire()
            return ("unregistered", lane)
        if command == "step":
            lane, payloads = payload
            return self._step(lane, payloads)
        raise ValueError(f"unknown worker command {command!r}")

    def cleanup(self) -> None:
        """Retire every engine this worker still owns."""
        for engine in self.engines.values():
            retire = getattr(engine, "retire", None)
            if retire is not None:
                try:
                    retire()
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass
        self.engines.clear()

    def _build(self, spec: Any) -> Any:
        # rehydration contract: spec.build(device_index[, schedule_cache])
        # — pass this worker's shared cache when the spec accepts it
        try:
            params = inspect.signature(spec.build).parameters
        except (TypeError, ValueError):
            params = {}
        if "schedule_cache" in params:
            return spec.build(self.device_index, schedule_cache=self.cache)
        return spec.build(self.device_index)

    def _step(self, lane: str, payloads: list) -> tuple:
        engine = self.engines[lane]
        for payload in payloads:
            engine.submit(_rebuild_request(payload))
        stats = getattr(engine, "stats", None)
        tok0 = getattr(stats, "tokens_out", None)
        pf0 = getattr(stats, "prefill_tokens", 0) if stats is not None else 0
        tracer = get_tracer()
        t0 = time.perf_counter()
        newly = engine.step()
        if tracer.enabled:
            # the device-side view of the quantum: the parent's own
            # step:{lane} span brackets the whole RPC, this one is pure
            # engine time on the worker's track (shipped back parent-clock)
            tracer.complete(
                f"step:{lane}", t0, time.perf_counter() - t0,
                cat="step", lane=lane, args={"finished": len(newly)},
            )
        self.steps += 1
        if tok0 is not None:
            tokens = stats.tokens_out - tok0
            prefill = getattr(stats, "prefill_tokens", 0) - pf0
        else:
            tokens = sum(len(r.generated) for r in newly)
            prefill = 0
        self.tokens += tokens
        return (
            "step_result",
            lane,
            [_result_payload(r) for r in newly],
            int(tokens),
            int(prefill),
            self.stats(),
        )


# -- request shipping (minimal picklable payloads) --------------------------

def _request_payload(req: Any) -> tuple:
    """The picklable slice of a ``Request`` a worker needs to serve it
    (``on_complete`` and futures stay in the parent)."""
    return (
        req.rid, req.prompt, req.max_new_tokens, req.tenant,
        req.model, getattr(req, "deadline", 0.0),
    )


def _rebuild_request(payload: tuple) -> Any:
    """Rehydrate a worker-side ``Request`` from its shipped payload."""
    from repro_torch.serving.engine import Request  # lazy: avoid import cycle

    rid, prompt, max_new, tenant, model, deadline = payload
    return Request(
        rid=rid, prompt=prompt, max_new_tokens=max_new,
        tenant=tenant, model=model, deadline=deadline,
    )


def _result_payload(req: Any) -> tuple:
    """The finished-request slice shipped back to the parent."""
    return (
        req.rid, list(req.generated), bool(req.done),
        bool(getattr(req, "truncated", False)), getattr(req, "error", None),
    )


def _drain_spans(tracer: Any, offset: float) -> list:
    """Worker-side trace events as raw tuples, shifted onto the parent's
    clock by the setup handshake's ``offset``."""
    out = []
    for ev in tracer.drain():
        out.append((
            ev.ts + offset, ev.ph, ev.cat, ev.name, ev.dur,
            ev.rid, ev.lane, ev.args, ev.tid, ev.thread,
        ))
    return out


class _Beater:
    """A worker's heartbeats from a side thread while its main thread is
    busy with a command that may run long and is not a step: unpickling a
    message and registering a lane.  Every send of the worker goes through
    :meth:`send`, one at a time on the pipe.  Its ``("beat",)`` messages
    carry no stats: the parent takes any message as a sign of life and
    reads stats only from ``hb`` messages and replies, so a beat never
    puts older stats over a step reply's."""

    def __init__(self, conn: Any, hb_interval: float) -> None:
        self.conn = conn
        self.hb_interval = hb_interval
        self._lock = threading.Lock()
        self._busy = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="repro-worker-beat",
                                        daemon=True)
        self._thread.start()

    def send(self, msg: tuple) -> None:
        with self._lock:
            self.conn.send(msg)

    @contextlib.contextmanager
    def busy(self):
        self._busy.set()
        try:
            yield
        finally:
            self._busy.clear()

    def _run(self) -> None:
        while not self._stop.wait(self.hb_interval):
            if self._busy.is_set():
                try:
                    self.send(("beat",))
                except (OSError, ValueError):
                    return              # the pipe is closed: the worker is exiting

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=max(1.0, 4 * self.hb_interval))


def _worker_main(
    conn: Any,
    worker_cls: type,
    index: int,
    device_index: int,
    hb_interval: float,
    trace: bool,
    clock_origin: float,
    setup_kwargs: dict,
    threads: int,
    parent_end: Any = None,
) -> None:
    """Child-process entry: setup handshake, then the command loop.

    The loop waits on the pipe with ``poll(hb_interval)`` so an idle
    worker heartbeats (shipping its stats) while a busy one serves
    commands back-to-back.  Every command gets exactly one reply (plus
    any interleaved heartbeats), which is what lets the parent's RPC
    loop stay a simple match-and-absorb.  ``threads``, when not 0, is
    the number of threads torch's CPU ops run on here."""
    if parent_end is not None:
        # fork-started children inherit the PARENT side of their own
        # pipe; holding it open means a SIGKILLed parent never produces
        # EOF here and the orphan serves forever.  Close it first thing.
        try:
            parent_end.close()
        except OSError:  # pragma: no cover - already closed
            pass
        # nor can a forked child use the OpenMP team torch's CPU ops ran
        # on in the parent: its first parallel region would wait forever
        # for threads fork did not copy.  One thread runs none.
        torch.set_num_threads(1)
    elif threads:
        torch.set_num_threads(threads)
    # clock-offset handshake: the parent stamped its perf_counter at
    # spawn; spans recorded here ship back shifted onto the parent clock
    offset = clock_origin - time.perf_counter()
    tracer = get_tracer()
    # a fork-started child inherits the parent's ring contents — without
    # this clear, every span the parent ever recorded ships back in the
    # first flush/bye, duplicated, offset-shifted, and pid-stamped as if
    # this worker recorded it
    tracer.clear()
    if trace:
        tracer.enable()
    worker = worker_cls()
    worker.index = index
    try:
        worker.setup(device_index, **dict(setup_kwargs))
    except BaseException as exc:  # noqa: BLE001 - typed setup-failure reply
        try:
            conn.send(("setup_failed", repr(exc)))
        finally:
            conn.close()
        return
    beat = _Beater(conn, hb_interval)
    try:
        beat.send(("ready", {"pid": os.getpid(), "device": device_index}))
        while True:
            if not conn.poll(hb_interval):
                beat.send(("hb", worker.stats()))
                continue
            with beat.busy():
                msg = conn.recv()
            cmd = msg[0]
            if cmd == "shutdown":
                beat.send(("bye", _drain_spans(tracer, offset), worker.stats()))
                return
            if cmd == "flush":
                beat.send(("spans", _drain_spans(tracer, offset)))
                tracer.clear()
                continue
            if cmd == "ping":
                beat.send(("hb", worker.stats()))
                continue
            try:
                with beat.busy() if cmd == "register" else contextlib.nullcontext():
                    reply = worker.process(cmd, tuple(msg[1:]))
            except SystemExit:
                raise
            except BaseException as exc:  # noqa: BLE001 - per-command reply
                lane = msg[1] if len(msg) > 1 else ""
                beat.send((f"{cmd}_failed", lane, repr(exc)))
                continue
            beat.send(reply)
    except (EOFError, BrokenPipeError, OSError):
        return                      # parent went away: exit quietly
    finally:
        beat.close()
        try:
            worker.cleanup()
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass


def device_topology(n_workers: int, device: str = "cuda") -> list[int]:
    """Worker → device assignment.

    For ``device="cuda"`` worker ``i`` serves CUDA device
    ``i % torch.cuda.device_count()``, so a plane wider than the host
    wraps rather than failing; with no CUDA device it raises
    :class:`WorkerSetupError` (there is no quiet fallback to the CPU).
    ``torch.cuda.device_count`` does not initialise CUDA, so the parent
    stays fork-safe.  For ``device="cpu"`` every worker gets index 0."""
    if device == "cpu":
        return [0] * max(0, n_workers)
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    n_dev = torch.cuda.device_count()
    if n_dev < 1:
        raise WorkerSetupError(
            "a CUDA worker plane was asked for, but no CUDA device is "
            "visible; pass device='cpu' to run the workers on the CPU"
        )
    return [i % n_dev for i in range(max(0, n_workers))]


def refuse_fork_after_cuda(start_method: str) -> None:
    """Raise :class:`WorkerSetupError` when ``start_method`` is ``fork``
    and this process has initialised CUDA: a forked child inherits a CUDA
    context it cannot use, and fails on its first CUDA call."""
    if start_method == "fork" and torch.cuda.is_initialized():
        raise WorkerSetupError(
            "cannot fork worker processes after CUDA is initialised in the "
            "parent; use start_method='spawn'"
        )


class _ProxyStats:
    """Token counters mirrored from worker step replies — the duck-typed
    slice of ``EngineStats`` the dispatcher's fairness charging reads."""

    __slots__ = ("steps", "tokens_out", "prefill_tokens")

    def __init__(self) -> None:
        self.steps = 0
        self.tokens_out = 0
        self.prefill_tokens = 0


class _WorkerHandle:
    """Parent-side state for one worker process: the pipe, the RPC lock
    serializing all traffic on it, lane assignments, liveness, and the
    typed error once the worker is condemned."""

    __slots__ = (
        "index", "device", "process", "conn", "lock", "lanes", "pid",
        "last_seen", "restarts", "dead", "abandoned", "error", "alive_ev",
        "stats", "spans", "restart_times", "backoff", "next_spawn_at",
        "spawn_s", "register_s",
    )

    def __init__(self, index: int, device: int) -> None:
        self.index = index
        self.device = device
        self.process: Any = None
        self.conn: Any = None
        self.lock = threading.Lock()        # serializes RPCs on conn
        self.lanes: dict[str, Any] = {}     # lane -> spec (re-register set)
        self.pid = -1
        self.last_seen = 0.0
        self.restarts = 0
        self.dead = True                    # not spawned yet
        self.abandoned = False              # no respawn will come
        self.error: Optional[WorkerError] = None
        self.alive_ev = threading.Event()   # set while serving
        self.stats: dict = {}
        self.spans: list[TraceEvent] = []
        # respawn pacing (monitor-thread state, time.monotonic() domain):
        # recent respawn stamps for the rolling budget window, the current
        # exponential backoff, and the earliest next spawn time
        self.restart_times: deque = deque()
        self.backoff = 0.0
        self.next_spawn_at = 0.0
        # the last spawn's timings: process start to ready handshake, and
        # re-registering the lanes it owned (engine builds and seals)
        self.spawn_s = 0.0
        self.register_s = 0.0


class WorkerPlane:
    """The parent's fleet of per-device worker processes.

    Spawns ``n_workers`` processes (``spawn`` by default, or ``fork``
    while CUDA is not initialised here) on ``device`` (``"cuda"``, the
    default, or ``"cpu"``), assigns lanes
    round-robin across them, runs a monitor thread for heartbeat-timeout
    and crash detection, respawns crashed workers (re-registering their
    lanes so queued work replays), and merges worker trace rings into the
    parent's Perfetto export with per-process tracks.

    Thread-safety: every public method is safe from any thread; all pipe
    traffic for one worker serializes on its handle lock, so step RPCs,
    registrations, and the monitor's heartbeat drain never interleave on
    the wire."""

    def __init__(
        self,
        n_workers: int,
        *,
        device: str = "cuda",
        start_method: Optional[str] = "spawn",
        worker_cls: type = EngineWorker,
        setup_kwargs: Optional[dict] = None,
        hb_interval: float = 0.2,
        hb_timeout: float = 10.0,
        step_timeout: float = 60.0,
        setup_timeout: float = 120.0,
        max_restarts: int = 3,
        restart_window: float = 60.0,
        backoff_base: float = 0.05,
        backoff_max: float = 5.0,
        backoff_jitter: float = 0.2,
        trace: Optional[bool] = None,
        tracer: Optional[Any] = None,
        faults: Optional[Any] = None,
    ) -> None:
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.device = device
        self.start_method = start_method
        self.worker_cls = worker_cls
        self.setup_kwargs = {"device": device, **(setup_kwargs or {})}
        self.hb_interval = hb_interval
        self.hb_timeout = hb_timeout
        self.step_timeout = step_timeout
        self.setup_timeout = setup_timeout
        # respawn budget is a ROLLING window, not a lifetime cap: up to
        # ``max_restarts`` respawns within any ``restart_window`` seconds;
        # a worker that exceeds it is abandoned (crash loop), while one
        # that crashes rarely is respawned forever.  Consecutive respawns
        # are paced by exponential backoff (doubling from ``backoff_base``
        # up to ``backoff_max``, with ±``backoff_jitter`` relative jitter
        # so a fleet-wide fault does not resynchronize every respawn);
        # the backoff resets once the window empties.  All pacing runs on
        # ``time.monotonic()``.
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_jitter = backoff_jitter
        self.faults = faults
        self.tracer = tracer if tracer is not None else get_tracer()
        self.trace = trace
        devices = device_topology(n_workers, device)
        self._handles = [
            _WorkerHandle(i, devices[i]) for i in range(n_workers)
        ]
        self._mu = threading.Lock()         # assignment + lifecycle state
        self._next = 0                      # round-robin assignment cursor
        self._started = False
        self._closed = False
        self._monitor: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WorkerPlane":
        """Spawn the fleet (idempotent) and the monitor thread.  A worker
        whose setup fails is left condemned with ``WorkerSetupError`` —
        the rest of the fleet still comes up and serves.  A ``fork`` start
        after CUDA is initialised here raises ``WorkerSetupError``."""
        with self._mu:
            if self._closed:
                raise RuntimeError("worker plane is shut down")
            if self._started:
                return self
            refuse_fork_after_cuda(self._method())
            self._started = True
        for handle in self._handles:
            self._spawn(handle)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="repro-worker-monitor",
            daemon=True,
        )
        self._monitor.start()
        return self

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the fleet: collect each worker's final trace ring over a
        ``shutdown`` RPC, join the processes, and force-kill stragglers —
        the plane never leaks a child process.  Idempotent."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
        self._stop_ev.set()
        if self._monitor is not None:
            self._monitor.join(timeout=max(1.0, self.hb_interval * 10))
        deadline = time.monotonic() + timeout
        for handle in self._handles:
            with handle.lock:
                if not handle.dead and handle.conn is not None:
                    try:
                        handle.conn.send(("shutdown",))
                        bye = self._recv_until(
                            handle, "bye",
                            min(2.0, max(0.1, deadline - time.monotonic())),
                        )
                        if bye is not None:
                            self._absorb_spans(handle, bye[1])
                            handle.stats = bye[2]
                    except (BrokenPipeError, OSError, EOFError):
                        pass
                handle.dead = True
                handle.alive_ev.clear()
                if handle.error is None:
                    handle.error = WorkerError(
                        "worker plane shut down",
                        worker=handle.index, device=handle.device,
                    )
        for handle in self._handles:
            proc = handle.process
            if proc is None:
                continue
            proc.join(max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
            if handle.conn is not None:
                try:
                    handle.conn.close()
                except OSError:
                    pass

    def leaked(self) -> list:
        """Worker processes still alive — must be empty after
        :meth:`shutdown` (the CI leaked-process check)."""
        return [
            h.process for h in self._handles
            if h.process is not None and h.process.is_alive()
        ]

    # -- lane assignment ---------------------------------------------------

    def assign(self, name: str, spec: Any) -> "_LaneProxy":
        """Assign lane ``name`` (serving ``spec``) to a worker —
        round-robin over the fleet — and return the parent-side engine
        proxy to register with the dispatcher.  If the plane is live the
        worker builds the engine now (a failure surfaces here, on the
        registering thread, as a typed :class:`WorkerError`)."""
        with self._mu:
            if self._closed:
                raise RuntimeError("worker plane is shut down")
            handle = self._handles[self._next % self.n_workers]
            self._next += 1
            handle.lanes[name] = spec
            live = self._started
        if live and not handle.dead:
            self._rpc(
                handle, ("register", name, spec), "registered",
                self.setup_timeout, lane=name,
            )
        elif live and handle.abandoned:
            raise (handle.error or WorkerSetupError(
                "worker is abandoned",
                worker=handle.index, device=handle.device,
            ))
        return _LaneProxy(self, handle, name, spec)

    def release(self, name: str) -> None:
        """Drop lane ``name`` from its worker (engine retired worker-side;
        best-effort if the worker is dead)."""
        for handle in self._handles:
            if name not in handle.lanes:
                continue
            with self._mu:
                handle.lanes.pop(name, None)
            if not handle.dead:
                try:
                    self._rpc(
                        handle, ("unregister", name), "unregistered",
                        self.step_timeout, lane=name,
                    )
                except WorkerError:
                    pass
            return

    # -- observability -----------------------------------------------------

    def flush_trace(self) -> None:
        """Pull every live worker's trace ring into the parent's merged
        span list (shutdown collects the final rings automatically)."""
        for handle in self._handles:
            if handle.dead:
                continue
            try:
                reply = self._rpc(
                    handle, ("flush",), "spans", self.step_timeout
                )
                self._absorb_spans(handle, reply[1])
            except WorkerError:
                continue

    def trace_events(self) -> list[TraceEvent]:
        """Every collected worker span as parent-clock ``TraceEvent``s
        tagged with the worker's OS pid — ready to merge into the
        parent's own drain for one multi-process Perfetto trace."""
        out: list[TraceEvent] = []
        for handle in self._handles:
            out.extend(handle.spans)
        out.sort(key=lambda e: e.ts)
        return out

    def snapshot(self) -> dict:
        """Per-worker plane state: liveness, device, lanes, last reported
        worker-side counters, heartbeat age, and restart count."""
        now = time.monotonic()
        workers = []
        for handle in self._handles:
            if handle.abandoned:
                status = "abandoned"
            elif handle.dead:
                status = "dead"
            else:
                status = "serving"
            workers.append({
                "worker": handle.index,
                "device": handle.device,
                "pid": handle.pid,
                "status": status,
                "lanes": sorted(handle.lanes),
                "restarts": handle.restarts,
                "restarts_in_window": len(handle.restart_times),
                "respawn_backoff_s": handle.backoff,
                "heartbeat_age_s": (
                    max(0.0, now - handle.last_seen)
                    if not handle.dead else None
                ),
                "error": repr(handle.error) if handle.error else None,
                "spawn_s": handle.spawn_s,
                "register_s": handle.register_s,
                "stats": dict(handle.stats),
            })
        return {
            "n_workers": self.n_workers,
            "start_method": self._method(),
            "serving": sum(1 for w in workers if w["status"] == "serving"),
            "workers": workers,
        }

    # -- spawning / liveness ----------------------------------------------

    def _method(self) -> str:
        return self.start_method or mp.get_start_method()

    def _spawn(self, handle: _WorkerHandle) -> None:
        """Start (or restart) one worker and run the setup handshake;
        on success, re-register the handle's lanes so queued work can
        replay.  Condemns the handle with a typed error on failure."""
        if self.faults is not None:
            # deterministic spawn fault (FaultInjector): condemn as a
            # TRANSIENT crash — the respawn/backoff path handles it like
            # a real process death, no child ever started
            try:
                self.faults.on_worker_spawn(handle.index)
            except Exception as exc:  # noqa: BLE001 - injected on purpose
                with handle.lock:
                    self._condemn_locked(handle, WorkerCrashed(
                        f"worker {handle.index} spawn fault: {exc}",
                        worker=handle.index, device=handle.device,
                    ))
                return
        try:
            refuse_fork_after_cuda(self._method())
        except WorkerSetupError as exc:
            # a respawn after the parent initialised CUDA: deterministic,
            # so the worker is abandoned like any setup failure
            with handle.lock:
                self._condemn_locked(handle, exc)
                handle.abandoned = True
            return
        ctx = mp.get_context(self.start_method)
        parent_conn, child_conn = ctx.Pipe()
        trace = self.tracer.enabled if self.trace is None else self.trace
        # a CPU plane's workers share the CPU: each runs torch on its part
        # of this process's threads, where a spawned child would take every
        # core and n_workers of them oversubscribe it
        threads = max(1, torch.get_num_threads() // self.n_workers) if self.device == "cpu" else 0
        proc = ctx.Process(
            target=_worker_main,
            args=(
                child_conn, self.worker_cls, handle.index, handle.device,
                self.hb_interval, trace, time.perf_counter(),
                self.setup_kwargs, threads,
                # fork children inherit every open fd, including this
                # pipe's parent end — hand it over so the child closes it
                # and a dead parent reads as EOF (spawn children inherit
                # nothing, and shipping the conn would recreate the leak)
                parent_conn if self._method() == "fork" else None,
            ),
            name=f"repro-worker-{handle.index}",
            daemon=True,
        )
        t_start = time.perf_counter()
        proc.start()
        child_conn.close()
        with handle.lock:
            handle.process = proc
            handle.conn = parent_conn
            handle.error = None
            reply = None
            try:
                if parent_conn.poll(self.setup_timeout):
                    reply = parent_conn.recv()
            except (EOFError, OSError):
                reply = None
            if reply is None or reply[0] != "ready":
                detail = reply[1] if reply else "no ready handshake"
                exc: WorkerError
                if reply is not None and reply[0] == "setup_failed":
                    exc = WorkerSetupError(
                        f"worker {handle.index} setup failed: {detail}",
                        worker=handle.index, device=handle.device,
                    )
                else:
                    exc = WorkerSetupError(
                        f"worker {handle.index} failed to come up: {detail}",
                        worker=handle.index, device=handle.device,
                    )
                handle.dead = True
                handle.abandoned = True     # setup errors are deterministic
                handle.error = exc
                handle.alive_ev.clear()
                proc.kill()
                return
            handle.pid = reply[1].get("pid", proc.pid)
            handle.spawn_s = time.perf_counter() - t_start
            t_reg = time.perf_counter()
            handle.last_seen = time.monotonic()
            handle.dead = False
            handle.abandoned = False
            for lane, spec in list(handle.lanes.items()):
                try:
                    handle.conn.send(("register", lane, spec))
                    rep = self._recv_until(
                        handle, "registered", self.setup_timeout, lane=lane
                    )
                    if rep is None:
                        raise WorkerTimeout(
                            f"worker {handle.index} register {lane!r} "
                            "timed out",
                            worker=handle.index, device=handle.device,
                        )
                except WorkerError as exc2:
                    self._condemn_locked(handle, exc2)
                    return
                except (BrokenPipeError, OSError, EOFError):
                    self._condemn_locked(handle, WorkerCrashed(
                        f"worker {handle.index} died during register",
                        worker=handle.index, device=handle.device,
                    ))
                    return
            handle.register_s = time.perf_counter() - t_reg
            handle.alive_ev.set()

    def _condemn_locked(self, handle: _WorkerHandle, exc: WorkerError) -> None:
        # caller holds handle.lock; first error wins (a timeout kill's
        # EOF must not overwrite the WorkerTimeout that caused it)
        handle.dead = True
        handle.alive_ev.clear()
        if handle.error is None:
            handle.error = exc
        if handle.process is not None and handle.process.is_alive():
            handle.process.kill()

    def _condemn(self, handle: _WorkerHandle, exc: WorkerError) -> None:
        # lock-free condemnation for the monitor: the flags are simple
        # attribute writes, and killing the process unblocks any RPC
        # currently holding the handle lock (its recv sees EOF)
        handle.dead = True
        handle.alive_ev.clear()
        if handle.error is None:
            handle.error = exc
        if handle.process is not None and handle.process.is_alive():
            handle.process.kill()

    def _monitor_loop(self) -> None:
        """Liveness sweep: detect silent deaths and heartbeat timeouts,
        drain idle workers' heartbeats off the pipe, respawn condemned
        workers (exponential backoff with jitter, bounded by the rolling
        ``max_restarts``-per-``restart_window`` budget; never after setup
        failure).  All timing in the ``time.monotonic()`` domain."""
        interval = max(0.01, self.hb_interval / 2)
        while not self._stop_ev.wait(interval):
            for handle in self._handles:
                if self._stop_ev.is_set():
                    return
                if handle.dead:
                    if not handle.abandoned:
                        self._maybe_respawn(handle)
                    continue
                proc = handle.process
                if proc is not None and not proc.is_alive():
                    self._condemn(handle, WorkerCrashed(
                        f"worker {handle.index} (pid {handle.pid}) died "
                        f"with exit code {proc.exitcode}",
                        worker=handle.index, device=handle.device,
                    ))
                    continue
                # drain heartbeats only when no RPC owns the pipe — a
                # blocking acquire here would stall the sweep behind a
                # long step; the RPC path refreshes last_seen itself
                if handle.lock.acquire(blocking=False):
                    try:
                        while handle.conn.poll(0):
                            msg = handle.conn.recv()
                            handle.last_seen = time.monotonic()
                            if msg[0] == "hb":
                                handle.stats = msg[1]
                            elif msg[0] == "spans":
                                self._absorb_spans(handle, msg[1])
                    except (EOFError, OSError):
                        pass
                    finally:
                        handle.lock.release()
                age = time.monotonic() - handle.last_seen
                if age > self.hb_timeout:
                    self._condemn(handle, WorkerTimeout(
                        f"worker {handle.index} heartbeat silent for "
                        f"{age:.1f}s (timeout {self.hb_timeout}s)",
                        worker=handle.index, device=handle.device,
                    ))

    def _maybe_respawn(self, handle: _WorkerHandle) -> None:
        """Respawn one dead (non-abandoned) worker if the rolling restart
        budget allows it and its backoff delay has elapsed; called from
        the monitor sweep.  The first respawn after a quiet period is
        immediate; consecutive respawns double their spacing (with
        relative jitter) until the budget trips and the worker is
        abandoned."""
        now = time.monotonic()
        while (
            handle.restart_times
            and now - handle.restart_times[0] > self.restart_window
        ):
            handle.restart_times.popleft()
        if not handle.restart_times:
            handle.backoff = 0.0      # quiet window: pacing starts over
        if len(handle.restart_times) >= self.max_restarts:
            handle.abandoned = True   # crash loop: budget exhausted
            return
        if now < handle.next_spawn_at:
            return
        handle.restarts += 1
        handle.restart_times.append(now)
        nxt = min(
            self.backoff_max,
            max(self.backoff_base, handle.backoff * 2.0),
        )
        handle.backoff = nxt
        jitter = 1.0 + self.backoff_jitter * (2.0 * random.random() - 1.0)
        handle.next_spawn_at = now + nxt * jitter
        # under the lock: an RPC that saw the condemned worker's pipe
        # close reads the error (a WorkerTimeout, say) there first
        with handle.lock:
            handle.error = None
        self._spawn(handle)

    # -- RPC ---------------------------------------------------------------

    def _absorb_spans(self, handle: _WorkerHandle, raw: list) -> None:
        pid = handle.pid if handle.pid > 0 else 1
        for t in raw:
            handle.spans.append(TraceEvent(*t, pid=pid))

    def _recv_until(
        self,
        handle: _WorkerHandle,
        want: str,
        timeout: float,
        lane: Optional[str] = None,
    ) -> Optional[tuple]:
        """Receive until the matching reply arrives (absorbing interleaved
        heartbeats, beats and spans); ``None`` on timeout.  Caller holds the handle
        lock.  Raises :class:`WorkerError` for a ``*_failed`` reply and
        lets pipe errors propagate to the caller."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not handle.conn.poll(remaining):
                return None
            msg = handle.conn.recv()
            handle.last_seen = time.monotonic()
            kind = msg[0]
            if kind == "hb":
                handle.stats = msg[1]
                continue
            if kind == "beat":
                continue
            if kind == "spans":
                self._absorb_spans(handle, msg[1])
                continue
            if kind == want and (lane is None or msg[1] == lane):
                return msg
            if kind.endswith("_failed"):
                raise WorkerError(
                    f"worker {handle.index} {kind}: {msg[-1]}"
                    + (f" (lane {msg[1]!r})" if len(msg) > 2 else ""),
                    worker=handle.index, device=handle.device,
                )
            # unmatched stale reply (e.g. a step_result abandoned by a
            # timed-out RPC): drop it — rids are re-shipped on replay

    def _rpc(
        self,
        handle: _WorkerHandle,
        msg: tuple,
        want: str,
        timeout: float,
        lane: Optional[str] = None,
    ) -> tuple:
        """One serialized request/reply exchange with a worker; condemns
        the worker and raises a typed :class:`WorkerError` on crash or
        timeout."""
        with handle.lock:
            if handle.dead:
                raise (handle.error or WorkerCrashed(
                    f"worker {handle.index} is dead",
                    worker=handle.index, device=handle.device,
                ))
            try:
                handle.conn.send(msg)
                reply = self._recv_until(handle, want, timeout, lane=lane)
            except WorkerError:
                raise
            except (BrokenPipeError, OSError, EOFError):
                exc = handle.error or WorkerCrashed(
                    f"worker {handle.index} (pid {handle.pid}) died "
                    f"mid-{msg[0]}",
                    worker=handle.index, device=handle.device,
                )
                self._condemn_locked(handle, exc)
                raise exc from None
            if reply is None:
                exc = WorkerTimeout(
                    f"worker {handle.index} {msg[0]} RPC exceeded "
                    f"{timeout}s",
                    worker=handle.index, device=handle.device,
                )
                self._condemn_locked(handle, exc)
                raise exc
            return reply


class _LaneProxy:
    """Parent-side stand-in engine for a lane served by a worker process.

    Duck-typed to the dispatcher's engine contract (``submit`` / ``step``
    / ``free_slots`` / ``idle`` / ``stats`` / ``retire``) so the whole
    grant path runs unchanged; ``step()`` ships queued payloads to the
    worker, blocks on the reply, and returns finished parent ``Request``
    objects.  **Never raises**: worker failures come back as finished
    requests with a typed :class:`WorkerError` in ``_failure_exc`` (the
    async layer fails their futures with it), so one device's death
    cannot poison the dispatcher or any other lane."""

    def __init__(
        self, plane: WorkerPlane, handle: _WorkerHandle, name: str, spec: Any
    ) -> None:
        self.plane = plane
        self.handle = handle
        self.name = name
        self.spec = spec
        self.capacity = max(1, int(getattr(spec, "max_slots", 4) or 4))
        self.stats = _ProxyStats()
        self._queue: deque = deque()        # accepted, not yet shipped
        self._inflight: dict[int, Any] = {}  # rid -> req, shipped to worker

    @property
    def idle(self) -> bool:
        """True when nothing is queued here or in flight on the worker."""
        return not self._queue and not self._inflight

    def free_slots(self) -> int:
        """Seats the worker engine can still take (parent-side mirror of
        the spec's ``max_slots``)."""
        return max(0, self.capacity - len(self._inflight) - len(self._queue))

    def submit(self, req: Any) -> None:
        """Accept one request for shipment on the next step quantum."""
        self._queue.append(req)

    def worker_index(self) -> int:
        """The worker process currently serving this lane."""
        return self.handle.index

    def step(self) -> list:
        """One granted quantum: ship queued payloads, run one worker-side
        engine step, return finished requests.  Worker failures return
        the affected requests finished-with-typed-error instead of
        raising (see the class docstring)."""
        handle = self.handle
        if handle.dead:
            return self._step_dead()
        batch = []
        while self._queue and len(self._inflight) + len(batch) < self.capacity:
            batch.append(self._queue.popleft())
        payloads = [_request_payload(r) for r in batch]
        for r in batch:
            self._inflight[r.rid] = r
        try:
            reply = self.plane._rpc(
                handle, ("step", self.name, payloads), "step_result",
                self.plane.step_timeout, lane=self.name,
            )
        except WorkerError as exc:
            return self._fail(self._inflight, exc)
        _, _, finished, tokens, prefill, stats = reply
        self.stats.steps += 1
        self.stats.tokens_out += tokens
        self.stats.prefill_tokens += prefill
        handle.stats = stats
        now = time.perf_counter()
        out = []
        for rid, generated, done, truncated, error in finished:
            req = self._inflight.pop(rid, None)
            if req is None:
                continue            # finished twice across a replay race
            req.generated = list(generated)
            req.done = done
            req.truncated = truncated
            req.error = error
            if not req.t_first:
                req.t_first = now
            req.t_done = now
            out.append(req)
        return out

    def _step_dead(self) -> list:
        """Quantum against a dead worker: fail in-flight work typed; fail
        queued work too once no respawn is coming (abandoned / setup
        failure), otherwise hold it for replay — parking one heartbeat so
        a ready-but-dead lane cannot spin the stepper pool hot."""
        handle = self.handle
        exc = handle.error or WorkerCrashed(
            f"worker {handle.index} is dead",
            worker=handle.index, device=handle.device,
        )
        out = self._fail(self._inflight, exc)
        if handle.abandoned:
            victims = {r.rid: r for r in self._queue}
            self._queue.clear()
            out.extend(self._fail(victims, exc))
        elif not out and self._queue:
            handle.alive_ev.wait(self.plane.hb_interval)
        return out

    def _fail(self, reqs: dict, exc: WorkerError) -> list:
        now = time.perf_counter()
        out = []
        for req in list(reqs.values()):
            req.error = str(exc)
            req._failure_exc = exc
            req.done = True
            if not req.t_first:
                req.t_first = now
            req.t_done = now
            out.append(req)
        reqs.clear()
        return out

    def retire(self) -> None:
        """Release the lane from its worker (dispatcher retire hook)."""
        self.plane.release(self.name)
