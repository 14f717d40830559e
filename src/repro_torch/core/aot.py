"""The AoT scheduler: Nimble §4.1 on an NVIDIA card.

``AoTScheduler.schedule(fn, *example_args)`` performs the *pre-run* once:

1. **Graph rewrite** (paper §4.2): trace ``fn`` to a :class:`TaskGraph`, run
   the stream-assignment algorithm (Algorithm 1), and optionally apply the
   stream-packing rewrite, the single-launch alternative (core/rewriter.py).
2. **Memory reservation**: the static arena plan for every intermediate
   buffer (core/memory.py), reported as ``ScheduleStats.arena_bytes``.
3. **Sealing**: on CUDA tensors the schedule is captured as ONE
   ``torch.cuda.CUDAGraph``.  With ``multi_stream`` each Algorithm 1 stream
   is a real CUDA stream: the capture forks every stream off the capture
   stream, runs each task on its stream in graph order, records an event
   after ``u`` and waits on it before ``v`` for each edge ``(u, v)`` of the
   sync plan Λ, and joins every stream back before the capture ends.  Inside
   the capture the streams and events only become the graph's edges, so the
   graph's dependencies are the same-stream order plus Λ — Nimble's §4.2.
   Without ``multi_stream``, or with ``pack_streams``, the capture runs on
   one stream.  On CPU tensors the seal is a plain callable that runs the
   tasks in order.

At run time :class:`TaskSchedule.replay` copies the arguments into the
graph's static inputs and launches the graph — the ``cudaGraphLaunch`` of
the paper.

Arguments are flattened with ``torch.utils._pytree``.  A leaf that stands in
for an argument without data is a tensor on the ``meta`` device, the
counterpart of ``jax.ShapeDtypeStruct``: it can be traced and keyed, not
sealed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import capture as _capture
from .memory import MemoryPlan, buffers_from_traced, plan_memory
from .streams import StreamAssignment, assign_streams
from .trace import TracedGraph, trace_to_taskgraph


def _leaf_spec(leaf: Any) -> tuple[tuple[int, ...], str]:
    """(shape, dtype) of one flattened argument leaf.

    Works for tensors (meta ones included), numpy arrays and Python
    scalars alike — anything that can stand in for an example arg.
    """
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        arr = np.asarray(leaf)
        shape, dtype = arr.shape, arr.dtype
    name = str(dtype) if isinstance(dtype, torch.dtype) else str(np.dtype(dtype))
    return tuple(int(d) for d in shape), name


@dataclasses.dataclass(frozen=True)
class ScheduleKey:
    """Canonical hashable identity of one sealed schedule.

    A sealed step is reusable exactly when (a) it came from the same
    function, (b) the flattened argument shapes/dtypes/pytree-structure
    match (a captured graph is shape-specialized), and (c) the options that
    shaped it match.  This is the single keying scheme shared by
    :meth:`Nimble.prepare` and ``repro_torch.dispatch.ScheduleCache``.
    """

    fn_id: str
    tree: str                                      # pytree structure of args
    leaves: tuple[tuple[tuple[int, ...], str], ...]  # (shape, dtype) per leaf
    options: tuple[tuple[str, Any], ...]           # sorted options

    @classmethod
    def from_call(
        cls,
        fn: Callable,
        example_args: Sequence[Any],
        options: Sequence[tuple[str, Any]] = (),
        *,
        fn_id: Optional[str] = None,
    ) -> "ScheduleKey":
        if fn_id is None:
            mod = getattr(fn, "__module__", "")
            qual = getattr(fn, "__qualname__", repr(fn))
            # id() disambiguates closures sharing a qualname; holders (the
            # cache pins the fn object per entry) keep it from being reused.
            fn_id = f"{mod}.{qual}#{id(fn):x}"
        leaves, treedef = pytree.tree_flatten(tuple(example_args))
        return cls(
            fn_id=fn_id,
            tree=str(treedef),
            leaves=tuple(_leaf_spec(l) for l in leaves),
            options=tuple(sorted((str(k), v) for k, v in options)),
        )


@dataclasses.dataclass
class ScheduleStats:
    num_tasks: int
    num_streams: int
    num_syncs: int
    degree_of_concurrency: int
    arena_bytes: int
    arena_reuse_factor: float
    prerun_seconds: float
    compile_seconds: float           # warm-up + CUDA-graph capture
    # what the schedule holds on the card: the change of
    # torch.cuda.memory_allocated across schedule() (the graph pool, which
    # keeps every intermediate, the baked weight stacks and one cuBLAS
    # workspace per stream; allocations by other threads meanwhile count
    # too).  0 on the CPU
    device_bytes: int = 0


@dataclasses.dataclass
class TaskSchedule:
    """The packed result of AoT scheduling (paper Fig. 5 "task schedule")."""

    traced: TracedGraph
    streams: StreamAssignment
    memory: MemoryPlan
    executable: Any                  # flat args -> flat outputs (a CUDA graph on the card)
    stats: ScheduleStats
    example_args: tuple = ()
    pack_report: Any = None          # PackReport when pack_streams

    def replay(self, *args: Any) -> Any:
        """Run-time execution: raw submission of the recorded tasks.

        On the card: each flattened argument whose storage differs from the
        graph's static input (the example tensor of that leaf) is copied
        into it, and the captured graph is launched.  No allocation and no
        synchronisation.  The outputs are the graph's static output tensors:
        the next replay overwrites them, so copy what must outlive it.
        Calling with other tensors than the example ones therefore also
        writes into the example tensors; weights a packed schedule baked
        are then re-stacked from them before the launch.
        """
        return self.traced.unflatten_out(self.executable(self.traced.flatten_args(args)))

    __call__ = replay


def _device_of(flat: list) -> torch.device:
    """The one device every flattened argument lives on: CUDA tensors give a
    CUDA-graph seal, CPU tensors a plain callable; anything else raises."""
    devices = set()
    for leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"a sealed schedule takes tensors only; got {type(leaf).__name__}")
        devices.add(leaf.device)
    if len(devices) != 1:
        raise ValueError(f"example tensors must share one device; got {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cannot seal for {dev}: pass real CUDA or CPU tensors")
    return dev


def _run_in_order(traced: TracedGraph, flat_args: list) -> tuple[list, dict]:
    """Every task on the current stream, in graph order."""
    env = traced.input_env(flat_args)
    for node in traced.node_of_task:
        traced.run_task(node, env)
    return traced.outputs(env), env


class _StreamPlan:
    """Algorithm 1 on CUDA streams: one stream per chain and one event per
    edge of Λ, made once, at schedule time."""

    def __init__(self, traced: TracedGraph, sa: StreamAssignment, device: torch.device):
        self.traced = traced
        self.device = device
        self.stream_of = sa.stream_of
        self.streams = [torch.cuda.Stream(device) for _ in range(sa.num_streams)]
        self.records: dict[int, list[torch.cuda.Event]] = {}
        self.waits: dict[int, list[torch.cuda.Event]] = {}
        for u, v in sa.sync_edges:
            ev = torch.cuda.Event()
            self.records.setdefault(u, []).append(ev)
            self.waits.setdefault(v, []).append(ev)

    def run(self, flat_args: list) -> tuple[list, dict]:
        traced = self.traced
        origin = torch.cuda.current_stream(self.device)
        for s in self.streams:                       # fork
            s.wait_stream(origin)
        env = traced.input_env(flat_args)
        for tid, node in enumerate(traced.node_of_task):
            s = self.streams[self.stream_of[tid]]
            with torch.cuda.stream(s):
                for ev in self.waits.get(tid, ()):
                    s.wait_event(ev)
                traced.run_task(node, env)
                for ev in self.records.get(tid, ()):
                    ev.record(s)
        for s in self.streams:                       # join
            origin.wait_stream(s)
        return traced.outputs(env), env


class _CapturedGraph:
    """``run`` captured once as a CUDA graph over static inputs.

    ``run(flat_args) -> (flat_outputs, env)`` is warmed up once on a side
    stream (cuBLAS handles and workspaces, the kernels' libraries), then
    captured.  ``env`` holds every intermediate of the capture and is kept
    for the life of the graph: a tensor made on one stream and read on
    another is then never freed and reused inside the graph's pool while its
    reader may still run, so no ``record_stream`` is needed.  ``run`` is
    kept too, with what it holds: the streams and events of a multi-stream
    plan, the weights a packed plan stacked at schedule time (which the
    graph reads, and which would otherwise go back to the allocator).
    ``refresh`` runs before each launch, after the arguments are copied in:
    a packed plan's ``refresh_baked``.  The capture holds the process's
    capture lock exclusively (:mod:`repro_torch.core.capture`), so it never
    overlaps a serving replay.  A launch takes no lock: it is the per-call
    path whose host time Nimble measures, and the dispatcher never drives
    it; a capture elsewhere runs in ``thread_local`` mode on its own
    stream, which a launch from this thread does not disturb.
    """

    def __init__(self, run: Callable, static_in: list, device: torch.device,
                 refresh: Callable[[], None] = lambda: None):
        self._run = run
        self._refresh = refresh
        self.static_in = static_in
        # exclusive against every replay of the process, with the plan's
        # device current (core/capture.py)
        with _capture.CAPTURE_LOCK.capturing(), torch.cuda.device(device):
            self._capture(run, static_in, device)

    def _capture(self, run: Callable, static_in: list, device: torch.device) -> None:
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(side):
            warm = run(static_in)
        current.wait_stream(side)
        torch.cuda.synchronize(device)      # the warm-up's tensors may go now
        del warm
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), _capture.capture_graph(self.graph):
            self.static_out, self._keep = run(static_in)

    def __call__(self, flat_args: list) -> list:
        for buf, a in zip(self.static_in, flat_args):
            if a.data_ptr() != buf.data_ptr():
                if a.shape != buf.shape:
                    raise TypeError(f"argument shape {tuple(a.shape)} != sealed {tuple(buf.shape)}")
                buf.copy_(a)
        self._refresh()
        self.graph.replay()
        return self.static_out


class _Eager:
    """The CPU seal: ``run`` called as it is, without autograd."""

    def __init__(self, run: Callable):
        self.run = run

    def __call__(self, flat_args: list) -> list:
        with torch.no_grad():
            return self.run(flat_args)[0]


class AoTScheduler:
    """Performs the pre-run and produces a :class:`TaskSchedule`."""

    def __init__(
        self,
        *,
        multi_stream: bool = True,
        pack_streams: bool = False,
        bake_weights: bool = True,
    ) -> None:
        self.multi_stream = multi_stream
        self.pack_streams = pack_streams
        # AoT argument preparation: pre-stack lane inputs that are function
        # inputs (weights) at schedule time, re-stacked only when written;
        # off, every packed replay stacks them
        self.bake_weights = bake_weights

    def options_key(self) -> tuple[tuple[str, Any], ...]:
        """The option pairs that distinguish one sealed schedule from
        another — part of every :class:`ScheduleKey` built for this
        scheduler."""
        return (
            ("bake_weights", self.bake_weights),
            ("multi_stream", self.multi_stream),
            ("pack_streams", self.pack_streams),
        )

    def schedule_key(self, fn: Callable, *example_args: Any) -> ScheduleKey:
        return ScheduleKey.from_call(fn, example_args, self.options_key())

    def schedule(self, fn: Callable, *example_args: Any) -> TaskSchedule:
        t0 = time.perf_counter()

        # --- pre-run: trace ----------------------------------------------
        flat = pytree.tree_leaves(example_args)
        device = _device_of(flat)
        on_card = device.type == "cuda"
        bytes_before = torch.cuda.memory_allocated(device) if on_card else 0
        traced = trace_to_taskgraph(fn, *example_args)

        # --- stream assignment (Algorithm 1) ----------------------------
        if self.multi_stream:
            sa = assign_streams(traced.graph)
        else:
            sa = StreamAssignment(
                stream_of=tuple(0 for _ in range(traced.graph.num_tasks)),
                num_streams=min(1, traced.graph.num_tasks),
                sync_edges=(),
                meg_edges=tuple(traced.graph.edges()),
                matching_size=0,
            )

        # --- how the seal runs the tasks ---------------------------------
        report, refresh = None, (lambda: None)
        if self.pack_streams and self.multi_stream:
            from .rewriter import pack_streams_fn

            packed = pack_streams_fn(
                fn, traced, sa,
                example_args=example_args if self.bake_weights else (),
            )
            run, report, refresh = packed.run_flat, packed.report, packed.refresh_baked
        elif self.multi_stream and on_card:
            run = _StreamPlan(traced, sa, device).run
        else:
            def run(flat_args):
                return _run_in_order(traced, flat_args)

        # --- memory reservation ------------------------------------------
        mem = plan_memory(buffers_from_traced(traced))
        t1 = time.perf_counter()

        # --- seal (CUDA-graph capture on the card) -----------------------
        executable = _CapturedGraph(run, flat, device, refresh) if on_card else _Eager(run)
        t2 = time.perf_counter()
        device_bytes = torch.cuda.memory_allocated(device) - bytes_before if on_card else 0

        stats = ScheduleStats(
            num_tasks=traced.graph.num_tasks,
            num_streams=sa.num_streams,
            num_syncs=sa.num_syncs,
            degree_of_concurrency=traced.graph.max_logical_concurrency(),
            arena_bytes=mem.arena_size,
            arena_reuse_factor=mem.reuse_factor,
            prerun_seconds=t1 - t0,
            compile_seconds=t2 - t1,
            device_bytes=device_bytes,
        )
        return TaskSchedule(
            traced=traced,
            streams=sa,
            memory=mem,
            executable=executable,
            stats=stats,
            example_args=example_args,
            pack_report=report,
        )


class Nimble:
    """User-facing wrapper, mirroring the paper's ``Nimble(model)`` API.

    >>> engine = Nimble(model_fn, x)        # AoT scheduling happens here
    >>> y = engine(x)                       # pure replay

    The schedule is sealed for the device of the example tensors.  Passing
    ``cache=`` (a ``repro_torch.dispatch.ScheduleCache``) makes ``prepare``
    share sealed schedules across wrappers: two Nimbles over the same fn and
    shapes pay for one pre-run.  Re-preparing with the same shapes is a no-op
    either way (the :class:`ScheduleKey` is compared).
    """

    def __init__(
        self,
        fn: Callable,
        *example_args: Any,
        multi_stream: bool = True,
        pack_streams: bool = False,
        bake_weights: bool = True,
        cache: Any = None,
    ) -> None:
        self._fn = fn
        self._sched = AoTScheduler(
            multi_stream=multi_stream,
            pack_streams=pack_streams,
            bake_weights=bake_weights,
        )
        self._cache = cache
        self._schedule: TaskSchedule | None = None
        self._key: ScheduleKey | None = None
        if example_args:
            self.prepare(*example_args)

    def prepare(self, *example_args: Any) -> "Nimble":
        key = self._sched.schedule_key(self._fn, *example_args)
        if self._schedule is not None and key == self._key:
            return self                       # already sealed for these shapes
        if self._cache is not None:
            self._schedule = self._cache.get_or_schedule(
                self._fn, *example_args, scheduler=self._sched, key=key
            )
        else:
            self._schedule = self._sched.schedule(self._fn, *example_args)
        self._key = key
        return self

    @property
    def key(self) -> ScheduleKey:
        if self._key is None:
            raise RuntimeError("call prepare(*example_args) first")
        return self._key

    @property
    def schedule(self) -> TaskSchedule:
        if self._schedule is None:
            raise RuntimeError("call prepare(*example_args) first")
        return self._schedule

    @property
    def stats(self) -> ScheduleStats:
        return self.schedule.stats

    def __call__(self, *args: Any) -> Any:
        if self._schedule is None:
            self.prepare(*args)
        return self._schedule.replay(*args)
