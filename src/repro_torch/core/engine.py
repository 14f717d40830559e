"""Execution engines: the run-time-scheduled baseline vs AoT replay.

``EagerInterpreter`` is our stand-in for the base framework's run loop
(paper §2, Fig. 1): for every task, at *every* execution, it

  1. pops the next ready operator (operator emission),
  2. checks input types/shapes,
  3. infers output types/shapes,
  4. dispatches the kernel (table lookup on (operator, dtype, shape-rank)),
  5. allocates output buffers through a caching-allocator model,
  6. prepares kernel arguments, and only then
  7. submits the task (calls the aten operator).

Steps 1–6 are the *scheduling overhead* the paper measures; step 7 is the
task itself.  ``TaskSchedule.replay`` skips 1–6 entirely.  On the card,
step 7 enqueues the kernel and returns, as PyTorch's eager mode does, so
``DispatchProfile.submit_s`` is launch time there, not kernel time.

The interpreter is intentionally honest: it executes the same aten operators
as the sealed schedule (tests assert allclose), so engine comparisons are
apples-to-apples, exactly like the paper's "scheduling-minimized PyTorch"
experiment (Fig. 2b).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import fx
from torch.utils import _pytree as pytree

from .trace import TracedGraph, out_vals, read, trace_to_taskgraph


@dataclasses.dataclass
class DispatchProfile:
    """Where the time went, per execution (fig. 2a analogue)."""

    total_s: float = 0.0
    schedule_s: float = 0.0    # steps 1-6
    submit_s: float = 0.0      # step 7 (enqueue on the card; the kernel on the CPU)
    num_tasks: int = 0

    @property
    def overhead_fraction(self) -> float:
        return self.schedule_s / self.total_s if self.total_s else 0.0


class _CachingAllocator:
    """Models the framework's cached GPU memory pool (free-list per size
    class, as in PyTorch's CUDACachingAllocator).  We do the bookkeeping the
    real allocator does — size-class rounding, free-list probe, split — and
    charge its (CPU) cost to scheduling, without owning real device memory.
    """

    def __init__(self) -> None:
        self.free_lists: dict[int, list[int]] = {}
        self.next_addr = 0
        self.live: dict[int, int] = {}  # addr -> size class

    @staticmethod
    def _size_class(nbytes: int) -> int:
        if nbytes <= 512:
            return 512
        # round to next power-of-two-ish 512 multiple (PyTorch: 512B granularity)
        return (nbytes + 511) // 512 * 512

    def alloc(self, nbytes: int) -> int:
        sc = self._size_class(nbytes)
        fl = self.free_lists.get(sc)
        if fl:
            addr = fl.pop()
        else:
            addr = self.next_addr
            self.next_addr += sc
        self.live[addr] = sc
        return addr

    def free(self, addr: int) -> None:
        sc = self.live.pop(addr)
        self.free_lists.setdefault(sc, []).append(addr)


class EagerInterpreter:
    """Op-by-op run-time scheduling over a traced task list."""

    def __init__(self, fn: Callable, *example_args: Any) -> None:
        self.traced: TracedGraph = trace_to_taskgraph(fn, *example_args)
        self._dispatch: dict[tuple, Any] = {}
        self._prepare_liveness()

    def _prepare_liveness(self) -> None:
        tasks = self.traced.node_of_task

        def source(n):
            # a getitem node reads its producer's value
            while n.op == "call_function" and n not in self._index:
                n = n.args[0]
            return n

        self._index = {n: i for i, n in enumerate(tasks)}
        self.last_use: dict[fx.Node, int] = {}
        for ei, node in enumerate(tasks):
            for inp in node.all_input_nodes:
                self.last_use[source(inp)] = ei
        for out in self.traced.output_nodes:
            if isinstance(out, fx.Node):
                self.last_use[source(out)] = len(tasks)

    def run(self, *args: Any, profile: DispatchProfile | None = None) -> Any:
        """One full execution with run-time scheduling per task."""
        traced = self.traced
        allocator = _CachingAllocator()
        addr_of: dict[fx.Node, list[int]] = {}

        t_start = time.perf_counter()
        sched_s = 0.0
        submit_s = 0.0
        env = traced.input_env(traced.flatten_args(args))

        for ei, node in enumerate(traced.node_of_task):
            s0 = time.perf_counter()
            # (2) input type/shape check
            for inp in node.all_input_nodes:
                want, got = inp.meta.get("val"), read(env, inp)
                if isinstance(want, torch.Tensor) and tuple(got.shape) != tuple(want.shape):
                    raise TypeError(
                        f"shape mismatch for {node.target}: "
                        f"{tuple(got.shape)} vs {tuple(want.shape)}"
                    )
            # (3) output shape inference (recompute, as run-time schedulers do)
            outs = [v for v in out_vals(node) if isinstance(v, torch.Tensor)]
            # (4) kernel dispatch: registry lookup
            _ = self._dispatch.setdefault(
                (str(node.target), str(outs[0].dtype) if outs else "",
                 outs[0].dim() if outs else 0),
                node.target,
            )
            # (5) output allocation through the caching allocator model
            addrs = [allocator.alloc(max(v.numel() * v.element_size(), 1)) for v in outs]
            # (6) argument preparation
            call_args, call_kwargs = fx.node.map_arg(
                (node.args, node.kwargs), lambda n: read(env, n))
            s1 = time.perf_counter()
            sched_s += s1 - s0

            # (7) submit: op-by-op execution of the kernel
            with torch.no_grad():
                env[node] = node.target(*call_args, **call_kwargs)
            s2 = time.perf_counter()
            submit_s += s2 - s1

            addr_of[node] = addrs
            # free dead buffers back to the pool (allocator traffic)
            s3 = time.perf_counter()
            for n in list(addr_of):
                if self.last_use.get(n, -1) <= ei:
                    for a in addr_of.pop(n):
                        allocator.free(a)
            sched_s += time.perf_counter() - s3

        out = traced.outputs(env)
        total = time.perf_counter() - t_start
        if profile is not None:
            profile.total_s += total
            profile.schedule_s += sched_s
            profile.submit_s += submit_s
            profile.num_tasks += len(traced.node_of_task)
        return traced.unflatten_out(out)

    __call__ = run


class JitPerOpEngine(EagerInterpreter):
    """TorchScript analogue (the TorchScript column of the paper's Fig. 7):
    the graph is known ahead, with no Python model code in the loop, and
    each operator and the places of its arguments are resolved once, at
    construction; but tasks are still *scheduled at run time*: every call
    allocates each output through the caching-allocator model and
    dispatches each operator in turn.  It sits between
    :class:`EagerInterpreter` and Nimble's sealed replay.  The JAX version
    compiles each primitive with ``jax.jit``; here the operator is the aten
    overload the trace recorded, already bound to its kernel by PyTorch's
    dispatcher, so resolving it once is the counterpart."""

    def __init__(self, fn: Callable, *example_args: Any) -> None:
        super().__init__(fn, *example_args)
        traced = self.traced
        slot: dict[fx.Node, int] = {n: i for i, n in enumerate(traced.placeholders)}
        self._n_inputs = len(slot)
        self._consts = []
        for n in traced.gm.graph.nodes:
            if n.op == "get_attr":
                slot[n] = len(slot)
                self._consts.append((slot[n], getattr(traced.gm, n.target)))
        for n in traced.node_of_task:
            slot[n] = len(slot)
        self._n_slots = len(slot)

        def where(n: fx.Node) -> tuple:
            # (slot, None), or (slot of the producer, item) for a getitem
            if n in slot:
                return slot[n], None
            return slot[n.args[0]], n.args[1]

        self._program = []
        for node in traced.node_of_task:
            leaves, spec = pytree.tree_flatten((node.args, node.kwargs))
            refs = [where(x) if isinstance(x, fx.Node) else None for x in leaves]
            nbytes = [max(v.numel() * v.element_size(), 1) for v in out_vals(node)
                      if isinstance(v, torch.Tensor)]
            self._program.append((node.target, leaves, refs, spec, slot[node], nbytes))
        self._outputs = [where(n) if isinstance(n, fx.Node) else None
                         for n in traced.output_nodes]
        self._output_consts = list(traced.output_nodes)

    def run(self, *args: Any, profile: DispatchProfile | None = None) -> Any:
        """One full execution: per task, allocate its outputs, gather its
        arguments from their resolved places, call its operator."""
        allocator = _CachingAllocator()
        t_start = time.perf_counter()
        env: list = [None] * self._n_slots
        env[: self._n_inputs] = self.traced.flatten_args(args)
        for i, value in self._consts:
            env[i] = value

        def get(ref):
            i, item = ref
            return env[i] if item is None else env[i][item]

        with torch.no_grad():
            for op, leaves, refs, spec, out, nbytes in self._program:
                addrs = [allocator.alloc(b) for b in nbytes]
                vals = [x if r is None else get(r) for x, r in zip(leaves, refs)]
                call_args, call_kwargs = pytree.tree_unflatten(vals, spec)
                env[out] = op(*call_args, **call_kwargs)
                for a in addrs:
                    allocator.free(a)
        flat = [c if r is None else get(r) for r, c in zip(self._outputs, self._output_consts)]
        if profile is not None:
            profile.total_s += time.perf_counter() - t_start
            profile.num_tasks += len(self._program)
        return self.traced.unflatten_out(flat)

    __call__ = run


def _sync_if_cuda(tree: Any) -> None:
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in pytree.tree_leaves(tree)):
        torch.cuda.synchronize()


def compare_engines(
    fn: Callable,
    *args: Any,
    iters: int = 20,
    warmup: int = 3,
    multi_stream: bool = True,
    pack_streams: bool = False,
) -> dict[str, float]:
    """Time eager run-time scheduling vs AoT replay on identical inputs.

    Returns microseconds per call for each engine (host clock, each run
    ending in a synchronisation on the card) plus the speedup — the repo's
    Fig. 2b / Fig. 7 measurement primitive.  Besides the JAX version's
    engines it times :class:`JitPerOpEngine` (``jit_us``), Fig. 7's
    TorchScript column.
    """
    from .aot import Nimble

    eager = EagerInterpreter(fn, *args)
    jit = JitPerOpEngine(fn, *args)
    nimble = Nimble(fn, *args, multi_stream=multi_stream, pack_streams=pack_streams)

    # correctness gate: identical numerics
    ref = eager.run(*args)
    _assert_trees_close(ref, jit.run(*args))
    _assert_trees_close(ref, nimble(*args))

    def per_call_us(run) -> float:
        for _ in range(warmup):
            run(*args)
        _sync_if_cuda(args)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(*args)
        _sync_if_cuda(args)
        return (time.perf_counter() - t0) / iters * 1e6

    eager_us = per_call_us(eager.run)
    jit_us = per_call_us(jit.run)
    aot_us = per_call_us(nimble)
    return {
        "eager_us": eager_us,
        "jit_us": jit_us,
        "aot_us": aot_us,
        "speedup": eager_us / aot_us if aot_us else float("inf"),
        "num_tasks": eager.traced.graph.num_tasks,
        "num_streams": nimble.stats.num_streams,
        "num_syncs": nimble.stats.num_syncs,
        "concurrency_degree": nimble.stats.degree_of_concurrency,
    }


def _assert_trees_close(a, b, rtol=2e-3, atol=2e-3):
    la = pytree.tree_leaves(a)
    lb = pytree.tree_leaves(b)
    assert len(la) == len(lb), (len(la), len(lb))
    for x, y in zip(la, lb):
        np.testing.assert_allclose(
            x.detach().double().cpu().numpy(),
            y.detach().double().cpu().numpy(),
            rtol=rtol,
            atol=atol,
        )
